"""Config registry of the language-model architectures the port serves
(port of ``repro.configs``): the JAX package's ten, in its order.

``configs.bk_sdm`` and ``configs.dit_s`` (the diffusion workloads) are
imported by name, not here: they pull in the diffusion stack.
"""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ArchConfig, ShapeConfig, shape_applicable)

ARCH_NAMES = [
    "mamba2-130m",
    "qwen2-moe-a2.7b",
    "llama4-scout-17b-a16e",
    "yi-34b",
    "chatglm3-6b",
    "llama3-8b",
    "yi-9b",
    "internvl2-26b",
    "musicgen-large",
    "hymba-1.5b",
]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_NAMES:
        raise ValueError(f"unknown architecture {name!r}; the port serves "
                         f"{ARCH_NAMES}")
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    return mod.CONFIG
