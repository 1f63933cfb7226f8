"""Config registry of the language-model architectures the port serves.

Only ``mamba2-130m`` so far; the JAX package's other architectures wait
for the dense, moe and hybrid families (ROADMAP.md, Queue 1 item 7).
``configs.bk_sdm`` (the diffusion workload) is imported by name, not here:
it pulls in the diffusion stack.
"""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ArchConfig, ShapeConfig)

ARCH_NAMES = ["mamba2-130m"]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_NAMES:
        raise ValueError(
            f"repro_torch serves {ARCH_NAMES}, not {name!r}; the other "
            f"architectures of the JAX package are still to be ported "
            f"(ROADMAP.md, Queue 1 item 7)")
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    return mod.CONFIG
