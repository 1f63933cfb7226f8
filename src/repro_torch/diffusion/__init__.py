"""The diffusion model, its pipeline, engine and stats (port of
``repro.diffusion``).

The package exports the JAX package's twelve names.  They load on first
use (PEP 562): ``core.policies`` imports ``diffusion.solvers``, which runs
this file first, and ``engine`` imports ``core.policies`` back, so an
eager import here would find ``policies`` half loaded.
"""
import importlib

_EXPORTS = {
    "UNetConfig": "unet", "init_unet_params": "unet",
    "unet_forward": "unet",
    "StableDiffusionPipeline": "pipeline", "PipelineConfig": "pipeline",
    "DiffusionEngine": "engine", "EngineOutput": "engine",
    "SlotState": "engine",
    "LedgerAccum": "stats", "SlotStats": "stats", "UNetStats": "stats",
    "attn_layer_order": "stats",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
