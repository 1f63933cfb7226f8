"""Launch-knob autotuner for the hand-written CUDA kernels (port of
``repro.kernels.autotune``).

Four kernels take a launch knob (``attn_block_q``, ``cross_block_q``,
``bitmap_block_rows``, ``reuse_block_patches``: the JAX package's names),
which each kernel otherwise sets by its own launch rule; the best launch
depends on the operand geometry.  This module times each kernel family's candidates on
the card with ``runtime.min_ms`` (CUDA events, the best of a few rounds,
the inputs rotated past the L2) and keeps the winners in a committed JSON
table keyed as the dispatch layer routes ops::

    {backend}/{op}/{field=value,...}     e.g.
    cuda/self_attention/b=2,h=8,t=4096,d=40,patch=64

``backend`` is the operands' device type.  At run time
``KernelPolicy.autotuned()`` (``dispatch.py``) looks the table up on the
host from the operand shapes and hands the winners to the kernels as
launch arguments.  A (backend, op, geometry) the table has not seen keeps
the launch rule; a malformed or version-stale table, or one whose knob
value a kernel does not take, raises ``AutotuneTableError`` when it is
loaded (a quietly ignored table would pass for a tuning regression).  A
kernel redesign must regenerate the table or bump ``AUTOTUNE_VERSION``.

Each kernel family exposes three hooks on its ``ops`` module:

* ``AUTOTUNE_KNOBS``                — the knobs it tunes
* ``autotune_candidates(geom)``     — every block dict the kernel takes at
                                      that geometry (so its launch rule's
                                      own choice is among them)
* ``autotune_probe(geom, blocks, *, device)`` — (fn, input sets)

Regenerate the committed table on the card with::

    python -m repro_torch.kernels.autotune            # DEFAULT_GEOMS
    python -m repro_torch.kernels.autotune --smoke    # tiny geometries
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
from typing import Any, Sequence

import torch

from repro_torch.kernels import runtime

AUTOTUNE_VERSION = 1
DEFAULT_TABLE_PATH = os.path.join(os.path.dirname(__file__),
                                  "autotune_table.json")

# op name (as the dispatch layer routes it) -> (ops module, geometry field
# names in the canonical key order)
_OPS: dict[str, tuple[str, tuple[str, ...]]] = {
    "self_attention": ("repro_torch.kernels.pssa_attention.ops",
                       ("b", "h", "t", "d", "patch")),
    "cross_attention": ("repro_torch.kernels.cross_attention_tips.ops",
                        ("b", "h", "tq", "d", "tk")),
    "bitmap": ("repro_torch.kernels.patch_bitmap.ops",
               ("rows", "tk", "patch")),
    "reuse": ("repro_torch.kernels.patch_reuse.ops",
              ("b", "t", "c", "patch")),
}
# op -> the knobs its kernel takes (the ops modules' AUTOTUNE_KNOBS, under
# the JAX package's KernelPolicy field names), each a launch dimension of
# the CUDA kernel:
#   attn_block_q         PSSA query rows a block (16, 32, 64)
#   cross_block_q        cross-attention query rows a block (16-128)
#   bitmap_block_rows    PSXU bitmap rows a block (2-32)
#   reuse_block_patches  patch-delta slices of 256 values a block (2-32)
OP_KNOBS: dict[str, tuple[str, ...]] = {
    "self_attention": ("attn_block_q",),
    "cross_attention": ("cross_block_q",),
    "bitmap": ("bitmap_block_rows",),
    "reuse": ("reuse_block_patches",),
}

# The geometries ``dispatch._blocks`` is asked for at full width, recorded
# from the dispatch layer on the card (``chip_smoke.py``'s autotune phase
# checks that its runs find every one): one BK-SDM generate at batch 1
# (guidance 7.5: 2 rows, 1 in the first block's shared prefix) on the slice
# route and under temporal reuse, one 4-slot BK-SDM ``slot_step`` and one
# DiT-S/2 generate; plus the bitmap entry point's slab, as in the JAX
# package.
DEFAULT_GEOMS: dict[str, tuple[tuple[int, ...], ...]] = {
    "self_attention": ((1, 8, 4096, 40, 64), (2, 8, 1024, 80, 32),
                       (2, 8, 256, 160, 16), (2, 8, 4096, 40, 64),
                       (4, 8, 4096, 40, 64), (8, 8, 1024, 80, 32),
                       (8, 8, 256, 160, 16), (8, 8, 4096, 40, 64),
                       (1, 6, 256, 64, 16), (2, 6, 256, 64, 16)),
    "cross_attention": ((2, 8, 4096, 40, 77), (2, 8, 1024, 80, 77),
                        (2, 8, 256, 160, 77), (8, 8, 4096, 40, 77),
                        (8, 8, 1024, 80, 77), (8, 8, 256, 160, 77),
                        (2, 6, 256, 64, 77)),
    "bitmap": ((4096, 4096, 64),),
    "reuse": ((1, 4096, 320, 64), (2, 1024, 640, 32), (2, 256, 1280, 16),
              (2, 4096, 320, 64)),
}

# tiny geometries for the card tests' sweep (seconds, not minutes)
SMOKE_GEOMS: dict[str, tuple[tuple[int, ...], ...]] = {
    "self_attention": ((1, 2, 256, 32, 16),),
    "cross_attention": ((1, 2, 256, 32, 77),),
    "bitmap": ((256, 256, 16),),
    "reuse": ((1, 256, 64, 16),),
}


class AutotuneTableError(ValueError):
    """The autotune table is malformed or stale — regenerate it."""


def _op_module(op: str):
    if op not in _OPS:
        raise KeyError(f"unknown autotune op {op!r}; known: {sorted(_OPS)}")
    return importlib.import_module(_OPS[op][0])


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------
def make_key(backend: str, op: str, geom: Sequence[int]) -> str:
    """(backend, op, geometry) -> the canonical table key string."""
    fields = _OPS[op][1]
    if len(geom) != len(fields):
        raise ValueError(f"{op} geometry needs {fields}, got {tuple(geom)}")
    dims = ",".join(f"{f}={int(v)}" for f, v in zip(fields, geom))
    return f"{backend}/{op}/{dims}"


def parse_key(key: str) -> tuple[str, str, tuple[int, ...]]:
    """Canonical key string -> (backend, op, geometry); strict inverse."""
    try:
        backend, op, dims = key.split("/")
    except ValueError:
        raise AutotuneTableError(
            f"bad autotune key {key!r}: want 'backend/op/f=v,...'") from None
    if op not in _OPS:
        raise AutotuneTableError(f"bad autotune key {key!r}: "
                                 f"unknown op {op!r}")
    fields = _OPS[op][1]
    got: dict[str, int] = {}
    for part in dims.split(",") if dims else []:
        name, _, val = part.partition("=")
        if not val or not val.lstrip("-").isdigit():
            raise AutotuneTableError(
                f"bad autotune key {key!r}: field {part!r} is not 'name=int'")
        got[name] = int(val)
    if tuple(got) != fields:
        raise AutotuneTableError(
            f"bad autotune key {key!r}: {op} geometry fields must be "
            f"{fields} in order, got {tuple(got)}")
    return backend, op, tuple(got[f] for f in fields)


# ---------------------------------------------------------------------------
# Table load / lookup
# ---------------------------------------------------------------------------
_TABLE_CACHE: dict[str, dict[str, Any]] = {}


def clear_cache() -> None:
    """Drop memoised tables (tests that point the table path elsewhere)."""
    _TABLE_CACHE.clear()


def validate_table(table: Any, *, source: str = "<table>") -> dict:
    """Structural validation, and every knob value one its kernel takes at
    the entry's geometry; returns the table or raises loudly."""
    if not isinstance(table, dict):
        raise AutotuneTableError(f"{source}: autotune table must be a JSON "
                                 f"object, got {type(table).__name__}")
    version = table.get("version")
    if version != AUTOTUNE_VERSION:
        raise AutotuneTableError(
            f"{source}: autotune table version {version!r} != expected "
            f"{AUTOTUNE_VERSION}; regenerate with "
            f"'python -m repro_torch.kernels.autotune'")
    entries = table.get("entries")
    if not isinstance(entries, dict):
        raise AutotuneTableError(f"{source}: 'entries' must be an object")
    for key, blocks in entries.items():
        _, op, geom = parse_key(key)              # raises on bad keys
        knobs = OP_KNOBS[op]
        if not isinstance(blocks, dict) or not blocks:
            raise AutotuneTableError(
                f"{source}: entry {key!r} must map knob names to ints")
        legal = _op_module(op).autotune_candidates(geom)
        for name, val in blocks.items():
            if name not in knobs:
                raise AutotuneTableError(
                    f"{source}: entry {key!r} tunes unknown knob {name!r}; "
                    f"{op} knobs are {knobs}")
            if not isinstance(val, int) or isinstance(val, bool) or val <= 0:
                raise AutotuneTableError(
                    f"{source}: entry {key!r} knob {name!r} must be a "
                    f"positive int, got {val!r}")
            takes = sorted({c[name] for c in legal})
            if val not in takes:
                raise AutotuneTableError(
                    f"{source}: entry {key!r} knob {name!r}={val} is not a "
                    f"launch the kernel takes there ({takes})")
    return table


def load_table(path: str | None = None) -> dict:
    """Load and validate the table at ``path`` (default: the committed
    table), memoised per path.

    A missing file is a valid empty table (a checkout before the first
    sweep); a PRESENT but malformed or stale file raises
    ``AutotuneTableError``.
    """
    path = path or DEFAULT_TABLE_PATH
    cached = _TABLE_CACHE.get(path)
    if cached is not None:
        return cached
    if not os.path.exists(path):
        table: dict[str, Any] = {"version": AUTOTUNE_VERSION, "entries": {}}
    else:
        try:
            with open(path) as f:
                table = json.load(f)
        except json.JSONDecodeError as e:
            raise AutotuneTableError(
                f"{path}: autotune table is not valid JSON ({e}); "
                f"regenerate with 'python -m repro_torch.kernels.autotune'"
            ) from None
        validate_table(table, source=path)
    _TABLE_CACHE[path] = table
    return table


def lookup(op: str, geom: Sequence[int], *, backend: str = "cuda",
           path: str | None = None) -> dict[str, int] | None:
    """Winning knobs for (backend, op, geometry), or None (launch rule)."""
    entries = load_table(path)["entries"]
    blocks = entries.get(make_key(backend, op, geom))
    return dict(blocks) if blocks is not None else None


# ---------------------------------------------------------------------------
# Sweep (on the card)
# ---------------------------------------------------------------------------
def _card(device=None) -> torch.device:
    """The card to tune on; raises off it (the plain versions on the CPU
    take no knob, so there is nothing to time)."""
    dev = runtime.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"autotune: tuning times the CUDA kernels; device "
                         f"{dev} runs their plain versions")
    return dev


def sweep_op(op: str, geom: Sequence[int], *, reps: int = 3, device=None,
             verbose: bool = True):
    """Time every candidate for one (op, geometry) on the card; return
    (best, trace)."""
    dev = _card(device)
    mod = _op_module(op)
    geom = tuple(int(v) for v in geom)
    results = []
    for blocks in mod.autotune_candidates(geom):
        fn, sets = mod.autotune_probe(geom, blocks, device=dev)
        ms = runtime.min_ms(fn, sets, reps=reps)
        results.append({"blocks": dict(blocks), "ms": ms})
        if verbose:
            print(f"  {op} {geom} {blocks} -> {ms:.4f} ms", file=sys.stderr)
        del fn, sets
    best = min(results, key=lambda r: r["ms"])
    return dict(best["blocks"]), results


def _generated_on(dev: torch.device) -> dict:
    """The backend, the card's name and power limit as ``nvidia-smi``
    gives them, and the torch and CUDA versions."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = ""
    return {"backend": dev.type, "device": smi or None,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def tune(geoms: dict[str, Sequence[Sequence[int]]] | None = None, *,
         reps: int = 3, device=None, verbose: bool = True) -> dict:
    """Sweep every (op, geometry) on the card and return a full, valid
    table dict (``sweep`` holds every candidate's ms)."""
    geoms = geoms or DEFAULT_GEOMS
    dev = _card(device)
    entries: dict[str, Any] = {}
    trace: dict[str, Any] = {}
    for op, op_geoms in geoms.items():
        for geom in op_geoms:
            key = make_key(dev.type, op, geom)
            if verbose:
                print(f"[autotune] {key}", file=sys.stderr)
            best, results = sweep_op(op, geom, reps=reps, device=dev,
                                     verbose=verbose)
            entries[key] = best
            trace[key] = results
    table = {
        "version": AUTOTUNE_VERSION,
        "generated_on": _generated_on(dev),
        "entries": entries,
        "sweep": trace,
    }
    return validate_table(table, source="<tune>")


def save_table(table: dict, path: str | None = None) -> str:
    path = path or DEFAULT_TABLE_PATH
    with open(path, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
        f.write("\n")
    _TABLE_CACHE.pop(path, None)
    return path


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_TABLE_PATH,
                    help="table path to write (default: committed table)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny geometries (a wiring check, seconds)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed rounds per candidate (the min is kept)")
    ap.add_argument("--ops", default=None,
                    help="comma-separated op subset (default: all)")
    args = ap.parse_args(argv)

    geoms = dict(SMOKE_GEOMS if args.smoke else DEFAULT_GEOMS)
    if args.ops:
        wanted = args.ops.split(",")
        unknown = [o for o in wanted if o not in geoms]
        if unknown:
            ap.error(f"unknown ops {unknown}; known: {sorted(geoms)}")
        geoms = {op: geoms[op] for op in wanted}

    table = tune(geoms, reps=args.reps)
    path = save_table(table, args.out)
    print(f"[autotune] wrote {len(table['entries'])} entries -> {path}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
