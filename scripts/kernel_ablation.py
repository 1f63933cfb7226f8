"""The shared harness of the kernel ablations (``scripts/*_ablation.py``).

An ablation builds variants of one CUDA source of ``src/repro_torch/csrc``,
each with one part of the kernel removed by a text substitution (one
``nvcc`` process per variant, all started together, with ``-Xptxas -v``),
and times each on the card with the inputs rotated past the L2
(``chip_smoke.rotating_ms``), in the order listed, then reversed, and so
on for ``rounds`` runs; a variant's time is the median of its runs.  The
variants compute wrong results by design: only their times are read.  A
script gives its variants, the functions to bind and a ``setup`` that makes
the inputs and the launcher for each of its shapes, and calls ``main``.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def ptxas_summary(out: str, labels: dict) -> str:
    """Registers and spill bytes of each kernel from ``-Xptxas -v``; a
    kernel whose mangled name holds a key of ``labels`` is named by its
    value."""
    parts, name, spill = [], "?", "?"
    for line in out.splitlines():
        if "Function properties for" in line:
            mangled = line.split("Function properties for")[1].strip()
            name = next((v for k, v in labels.items() if k in mangled),
                        mangled)
        elif "spill stores" in line:
            spill = line.split(",")[1].split("bytes")[0].strip()
        elif "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            parts.append(f"{name} {regs} regs, {spill} B spilled")
    return "; ".join(sorted(parts))


def build_variants(tag: str, src: pathlib.Path, variants: dict, names: list,
                   tmp: pathlib.Path, common=(), labels=None) -> dict:
    """One shared library per variant, ``names`` bound by
    ``build.bind``.  ``common`` substitutions apply to every variant."""
    from repro_torch.kernels import build as kbuild
    base = src.read_text()
    procs = {}
    for name, (_, subs) in variants.items():
        text = base
        for old, new in [*common, *subs]:
            if old not in text:
                raise SystemExit(f"{tag}: {name}: the kernel no longer has "
                                 f"{old.strip()[:60]!r}")
            text = text.replace(old, new)
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kbuild._nvcc(), *kbuild.ARCH_FLAGS, *kbuild.NVCC_FLAGS, "-shared",
             "-Xptxas", "-v", str(cu), "-o", str(tmp / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{tag}: {name} does not build:\n{out}")
        print(f"{name}: removes {variants[name][0]}; "
              f"{ptxas_summary(out, labels or {})}", flush=True)
        libs[name] = kbuild.bind(ctypes.CDLL(str(tmp / f"{name}.so")), names)
    return libs


def main(*, tag: str, doc: str, src: pathlib.Path, variants: dict,
         names: list, setup, rounds: int, common=(), labels=None,
         argv=None) -> int:
    """Parse ``--reps`` (from ``argv``, default the command line), build
    the variants, time them and print each one's runs and the median's
    saving against the variant "kernel", shape by shape.
    ``setup(torch, chip_smoke)`` returns a list of (shape label, input
    sets, launcher), where ``launcher(lib)`` gives a function of one input
    set."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print(f"{tag}: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    print(smi(), flush=True)
    cases = setup(torch, chip_smoke)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tag, src, variants, names, pathlib.Path(tmp),
                              common, labels)
        times = {(case, name): [] for case, _, _ in cases for name in libs}
        for case, sets, launcher in cases:
            for r in range(rounds):
                for name in list(libs)[::-1] if r % 2 else list(libs):
                    times[case, name].append(chip_smoke.rotating_ms(
                        torch, launcher(libs[name]), sets, reps=args.reps))
    for case, _, _ in cases:
        med = {name: statistics.median(times[case, name]) for name in libs}
        base = med["kernel"]
        print(f"shape {case}, ms ({rounds} runs), the median's saving "
              f"against the kernel's")
        for name in libs:
            ts = times[case, name]
            print(f"  {name:16s} {' '.join(f'{v:.4f}' for v in ts)}  saves "
                  f"{base - med[name]:+.4f} ms "
                  f"({(base - med[name]) / base:+.1%})")
    return 0
