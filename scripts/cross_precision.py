#!/usr/bin/env python3
"""How close the cross-attention kernel comes to its plain version, and what
that does to the parity phase's ledger headline: two measurements on the
card.

    python3 scripts/cross_precision.py [--fp32-kernel <file>] [--seeds 8]

1. Accuracy.  At the main path's three shapes (CLS key scaled as
   ``chip_smoke.py`` scales it), the kernel's ``out`` and CAS against a
   float64 version, beside the plain version's: rms error and mean error
   toward zero, relative to the mean |out|, the largest CAS error, and the
   share of outputs equal to the plain version's bit for bit.  Variants
   are built as ``scripts/cross_ablation.py`` builds them: the kernel,
   ``no_half_ulp`` and ``running_sums``; with ``--fp32-kernel <file>``
   also the fp32 kernel that the tensor-core one replaced.
2. Headline steps.  ``chip_smoke.py``'s first parity pair (the reference route
   against a fused one, two full-width steps from the same latents, random
   weights from seed 0) with only the cross-attention op fused: the kernel and
   its variants (the fp32 kernel with ``--fp32-kernel``), the plain version,
   and the plain version with relative noise of 3e-8, 1e-7 and 3e-7 on its
   output, over ``--seeds`` seeds from 11.  Prints each pair's relative
   difference of ``total_ema_reduction`` (the smoke's limit is 1e-6) and the
   summed |difference| of the PSSA nnz counters.

Needs one CUDA card and nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import pathlib
import sys
import tempfile

import kernel_ablation as ka
import cross_ablation as ca

VARIANTS = {name: ca.VARIANTS[name]
            for name in ("kernel", "no_half_ulp", "running_sums")}
NOISE = (3e-8, 1e-7, 3e-7)


def accuracy(torch, libs, stream):
    g = torch.Generator(device="cuda").manual_seed(5)
    for label, (bh, tq, tk, d) in ca.SHAPES.items():
        q = torch.randn((bh, tq, d), generator=g, device="cuda")
        k, v = (torch.randn((bh, tk, d), generator=g, device="cuda")
                for _ in range(2))
        k[:, 0] *= ca.CLS_KEY_SCALE
        p64 = torch.softmax(torch.einsum("btd,bsd->bts", q.double(),
                                         k.double()) / math.sqrt(d), -1)
        out64 = torch.einsum("bts,bsd->btd", p64, v.double())
        scale = out64.abs().mean()
        pp = torch.softmax(torch.einsum("btd,bsd->bts", q, k)
                           / math.sqrt(float(d)), -1)
        out_p = torch.einsum("bts,bsd->btd", pp, v)

        def line(name, out, cas):
            err = out.double() - out64
            rms = err.pow(2).mean().sqrt() / scale
            print(f"  {label} {name:13s} rms {rms:.3e}"
                  f"  toward zero {(err * out64.sign()).mean() / scale:+.3e}"
                  f"  cas max {(cas.double() - p64[..., 0]).abs().max():.3e}"
                  f"  bit-equal to plain {(out == out_p).float().mean():.3f}",
                  flush=True)
        line("plain", out_p, pp[..., 0])
        for name, (lib, fp32) in libs.items():
            out = torch.empty_like(q)
            cas = torch.empty((bh, tq), device="cuda")
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    cas.data_ptr())
            fn = lib.launch_cross_attention_tips
            if fp32:
                fn.argtypes = ca.FP32_SIGNATURE
                err = fn(*ptrs, bh, tq, tk, d, 0, float(d) ** 0.5, stream)
            else:
                err = fn(*ptrs, bh, 1, tq, tk, d, 0, float(d) ** 0.5,
                         tq * d, 0, d, tk * d, 0, d, tk * d, 0, d,
                         tq * d, 0, d, 0, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed: CUDA error {err}")
            torch.cuda.synchronize()
            line(name, out, cas)


def headline_steps(torch, chip_smoke, libs, seeds):
    import repro_torch.core.attention as attention
    from repro_torch.configs import bk_sdm
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import energy_report
    from repro_torch.kernels import build
    from repro_torch.kernels.cross_attention_tips.ref import (
        cross_attention_tips_ref)
    from repro_torch.kernels.dispatch import KernelPolicy

    def plain(q, k, v, cls_index=0):
        b, h, tq, d = q.shape
        out, cas = cross_attention_tips_ref(
            *(x.reshape(b * h, -1, d) for x in (q, k, v)), cls_index)
        return out.reshape(b, h, tq, d), cas.reshape(b, h, tq)

    def noisy(eps):
        g = torch.Generator(device="cuda").manual_seed(123)

        def op(q, k, v, cls_index=0):
            out, cas = plain(q, k, v, cls_index)
            return out + eps * out.abs().mean() * torch.randn(
                out.shape, generator=g, device="cuda"), cas
        return op

    def fp32_op(lib):
        fn = lib.launch_cross_attention_tips
        fn.argtypes = ca.FP32_SIGNATURE
        stream = torch.cuda.current_stream().cuda_stream

        def op(q, k, v, cls_index=0):
            b, h, tq, d = q.shape
            q3, k3, v3 = (x.reshape(b * h, -1, d).contiguous()
                          for x in (q, k, v))
            out = torch.empty_like(q3)
            cas = torch.empty((b * h, tq), device="cuda")
            err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                     out.data_ptr(), cas.data_ptr(), b * h, tq, k3.shape[1],
                     d, cls_index, float(d) ** 0.5, stream)
            if err:
                raise RuntimeError(f"fp32: launch failed: CUDA error {err}")
            return out.reshape(b, h, tq, d), cas.reshape(b, h, tq)
        return op

    kernel_op, kernel_lib = attention.cross_attention_cas, build.library()
    # (name, op, library the kernel op launches from)
    routes = [("kernel", kernel_op, kernel_lib)]
    routes += [(name, fp32_op(lib) if fp32 else kernel_op,
                kernel_lib if fp32 else lib)
               for name, (lib, fp32) in libs.items() if name != "kernel"]
    routes += [("plain", plain, kernel_lib)]
    routes += [(f"noise {eps:g}", noisy(eps), kernel_lib) for eps in NOISE]
    cfg0 = bk_sdm.CONFIG               # weights as chip_smoke.py makes them
    eng = DiffusionEngine(bk_sdm.with_kernel_policy(cfg0, KernelPolicy(
        self_attention="fused", cross_attention="fused", ffn="dbsc")),
        generator=torch.Generator(device="cuda").manual_seed(0))
    base = dataclasses.replace(cfg0, ddim=dataclasses.replace(
        cfg0.ddim, num_inference_steps=2))
    params = {"text": eng.text_params, "unet": eng.unet_params,
              "vae": eng.vae_params}
    for seed in range(11, 11 + 10 * seeds, 10):
        toks, un = chip_smoke._tokens(torch, base, seed)
        latents = eng.init_latents(1, torch.Generator(device="cuda")
                                   .manual_seed(seed + 1))

        def run(pol):
            cfg = bk_sdm.with_kernel_policy(base, pol)
            out = DiffusionEngine(cfg, params=params).generate(
                toks, uncond_tokens=un, latents=latents.clone())
            return out.stats.cpu(), energy_report(cfg, out.stats).summary()
        ref, ref_rep = run(KernelPolicy.reference())
        parts = []
        for name, op, lib in routes:
            attention.cross_attention_cas, build._lib = op, lib
            try:
                stats, rep = run(KernelPolicy(cross_attention="fused"))
            finally:
                attention.cross_attention_cas = kernel_op
                build._lib = kernel_lib
            key = "total_ema_reduction"
            rel = abs(rep[key] - ref_rep[key]) / abs(ref_rep[key])
            nnz = sum(int((a.nnz - b.nnz).abs().sum())
                      for a, b in zip(ref.pssa, stats.pssa))
            parts.append(f"{name} {rel:.3e} (nnz {nnz})")
        print(f"  seed {seed}: " + "; ".join(parts), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fp32-kernel", type=pathlib.Path, default=None)
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("cross_precision: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ka.ROOT / "src"), str(ka.ROOT)]
    import chip_smoke
    print(ka.smi(), flush=True)
    chip_smoke.build_kernels()
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        names = ["launch_cross_attention_tips"]
        built = ka.build_variants("cross_precision", ca.SRC, VARIANTS, names,
                                  tmp)
        libs = {name: (lib, False) for name, lib in built.items()}
        if args.fp32_kernel is not None:
            (tmp / "fp32").mkdir()
            old = ka.build_variants(
                "cross_precision", args.fp32_kernel.resolve(),
                {"kernel": ("nothing", [])}, names, tmp / "fp32")
            libs["fp32"] = (old["kernel"], True)
        print("accuracy against float64 (relative to the mean |out|):")
        accuracy(torch, libs, stream)
        print("total_ema_reduction, reference route against cross-attention "
              "fused, relative (limit 1e-6):")
        headline_steps(torch, chip_smoke, libs, args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
