"""Quickstart: the paper's three mechanisms (port of ``examples/quickstart.py``).

  1. PSSA  — prune + patch-XOR + local-CSR compress a self-attention score
             matrix; print the byte ledger; the round trip is lossless.
  2. TIPS  — spot important tokens from the cross-attention CAS (the
             hand-written cross-attention kernel on the card); quantize an
             activation tensor INT12/INT6 by the mask.
  3. DBSC  — the bit-slice mixed-precision matmul (the hand-written
             kernel on the card, its plain version on the CPU) against the
             integer oracle.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import pssa, quant, tips
from repro_torch.core.attention import cross_attention_tips_fused
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels.bitslice_matmul.ops import bitslice_integers
from repro_torch.kernels.runtime import resolve_device


def make_inputs(device) -> dict:
    """The example's tensors, drawn from a seeded generator on ``device``."""
    g = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)
    return {"scores": torch.softmax(normal(8, 256, 256) * 3.0, dim=-1),
            "q": normal(1, 8, 64, 32), "kt": normal(1, 8, 16, 32),
            "x": torch.relu(normal(1, 64, 32)),
            "xm": torch.relu(normal(64, 128)), "w": normal(128, 64)}


def dbsc_oracle(xm, w, important) -> torch.Tensor:
    """The DBSC accumulators by exact int64 arithmetic on the CPU: the
    INT12/INT6 codes split into their 6-bit planes and merged back (an INT6
    row's low plane gated off), times the INT8 weights."""
    qx = quant.quantize_act(xm, quant.ACT_BITS_HIGH)
    qw = quant.quantize_weight(w)
    vals = quant.mixed_precision_quantize(xm, important, qx.scale).values
    hi, lo = quant.bitslice_split(vals)
    merged = quant.bitslice_merge(hi, lo * important.to(torch.int32)[:, None])
    return merged.cpu().to(torch.int64) @ qw.values.cpu().to(torch.int64)


def run(inp: dict) -> dict:
    """The three sections on ``inp`` (``make_inputs``' keys, one device)."""
    dev = inp["xm"].device
    # --- 1. PSSA ----------------------------------------------------------
    print("== PSSA: self-attention score compression ==")
    scores = inp["scores"]
    st = pssa.compress_stats(scores, patch=32)
    ema = float(pssa.ema_reduction(st))
    print(f"  dense SAS:      {float(st.bytes_baseline):>12.0f} B")
    print(f"  PSSA payload:   {float(st.bytes_pssa_total):>12.0f} B "
          f"({ema * 100:.1f} % EMA cut)")
    rec = pssa.compress_decompress(scores, patch=32)
    if not torch.equal(rec, pssa.prune(scores)):
        raise AssertionError("PSSA round trip is not lossless")
    print("  round-trip lossless: OK")

    # --- 2. TIPS -----------------------------------------------------------
    print("== TIPS: text-based important pixel spotting ==")
    out = cross_attention_tips_fused(inp["q"], inp["kt"], inp["kt"],
                                     PrecisionPolicy(threshold=0.06))
    r = out.tips_result
    low = float(r.low_precision_ratio)
    print(f"  low-precision token ratio: {low * 100:.1f} %")
    x = inp["x"]
    xq = tips.apply_precision_mask(x, r.important)
    qerr = float((xq - x).abs().max())
    print(f"  masked-quant max err: {qerr:.4f}")

    # --- 3. DBSC ------------------------------------------------------------
    where = "CUDA kernel" if dev.type == "cuda" else "plain version, CPU"
    print(f"== DBSC: bit-slice mixed-precision matmul ({where}) ==")
    xm, w = inp["xm"], inp["w"]
    imp = torch.arange(xm.shape[0], device=dev) % 2 == 0
    acc, scale = bitslice_integers(xm, w, important=imp)
    y_kernel = acc.to(torch.float32) * scale     # = ops.bitslice_matmul
    oracle = dbsc_oracle(xm, w, imp)
    y_ref = oracle.to(dev).to(torch.float32) * scale
    diff = float((y_kernel - y_ref).abs().max())
    print(f"  kernel vs oracle max diff: {diff:.2e}")
    dense = xm @ w
    rel = float(torch.linalg.norm(y_kernel - dense) / torch.linalg.norm(dense))
    print(f"  datapath vs float rel err: {rel:.4f}")
    print("done.")
    return {"bytes_baseline": float(st.bytes_baseline),
            "bytes_pssa_total": float(st.bytes_pssa_total),
            "ema_reduction": ema, "low_precision_ratio": low,
            "masked_quant_max_err": qerr, "kernel_vs_oracle": diff,
            "datapath_rel_err": rel, "acc": acc.cpu(), "oracle": oracle}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (the card by default; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    return run(make_inputs(resolve_device(args.device)))


if __name__ == "__main__":
    main()
