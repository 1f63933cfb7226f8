#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the SD processor on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure ends the run with exit 1 and
no result line):

1. environment — the card's name and power limit, torch and CUDA versions;
2. build       — nvcc builds ``src/repro_torch/csrc/*.cu`` for sm_90a;
3. kernels     — each hand-written kernel at every shape the main path
                 gives it (plus a ragged case) against its plain PyTorch
                 version on the card, with times, bounds and tolerances;
4. slice       — full-width BK-SDM-Tiny text-to-image, 25 DDIM steps at
                 guidance 7.5, through ``DiffusionEngine.generate`` on the
                 kernel route; launch counters must read 225/225/450;
5. parity      — two full-width steps from the same latents, route against
                 route: the reference policy against the fused attention
                 kernels, then reference attention + DBSC against the
                 slice's route (fused + DBSC) on three seeds; latents,
                 ledger headlines and per-layer PSSA counters must agree
                 within the limits below.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
INT8_OPS = 1979e12          # int8 tensor cores, dense

THRESHOLD = 1.0 / 8192.0
TIE_REL = 1e-5              # |p - tau| / tau at a flipped key: a tie
PSSA_MAX_ROW_DIFF = 2       # counts per row (the JAX package's own drift)
PSSA_MAX_ROW_FRAC = 1e-3    # share of rows that may differ at T=4096
OUT_ATOL = 1e-3             # attention outputs: fp32 order + tie flips
CAS_ATOL = 1e-5             # CAS: fp32 summation order only
CLS_KEY_SCALE = 2.5         # puts the head-averaged CAS across the 0.05 cut
LATENT_ATOL = 1e-3          # parity, float FFN: latents after two steps
LEDGER_RTOL = 1e-6          # parity: ledger headlines, relative
# With the DBSC FFN on both routes an ulp of difference upstream flips
# INT12 codes by one step, and every later layer sees that step.  Readings
# on the first seed were latents 1.18e-3 and counters at 1.23 of the
# per-layer counter bound (PSSA_MAX_ROW_DIFF counts on PSSA_MAX_ROW_FRAC
# of the layer's rows); these limits leave room above them and stay well
# below what a wrong tile or a miscounted row gives (latents O(0.1),
# counters far past the bound).
DBSC_LATENT_ATOL = 1e-2
DBSC_COUNTER_SCALE = 4.0    # times the per-layer counter bound
DBSC_SEEDS = (11, 21, 31)

REPLACES = {
    "pssa_attention":
        "src/repro/kernels/pssa_attention/kernel.py:156",
    "cross_attention_tips":
        "src/repro/kernels/cross_attention_tips/kernel.py:98",
    "bitslice_matmul":
        "src/repro/kernels/bitslice_matmul/kernel.py:87",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}


class PhaseError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)
            out = fn(*a, **kw)
            print(f"== phase {name} ok in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            return out
        return run
    return wrap


# ---------------------------------------------------------------------------
@phase("environment")
def environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    require(torch.cuda.is_available(), "CUDA is not available")
    return smi[0] if smi else "nvidia-smi gave no output"


@phase("build")
def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"built {path.name} from {len(build.sources())} sources in "
          f"{time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
def bound(bytes_moved: float, ops: float, rate: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_keep_bits(torch, q, k, bh, r, patch):
    """The kernel's own keep bits for query row ``r`` of head ``bh``, and
    its nnz for that row.

    The row runs alone, repeated over ceil(T/d) heads whose values are
    one-hot on d different keys each, so ``out`` holds the kernel's kept
    p of every key, 0 where it pruned.  A row's scores, max and sum do
    not depend on the other rows of its block, so its bits are the ones
    of the full launch.
    """
    from repro_torch.kernels.pssa_attention.kernel import (
        pssa_attention_kernel)
    t, d = k.shape[1], k.shape[2]
    nb = -(-t // d)
    keys = torch.arange(t, device=k.device)
    v = torch.zeros((nb, t, d), device=k.device)
    v[keys // d, keys, keys % d] = 1.0
    out, nnz, _ = pssa_attention_kernel(
        q[bh, r:r + 1].expand(nb, 1, d).contiguous(),
        k[bh].expand(nb, t, d).contiguous(), v, THRESHOLD, patch)
    return out.reshape(-1)[:t] > 0, int(nnz[0, 0])


def flipped_key_distance(torch, q, k, rows, nnz_k, nnz_p, patch):
    """Largest |p - tau| / tau, with p the plain softmax, over the keys
    whose keep bit the kernel flipped in the given (bh, query) rows.

    p is recomputed by the plain version's own operations, and the
    kernel's keep bits are read with ``kernel_keep_bits``; both are held
    to the row's nnz first.  Near 0 means the rows differ only on scores
    that sit on the threshold.
    """
    if rows.numel() == 0:
        return 0.0
    d = q.shape[-1]
    scores = torch.einsum("btd,bsd->bts", q, k) / math.sqrt(float(d))
    probs = torch.softmax(scores, dim=-1)
    del scores
    worst = 0.0
    for bh, r in rows.tolist():
        p = probs[bh, r]
        keep_p = p >= THRESHOLD
        keep_k, nnz = kernel_keep_bits(torch, q, k, bh, r, patch)
        require(int(keep_p.sum()) == int(nnz_p[bh, r])
                and int(keep_k.sum()) == nnz == int(nnz_k[bh, r]),
                f"row ({bh}, {r}): keep bits do not add up to the nnz")
        flipped = keep_k != keep_p
        if not bool(flipped.any()):    # same bits, different counts
            return math.inf
        dist = (p[flipped] - THRESHOLD).abs().max() / THRESHOLD
        worst = max(worst, dist.item())
    return worst


def check_pssa(torch, label, q, k, patch, kern, plain, exact: bool):
    """Kernel against plain.  ``exact``: the counters must be equal.
    Otherwise (T=4096) rows may differ by PSSA_MAX_ROW_DIFF counts on
    PSSA_MAX_ROW_FRAC of the rows, and only on keys within TIE_REL of the
    threshold."""
    out_k, nnz_k, xor_k = kern
    out_p, nnz_p, xor_p = plain
    err = (out_k - out_p).abs().max().item()
    dn = (nnz_k - nnz_p).abs()
    dx = (xor_k - xor_p).abs()
    diff = (dn > 0) | (dx > 0)
    nrows = int(diff.sum().item())
    maxd = int(max(dn.max().item(), dx.max().item()))
    frac = nrows / diff.numel()
    rows = diff.nonzero()[:128]
    tie = flipped_key_distance(torch, q, k, rows, nnz_k, nnz_p, patch)
    print(f"  {label}: out max|err| {err:.3e}, counter rows differing "
          f"{nrows}/{diff.numel()} ({frac:.2e}), largest difference {maxd}, "
          f"largest |p-tau|/tau at a flipped key {tie:.2e}")
    require(err <= OUT_ATOL, f"{label}: out error {err} > {OUT_ATOL}")
    if exact:
        require(nrows == 0, f"{label}: {nrows} counter rows differ; the "
                            f"counters must be exact at this size")
        return err
    require(maxd <= PSSA_MAX_ROW_DIFF,
            f"{label}: a counter row differs by {maxd} > "
            f"{PSSA_MAX_ROW_DIFF}")
    require(frac <= PSSA_MAX_ROW_FRAC,
            f"{label}: {nrows} counter rows differ (> {PSSA_MAX_ROW_FRAC})")
    require(tie <= TIE_REL,
            f"{label}: counters differ at keys {tie:.2e} of tau from it, "
            f"past {TIE_REL}: not a tie")
    return err


@phase("kernels")
def kernels_phase(torch):
    from repro_torch.core.precision import PrecisionPolicy, spot_cas
    from repro_torch.kernels.bitslice_matmul.kernel import (
        bitslice_matmul_kernel)
    from repro_torch.kernels.bitslice_matmul.ref import bitslice_matmul_ref
    from repro_torch.kernels.cross_attention_tips.kernel import (
        cross_attention_tips_kernel)
    from repro_torch.kernels.cross_attention_tips.ref import (
        cross_attention_tips_ref)
    from repro_torch.kernels.pssa_attention.kernel import (
        pssa_attention_kernel)
    from repro_torch.kernels.pssa_attention.ref import (
        pssa_attention_stats_ref)
    from repro_torch.kernels.runtime import cuda_ms

    g = torch.Generator(device="cuda").manual_seed(1234)
    dev = "cuda"
    rows = {}

    def record(name, label, shape, ms, plain_ms, b, err, main):
        print(f"kernel {name} {label} shape={shape} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b[0]:.4f} "
              f"bound_by={b[1]} library_ms=null max_abs_err={err:.3e}",
              flush=True)
        if main:
            rows[name] = {"name": name, "route": "cuda",
                          "source": SOURCES[name],
                          "replaces": REPLACES[name], "shape": shape,
                          "max_abs_err": err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": b[0],
                          "bound_by": b[1], "library_ms": None}

    # -- PSSA self-attention: (label, BH, T, d, patch, exact, main) ------
    for label, bh, t, d, patch, exact, main in [
            ("res64 down0.0 cond-only", 8, 4096, 40, 64, False, False),
            ("res64 up3.*", 16, 4096, 40, 64, False, True),
            ("res32", 16, 1024, 80, 32, True, False),
            ("res16", 16, 256, 160, 16, True, False),
            ("ragged T=48", 2, 48, 40, 16, True, False)]:
        q, k, v = (torch.randn((bh, t, d), generator=g, device=dev)
                   for _ in range(3))
        kern = pssa_attention_kernel(q, k, v, THRESHOLD, patch)
        torch.cuda.synchronize()
        plain = pssa_attention_stats_ref(q, k, v, THRESHOLD, patch)
        err = check_pssa(torch, f"pssa_attention {label}", q, k, patch,
                         kern, plain, exact)
        ms = cuda_ms(pssa_attention_kernel, q, k, v, THRESHOLD, patch,
                     reps=10)
        plain_ms = cuda_ms(pssa_attention_stats_ref, q, k, v, THRESHOLD,
                           patch, reps=3)
        nnz = plain[1].sum().item()
        ops = 2.0 * bh * t * t * d + 2.0 * nnz * d   # q k^T + kept p @ v
        nbytes = 4.0 * (4 * bh * t * d + 2 * bh * t)
        record("pssa_attention", label, [bh, t, d, patch], ms, plain_ms,
               bound(nbytes, ops, FP32_FLOPS), err, main)
        del q, k, v, kern, plain

    # -- TIPS cross-attention: (label, BH, Tq, Tk, d, main) --------------
    for label, bh, tq, tk, d, main in [
            ("res64", 16, 4096, 77, 40, True),
            ("res32", 16, 1024, 77, 80, False),
            ("res16", 16, 256, 77, 160, False),
            ("ragged Tq=100", 2, 100, 77, 40, False)]:
        q = torch.randn((bh, tq, d), generator=g, device=dev)
        k, v = (torch.randn((bh, tk, d), generator=g, device=dev)
                for _ in range(2))
        k[:, 0] *= CLS_KEY_SCALE        # CAS on both sides of the cut
        out_k, cas_k = cross_attention_tips_kernel(q, k, v, 0)
        torch.cuda.synchronize()
        out_p, cas_p = cross_attention_tips_ref(q, k, v, 0)
        err_o = (out_k - out_p).abs().max().item()
        err_c = (cas_k - cas_p).abs().max().item()
        require(err_o <= OUT_ATOL and err_c <= CAS_ATOL,
                f"cross_attention_tips {label}: out {err_o} / cas {err_c}")
        # the importance mask downstream, through the port's spotting on
        # the head-averaged CAS (8 heads per row; the ragged case: 1 row)
        heads = 8 if bh % 8 == 0 else bh
        for pol in (PrecisionPolicy.fixed(), PrecisionPolicy.adaptive()):
            imp_k, imp_p = (
                spot_cas(c.reshape(bh // heads, heads, tq).mean(1),
                         pol).important for c in (cas_k, cas_p))
            print(f"  cross_attention_tips {label} {pol.spotting}: "
                  f"{imp_p.float().mean().item():.3f} of rows important, "
                  f"masks equal {bool(torch.equal(imp_k, imp_p))}")
            require(torch.equal(imp_k, imp_p),
                    f"cross_attention_tips {label}: {pol.spotting} "
                    f"importance masks differ")
        print(f"  cross_attention_tips {label}: out max|err| {err_o:.3e}, "
              f"cas max|err| {err_c:.3e}")
        ms = cuda_ms(cross_attention_tips_kernel, q, k, v, 0, reps=20)
        plain_ms = cuda_ms(cross_attention_tips_ref, q, k, v, 0, reps=10)
        ops = 2.0 * 2.0 * bh * tq * tk * d           # q k^T + p @ v
        nbytes = 4.0 * (2 * bh * tq * d + 2 * bh * tk * d + bh * tq)
        record("cross_attention_tips", label, [bh, tq, tk, d], ms, plain_ms,
               bound(nbytes, ops, FP32_FLOPS), max(err_o, err_c), main)

    # -- DBSC bit-slice matmul: (label, M, K, N, main) --------------------
    cases = []
    for res, c in ((64, 320), (32, 640), (16, 1280)):
        t2 = 2 * res * res
        cases.append((f"ff_geglu res{res}", t2, c, 8 * c, res == 64))
        cases.append((f"ff_out res{res}", t2, 4 * c, c, False))
    cases.append(("ragged", 100, 77, 50, False))
    for label, m, kk, n, main in cases:
        hi = torch.randint(0, 64, (m, kk), generator=g, device=dev,
                           dtype=torch.int32)
        lo = torch.randint(0, 64, (m, kk), generator=g, device=dev,
                           dtype=torch.int32)
        w = torch.randint(-128, 128, (kk, n), generator=g, device=dev,
                          dtype=torch.int32)
        prec = torch.randint(0, 2, (m, 1), generator=g, device=dev,
                             dtype=torch.int32)
        plain = bitslice_matmul_ref(hi, lo, w, prec)
        for dataflow in ("weight_stationary", "input_stationary"):
            out = bitslice_matmul_kernel(hi, lo, w, prec, dataflow)
            require(torch.equal(out, plain),
                    f"bitslice_matmul {label} {dataflow}: not bit-exact")
        ms = cuda_ms(bitslice_matmul_kernel, hi, lo, w, prec, reps=20)
        plain_ms = cuda_ms(bitslice_matmul_ref, hi, lo, w, prec, reps=5)
        ops = 2.0 * kk * n * (m + prec.sum().item())  # hi rows + kept lo rows
        nbytes = 4.0 * (2 * m * kk + kk * n + m + m * n)
        record("bitslice_matmul", label, [m, kk, n], ms, plain_ms,
               bound(nbytes, ops, INT8_OPS), 0.0, main)
    # int32 wrap-around: 63 * 127 * 5120 << 6 passes 2**31
    hi = torch.full((64, 5120), 63, dtype=torch.int32, device=dev)
    w = torch.full((5120, 64), 127, dtype=torch.int32, device=dev)
    prec = torch.ones((64, 1), dtype=torch.int32, device=dev)
    out = bitslice_matmul_kernel(hi, hi, w, prec)
    plain = bitslice_matmul_ref(hi, hi, w, prec)
    expect = (63 * 127 * 5120 * 65 + 2 ** 31) % 2 ** 32 - 2 ** 31
    require(torch.equal(out, plain) and int(out[0, 0]) == expect,
            f"bitslice_matmul overflow: {int(out[0, 0])} != {expect}")
    print(f"  bitslice_matmul int32 wrap-around case equal "
          f"({int(out[0, 0])})")
    return rows


# ---------------------------------------------------------------------------
def _tokens(torch, cfg, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(1, cfg.text.vocab_size, (1, cfg.text.max_len),
                         generator=g, device="cuda", dtype=torch.int32)
    toks[:, 0] = 0                               # CLS first
    return toks, torch.zeros_like(toks)


@phase("slice")
def slice_phase(torch):
    from repro_torch.configs import bk_sdm
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import energy_report
    from repro_torch.kernels import runtime
    from repro_torch.kernels.dispatch import KernelPolicy

    cfg = bk_sdm.with_kernel_policy(
        bk_sdm.CONFIG, KernelPolicy(self_attention="fused",
                                    cross_attention="fused", ffn="dbsc"))
    require(cfg.ddim.num_inference_steps == 25
            and cfg.ddim.guidance_scale == 7.5, "not the paper's schedule")
    t0 = time.perf_counter()
    eng = DiffusionEngine(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"full-width parameters initialised in "
          f"{time.perf_counter() - t0:.2f} s")
    toks, un = _tokens(torch, cfg, 7)
    latents = eng.init_latents(1, torch.Generator(device="cuda")
                               .manual_seed(8))
    eng.generate(toks, uncond_tokens=un, latents=latents.clone())  # warm-up
    print(f"warm-up generate {eng.last_wall_s:.3f} s")

    runtime.reset_launch_counts()
    out = eng.generate(toks, uncond_tokens=un, latents=latents.clone())
    counts = runtime.launch_counts()
    wall = eng.last_wall_s
    print(f"launches {json.dumps(counts)}")
    require(tuple(out.images.shape) == (1, 512, 512, 3),
            f"image shape {tuple(out.images.shape)}")
    require(bool(torch.isfinite(out.images).all()), "non-finite image")
    require(bool(torch.isfinite(out.latents).all()), "non-finite latents")
    want = {"pssa_attention": 225, "cross_attention_tips": 225,
            "bitslice_matmul": 450}
    require(all(counts.get(k) == v for k, v in want.items()),
            f"launch counts {counts} != {want}")
    steps = cfg.ddim.num_inference_steps
    print(f"s/image {wall:.4f}  ms/step {wall / steps * 1e3:.3f} "
          f"(wall of one generate incl. text encode and VAE decode, "
          f"over {steps} steps)")
    summary = energy_report(cfg, out.stats).summary()
    print("energy_report " + json.dumps(summary))
    require(all(math.isfinite(v) for v in summary.values()),
            "non-finite energy report")
    profile_breakdown(torch, eng, toks, un, latents)
    return eng, counts


def profile_breakdown(torch, eng, toks, un, latents, top: int = 15):
    """Device time by kernel over one more generate, under torch.profiler
    (this run's counts and wall time are not the ones reported above)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(toks, uncond_tokens=un, latents=latents.clone())
    wall_ms = eng.last_wall_s * 1e3
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    total = sum(r[0] for r in rows)
    if total == 0:
        print("profile: the profiler recorded no device time (not measured)")
        return
    rows.sort(reverse=True)
    print(f"profile: device busy {total:.2f} ms in a {wall_ms:.2f} ms "
          f"generate with the profiler on ({total / wall_ms:.1%} busy)")
    for name in REPLACES:
        ms = sum(r[0] for r in rows if name + "_kernel" in r[2])
        print(f"profile: {name} {ms:.2f} ms ({ms / total:.1%} of device "
              f"time)")
    for ms, n, key in rows[:top]:
        print(f"profile:   {ms:9.2f} ms {n:6d}x {key[:110]}")


HEADLINES = ("total_ema_reduction", "ema_gb_per_iter_optimized",
             "mj_per_iter_with_ema")


def _differences(torch, ref, other, reports) -> dict:
    """Latents, ledger headlines and per-layer PSSA counters of two runs
    from the same latents: the largest latent difference, each headline's
    relative difference, and the worst layer's counter difference as a
    share of the per-layer bound (PSSA_MAX_ROW_DIFF counts on
    PSSA_MAX_ROW_FRAC of the layer's rows, past one float32 ulp of the
    counter)."""
    diff = {"latents": (ref.latents - other.latents).abs().max().item()}
    for key in HEADLINES:
        a, b = (r[key] for r in reports)
        diff[key] = abs(a - b) / max(abs(a), 1e-30)
    rs, fs = ref.stats.cpu(), other.stats.cpu()
    worst = 0.0
    for li, lk in enumerate(rs.layers):
        rows = 8 * (lk.resolution ** 2)          # heads x queries, cond row
        allowed = PSSA_MAX_ROW_DIFF * math.ceil(PSSA_MAX_ROW_FRAC * rows)
        for field in ("nnz", "bitmap_ones_xor"):
            a = getattr(rs.pssa[li], field)
            b = getattr(fs.pssa[li], field)
            d = (a - b).abs().max().item()
            ulp = torch.finfo(torch.float32).eps * a.abs().max().item()
            worst = max(worst, max(d - ulp, 0.0) / allowed)
    diff["counters"] = worst
    print("  latents max|diff| {:.3e}; relative: {}; counters at {:.2f} of "
          "the bound".format(diff["latents"], ", ".join(
              f"{k} {diff[k]:.3e}" for k in HEADLINES), worst))
    return diff


def _hold(label, diff, latent_atol, counter_scale, headlines):
    require(diff["latents"] <= latent_atol,
            f"{label}: latents differ by {diff['latents']} > {latent_atol}")
    for key in headlines:
        require(diff[key] <= LEDGER_RTOL,
                f"{label}: {key} differs by {diff[key]} relative")
    require(diff["counters"] <= counter_scale,
            f"{label}: PSSA counters at {diff['counters']:.2f} of the "
            f"bound > {counter_scale}")


@phase("parity")
def parity_phase(torch, eng):
    """Two full-width steps from the same latents, route against route.

    1. ``reference()`` against ``fused()``: the attention kernels alone,
       the FFN on the float reference on both sides.  Latents within
       LATENT_ATOL, both ledger headlines within LEDGER_RTOL, counters
       within the per-layer bound.
    2. Reference attention + DBSC against the slice's route (fused +
       DBSC), on each of DBSC_SEEDS.  A flipped INT12 code follows any ulp
       of upstream difference, so latents are held to DBSC_LATENT_ATOL and
       counters to DBSC_COUNTER_SCALE times the bound.
       ``mj_per_iter_with_ema`` and the optimized EMA bytes are held to
       LEDGER_RTOL.  ``total_ema_reduction`` is one minus their ratio to
       the dense baseline, near zero with random weights (-0.0165), so its
       relative difference is that of the bytes divided by it; it is
       printed, and held through the bytes.
    3. A witness without any kernel difference: reference attention + DBSC
       against itself from latents one ulp apart, printed beside 2.
    """
    from repro_torch.configs import bk_sdm
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import energy_report
    from repro_torch.kernels.dispatch import KernelPolicy

    base = dataclasses.replace(bk_sdm.CONFIG, ddim=dataclasses.replace(
        bk_sdm.CONFIG.ddim, num_inference_steps=2))
    params = {"text": eng.text_params, "unet": eng.unet_params,
              "vae": eng.vae_params}

    def run(name, pol, seed, latents=None):
        toks, un = _tokens(torch, base, seed)
        if latents is None:
            latents = eng.init_latents(1, torch.Generator(device="cuda")
                                       .manual_seed(seed + 1))
        cfg = bk_sdm.with_kernel_policy(base, pol)
        e = DiffusionEngine(cfg, params=params)
        out = e.generate(toks, uncond_tokens=un, latents=latents.clone())
        rep = energy_report(cfg, out.stats).summary()
        print(f"{name}, seed {seed}: {e.last_wall_s:.3f} s, "
              f"mj_per_iter_with_ema {rep['mj_per_iter_with_ema']!r}, "
              f"total_ema_reduction {rep['total_ema_reduction']!r}")
        return out, rep, latents

    seed = DBSC_SEEDS[0]
    ref, ref_rep, _ = run("reference", KernelPolicy.reference(), seed)
    fused, fused_rep, _ = run("fused", KernelPolicy.fused(), seed)
    print("reference vs fused:")
    _hold("reference vs fused",
          _differences(torch, ref, fused, (ref_rep, fused_rep)),
          LATENT_ATOL, 1.0, HEADLINES)

    ref_dbsc = KernelPolicy(ffn="dbsc")
    slice_route = KernelPolicy(self_attention="fused",
                               cross_attention="fused", ffn="dbsc")
    for seed in DBSC_SEEDS:
        ref_d, ref_d_rep, latents = run("reference attention + dbsc",
                                        ref_dbsc, seed)
        fused_d, fused_d_rep, _ = run("fused + dbsc", slice_route, seed)
        print(f"reference attention + dbsc vs fused + dbsc, seed {seed}:")
        _hold(f"dbsc pair, seed {seed}",
              _differences(torch, ref_d, fused_d, (ref_d_rep, fused_d_rep)),
              DBSC_LATENT_ATOL, DBSC_COUNTER_SCALE,
              ("ema_gb_per_iter_optimized", "mj_per_iter_with_ema"))
    nudged = torch.nextafter(latents, torch.full_like(latents, math.inf))
    ulp_d, ulp_d_rep, _ = run("reference attention + dbsc, latents + 1 ulp",
                              ref_dbsc, seed, latents=nudged)
    print(f"witness: reference attention + dbsc against itself, latents "
          f"one ulp apart, seed {seed}:")
    _differences(torch, ref_d, ulp_d, (ref_d_rep, ulp_d_rep))


# ---------------------------------------------------------------------------
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    try:
        smi = environment(torch)
        build_kernels()
        rows = kernels_phase(torch)
        eng, counts = slice_phase(torch)
        parity_phase(torch, eng)
    except Exception as exc:                      # report, then fail
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    for name, row in rows.items():
        row["launches"] = counts[name]
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [rows[n] for n in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
