"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.  Tolerances: PSSA counters
exact (these shapes hold no score within an ulp of the threshold); DBSC
integers exact (the kernel narrows its operands to int8, which is exact
on the domain it is fed); attention outputs rtol 1e-4, atol 1e-5 and
CAS atol 1e-6 (float32 in another summation order); the patch delta and
the PSXU bitmap bit for bit (a max and a compare need no order), NaN
where NaN; the SSD scan rtol/atol 2e-4 against the sequential recurrence
(the JAX package's bound for its chunked kernel against its oracle);
every launch-knob candidate bit for bit against the launch rule (no row
or patch depends on its block) and the int8 route's integers exactly.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import bk_sdm
from repro_torch.diffusion.engine import DiffusionEngine
from repro_torch.kernels import runtime
from repro_torch.kernels.bitslice_matmul.kernel import (
    K_MAX, bitslice_matmul_kernel)
from repro_torch.kernels.bitslice_matmul.ref import bitslice_matmul_ref
from repro_torch.kernels.cross_attention_tips.kernel import (
    cross_attention_tips_kernel)
from repro_torch.kernels.cross_attention_tips.ref import (
    cross_attention_tips_ref)
from repro_torch.core.reuse import ReusePolicy
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.patch_bitmap.kernel import patch_bitmap_kernel
from repro_torch.kernels.patch_bitmap.ref import patch_bitmap_ref
from repro_torch.kernels.patch_reuse.kernel import patch_delta_kernel
from repro_torch.kernels.patch_reuse.ref import patch_delta_ref
from repro_torch.kernels.pssa_attention.kernel import pssa_attention_kernel
from repro_torch.kernels.pssa_attention.ref import pssa_attention_stats_ref
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

THR = 1.0 / 8192.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    return torch.device("cuda")


# (BH, T, d, patch, q scale, threshold): d = 13 pads to 16 columns; d = 80
# at T = 1024 is res 32's width; q x 6 makes the rows peaky, so most keys
# are pruned; threshold 0 keeps every key.  DiT-S/2's head dim 64 at
# T = 256: BH 6 in block 0 (before the CFG tiling) and 12 after it.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bh,t,d,patch,qscale,thr", [
    (4, 256, 40, 16, 1.0, THR), (2, 48, 8, 16, 1.0, THR),
    (2, 128, 160, 64, 1.0, THR), (2, 48, 13, 16, 1.0, THR),
    (2, 1024, 80, 64, 1.0, THR), (4, 256, 40, 16, 6.0, THR),
    (2, 128, 40, 64, 1.0, 0.0), (6, 256, 64, 16, 1.0, THR),
    (12, 256, 64, 16, 1.0, THR)])
def test_pssa_kernel_matches_plain(cuda, bh, t, d, patch, qscale, thr):
    g = torch.Generator(device=cuda).manual_seed(t + d)
    q, k, v = (torch.randn((bh, t, d), generator=g, device=cuda)
               for _ in range(3))
    q *= qscale
    out, nnz, xr = pssa_attention_kernel(q, k, v, thr, patch)
    out_p, nnz_p, xr_p = pssa_attention_stats_ref(q, k, v, thr, patch)
    assert torch.equal(nnz, nnz_p) and torch.equal(xr, xr_p)
    torch.testing.assert_close(out, out_p, rtol=1e-4, atol=1e-5)
    if thr == 0.0:
        assert bool((nnz == t).all())
    if qscale > 1.0:
        assert nnz.float().mean().item() < t / 4


# (BH, Tq, Tk, d, patch): Tq = 100 is not a multiple of the kernel's row
# block; Tq = T/8 at d = 40 is the edit path's gathered res-64 width.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bh,tq,tk,d,patch", [(4, 32, 256, 40, 16),
                                              (2, 128, 1024, 80, 64),
                                              (2, 100, 256, 40, 16),
                                              (4, 128, 1024, 40, 64)])
def test_pssa_kernel_gathered_queries_match_plain(cuda, bh, tq, tk, d,
                                                  patch):
    g = torch.Generator(device=cuda).manual_seed(tq + tk)
    q = torch.randn((bh, tq, d), generator=g, device=cuda)
    k, v = (torch.randn((bh, tk, d), generator=g, device=cuda)
            for _ in range(2))
    out, nnz, xr = pssa_attention_kernel(q, k, v, THR, patch)
    out_p, nnz_p, xr_p = pssa_attention_stats_ref(q, k, v, THR, patch)
    assert torch.equal(nnz, nnz_p) and torch.equal(xr, xr_p)
    torch.testing.assert_close(out, out_p, rtol=1e-4, atol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,p,w", [(2, 64, 20480), (1, 16, 20480),
                                   (3, 7, 2050), (2, 5, 3), (2, 16, 6144)])
def test_patch_delta_kernel_matches_plain(cuda, b, p, w):
    g = torch.Generator(device=cuda).manual_seed(p * w)
    x = torch.randn((b, p, w), generator=g, device=cuda)
    r = x + 0.01 * torch.randn((b, p, w), generator=g, device=cuda)
    r[:, 0] = x[:, 0]                           # a patch with delta 0
    x[-1, -1, -1] = float("nan")
    r[0, p // 2, 0] = float("inf")
    out = patch_delta_kernel(x, r)
    plain = patch_delta_ref(x, r, 1)      # (B, P, W) as P one-token patches
    nan = torch.isnan(plain)
    assert torch.equal(torch.isnan(out), nan) and bool(nan[-1, -1])
    assert torch.equal(out[~nan].view(torch.int32),
                       plain[~nan].view(torch.int32))
    assert bool((out[:, 0] == 0).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows,tk,patch", [(70, 64, 16), (33, 256, 16),
                                           (64, 1024, 32), (40, 4096, 64),
                                           (5, 96, 32)])
def test_patch_bitmap_kernel_matches_plain(cuda, rows, tk, patch):
    g = torch.Generator(device=cuda).manual_seed(rows + tk)
    sas = torch.softmax(3.0 * torch.randn((rows, tk), generator=g,
                                          device=cuda), dim=-1)
    sas[0, :3] = THR                            # on the threshold: kept
    packed, counts = patch_bitmap_kernel(sas, patch, THR)
    packed_p, counts_p = patch_bitmap_ref(sas, patch, THR)
    assert torch.equal(packed.view(torch.int32), packed_p.view(torch.int32))
    assert torch.equal(counts, counts_p)


# (BH, Tq, Tk, d): the main path's three shapes (res 64, 32, 16 under
# CFG); one key, one 8-key n-tile and the most keys; the narrowest d and
# the widest; one query row, and Tq = 100, not a multiple of the kernel's
# 16-row warp tile; DiT-S/2 under CFG (2 rows x 6 heads, d = 64).
@pytest.mark.requires_cuda
@pytest.mark.parametrize("bh,tq,tk,d", [
    (4, 256, 77, 40), (2, 100, 7, 8), (12, 256, 77, 64),
    (16, 4096, 77, 40), (16, 1024, 77, 80), (16, 256, 77, 160),
    (2, 100, 1, 40), (2, 100, 8, 40), (2, 100, 128, 40),
    (2, 64, 77, 8), (2, 64, 77, 160), (3, 1, 77, 40)])
def test_cross_kernel_matches_plain(cuda, bh, tq, tk, d):
    g = torch.Generator(device=cuda).manual_seed(tq + tk)
    q = torch.randn((bh, tq, d), generator=g, device=cuda)
    k, v = (torch.randn((bh, tk, d), generator=g, device=cuda)
            for _ in range(2))
    out, cas = cross_attention_tips_kernel(q, k, v)
    out_p, cas_p = cross_attention_tips_ref(q, k, v)
    torch.testing.assert_close(out, out_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(cas, cas_p, rtol=0, atol=1e-6)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tk,cls_index", [(77, 5), (77, 76), (128, 127),
                                          (8, 3)])
def test_cross_kernel_cls_index(cuda, tk, cls_index):
    g = torch.Generator(device=cuda).manual_seed(tk + cls_index)
    q = torch.randn((4, 256, 40), generator=g, device=cuda)
    k, v = (torch.randn((4, tk, 40), generator=g, device=cuda)
            for _ in range(2))
    k[:, cls_index] *= 2.5
    out, cas = cross_attention_tips_kernel(q, k, v, cls_index)
    out_p, cas_p = cross_attention_tips_ref(q, k, v, cls_index)
    torch.testing.assert_close(out, out_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(cas, cas_p, rtol=0, atol=1e-6)


# (B, H, Tq, d): res 64 and res 16 under CFG, d = 13 (odd rows: the
# kernel's 4-byte copies and scalar loads and stores), and DiT-S/2
@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,h,tq,d", [(2, 8, 4096, 40), (2, 8, 256, 160),
                                      (1, 3, 100, 13), (2, 6, 256, 64)])
def test_cross_op_reads_the_head_split_views(cuda, b, h, tq, d):
    """The op on the views the UNet's head split makes: out equals the
    contiguous 3-D call's bit for bit, and the head merge is a view of
    out's memory (no copy on the way in or out)."""
    from repro_torch.diffusion.unet import _attn_heads, _merge_heads
    from repro_torch.kernels.cross_attention_tips.ops import (
        cross_attention_cas)
    g = torch.Generator(device=cuda).manual_seed(tq + d)
    x = torch.randn((b, tq, h * d), generator=g, device=cuda)
    ctx = torch.randn((b, 77, h * d), generator=g, device=cuda)
    w_q, w_k, w_v = (torch.randn((h * d, h * d), generator=g, device=cuda)
                     / (h * d) ** 0.5 for _ in range(3))
    q = _attn_heads(x, w_q, h)
    k, v = _attn_heads(ctx, w_k, h), _attn_heads(ctx, w_v, h)
    assert not q.is_contiguous()
    out, cas = cross_attention_cas(q, k, v)
    assert out.shape == (b, h, tq, d) and cas.shape == (b, h, tq)
    flat = [t.reshape(b * h, -1, d).contiguous() for t in (q, k, v)]
    out3, cas3 = cross_attention_tips_kernel(*flat)
    assert torch.equal(out.reshape(b * h, tq, d), out3)
    assert torch.equal(cas.reshape(b * h, tq), cas3)
    merged = _merge_heads(out)
    assert merged.data_ptr() == out.data_ptr()
    assert (merged.untyped_storage().data_ptr()
            == out.untyped_storage().data_ptr())
    out_p, cas_p = cross_attention_tips_ref(*flat)
    torch.testing.assert_close(out3, out_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(cas3, cas_p, rtol=0, atol=1e-6)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tk,d,cls_index,match", [
    (129, 40, 0, "text keys"), (77, 161, 0, "head dim"),
    (77, 40, 77, "cls_index")])
def test_cross_kernel_refuses_what_it_does_not_take(cuda, tk, d, cls_index,
                                                    match):
    q = torch.zeros((2, 64, d), device=cuda)
    k = torch.zeros((2, tk, d), device=cuda)
    with pytest.raises(ValueError, match=match):
        cross_attention_tips_kernel(q, k, k, cls_index)


# (M, K, N, operands, prec): K = 77 and 100 are not multiples of the
# kernel's 32-deep slab, and 77 leaves the rows without 16-byte alignment;
# the res-16 shapes split K over blocks; the corners sit at the domain's
# ends at K = 5120, where (hi @ w) << 6 wraps; the last case must raise.
BITSLICE_CASES = {
    "ragged K=77": (100, 77, 50, "random", "mixed"),
    "ragged K=100": (130, 100, 132, "random", "mixed"),
    "unaligned planes": (96, 64, 64, "offset", "mixed"),
    "res16 ff_geglu": (512, 1280, 10240, "random", "mixed"),
    "res16 ff_out": (512, 5120, 1280, "random", "mixed"),
    "dit ff_geglu": (512, 384, 3072, "random", "mixed"),
    "dit ff_out": (512, 1536, 384, "random", "mixed"),
    "corner w=-128": (64, 5120, 64, -128, "ones"),
    "corner w=127": (64, 5120, 64, 127, "ones"),
    "prec all 0": (256, 320, 256, "random", "zeros"),
    "prec all 1": (256, 320, 256, "random", "ones"),
    "K above the limit": (2, K_MAX + 1, 8, "random", "ones"),
}


def _bitslice_inputs(dev, m, k, n, operands, rows):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    if operands in ("random", "offset"):
        hi, lo = (torch.randint(0, 64, (m, k), generator=g, device=dev,
                                dtype=torch.int32) for _ in range(2))
        w = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int32)
    else:
        hi = torch.full((m, k), 63, dtype=torch.int32, device=dev)
        lo = hi.clone()
        w = torch.full((k, n), operands, dtype=torch.int32, device=dev)
    if operands == "offset":     # contiguous, but 4 bytes past 16-aligned
        hi, lo = (torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                             x.reshape(-1)])[1:].view(m, k) for x in (hi, lo))
        assert hi.data_ptr() % 16 == 4
    if rows == "mixed":
        prec = torch.randint(0, 2, (m, 1), generator=g, device=dev,
                             dtype=torch.int32)
    else:
        prec = torch.full((m, 1), int(rows == "ones"), dtype=torch.int32,
                          device=dev)
    return hi, lo, w, prec


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dataflow", ["weight_stationary",
                                      "input_stationary"])
@pytest.mark.parametrize("case", list(BITSLICE_CASES))
def test_bitslice_kernel_matches_plain(cuda, case, dataflow):
    m, k, n, operands, rows = BITSLICE_CASES[case]
    hi, lo, w, prec = _bitslice_inputs(cuda, m, k, n, operands, rows)
    if k > K_MAX:
        with pytest.raises(ValueError, match="exceeds"):
            bitslice_matmul_kernel(hi, lo, w, prec, dataflow)
        return
    out = bitslice_matmul_kernel(hi, lo, w, prec, dataflow)
    assert torch.equal(out, bitslice_matmul_ref(hi, lo, w, prec))
    if operands in (-128, 127):   # every entry wraps past int32
        exact = 63 * operands * k * 65
        assert int(out[0, 0]) == (exact + 2 ** 31) % 2 ** 32 - 2 ** 31


@pytest.mark.requires_cuda
def test_smoke_engine_goes_through_the_kernels(cuda):
    cfg = bk_sdm.with_kernel_policy(
        bk_sdm.SMOKE, KernelPolicy(self_attention="fused",
                                   cross_attention="fused", ffn="dbsc"))
    eng = DiffusionEngine(cfg)
    toks = torch.zeros((1, cfg.text.max_len), dtype=torch.int32,
                       device=cuda)
    runtime.reset_launch_counts()
    out = eng.generate(toks)
    steps, blocks = cfg.ddim.num_inference_steps, 9
    counts = runtime.launch_counts()
    assert counts["pssa_attention"] == steps * blocks
    assert counts["cross_attention_tips"] == steps * blocks
    assert counts["bitslice_matmul"] == 2 * steps * blocks
    assert counts.get("patch_delta", 0) == 0
    assert bool(torch.isfinite(out.images).all())


@pytest.mark.requires_cuda
def test_smoke_temporal_reuse_goes_through_the_kernels(cuda):
    cfg = bk_sdm.with_kernel_policy(bk_sdm.SMOKE, dataclasses.replace(
        KernelPolicy.fused(), ffn="dbsc"))
    dense = DiffusionEngine(cfg)
    params = {"text": dense.text_params, "unet": dense.unet_params,
              "vae": dense.vae_params}
    toks = torch.zeros((1, cfg.text.max_len), dtype=torch.int32,
                       device=cuda)
    lat = dense.init_latents(1, torch.Generator(device=cuda).manual_seed(1))
    out_d = dense.generate(toks, latents=lat.clone())
    steps, blocks = cfg.ddim.num_inference_steps, 9
    for reuse in (ReusePolicy.temporal(0.0), ReusePolicy.temporal(0.05)):
        rcfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, reuse_policy=reuse))
        runtime.reset_launch_counts()
        out = DiffusionEngine(rcfg, params=params).generate(
            toks, latents=lat.clone())
        counts = runtime.launch_counts()
        assert counts["patch_delta"] == steps * blocks
        assert counts["pssa_attention"] == steps * blocks
        assert counts["bitslice_matmul"] == 2 * steps * blocks
        if reuse.threshold == 0.0:
            assert torch.equal(out.latents, out_d.latents)
        for c in out.stats.reuse:
            assert bool((c.computed <= c.total).all())
            assert torch.equal(c.computed[0], c.total[0])


def _guided_smoke(policy):
    cfg = bk_sdm.with_kernel_policy(bk_sdm.SMOKE, policy)
    return dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, guidance_scale=7.5))


def _slot_requests(cuda, cfg, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    out = []
    for _ in range(n):
        toks = torch.randint(1, cfg.text.vocab_size, (1, cfg.text.max_len),
                             generator=g, device=cuda, dtype=torch.int32)
        toks[:, 0] = 0
        lat = torch.randn((1, 16, 16, 4), generator=g, device=cuda)
        out.append((toks, torch.zeros_like(toks), lat))
    return out


SLICE = KernelPolicy(self_attention="fused", cross_attention="fused",
                     ffn="dbsc")


@pytest.mark.requires_cuda
def test_ledger_fetch_leaves_the_row_leaves_on_the_card(cuda):
    """``UNetStats.ledger_fetch`` copies the ledger's leaves to the host
    and leaves ``important`` and ``cas`` on the card; the report through
    it equals the one from a host copy of every leaf, key for key."""
    from repro_torch.diffusion.pipeline import energy_report
    cfg = _guided_smoke(SLICE)
    reqs = _slot_requests(cuda, cfg, 2, 3)
    out = DiffusionEngine(cfg).generate(
        torch.cat([r[0] for r in reqs]),
        uncond_tokens=torch.cat([r[1] for r in reqs]),
        latents=torch.cat([r[2] for r in reqs]))
    got = out.stats.ledger_fetch()
    assert all(x.device.type == "cpu" for s in got.pssa for x in s)
    for t in got.tips:
        assert t.important.is_cuda and t.cas.is_cuda
        assert t.low_precision_ratio.device.type == "cpu"
    assert (energy_report(cfg, out.stats).summary()
            == energy_report(cfg, out.stats.cpu()).summary())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("num_slots", [1, 2, 4])
def test_smoke_slot_step_goes_through_the_kernels(cuda, num_slots):
    """9 / 9 / 18 launches per slot step under fused CFG at any slot
    count; admit, decode and retire launch none."""
    cfg = _guided_smoke(SLICE)
    eng = DiffusionEngine(cfg)
    reqs = _slot_requests(cuda, cfg, num_slots, 1)
    runtime.reset_launch_counts()
    state = eng.init_slots(num_slots)
    for s, (toks, un, lat) in enumerate(reqs):
        state = eng.admit(state, s, toks, uncond_tokens=un, latents=lat)
    assert sum(runtime.launch_counts().values()) == 0
    for step in range(1, cfg.ddim.num_inference_steps + 1):
        state = eng.slot_step(state)
        counts = runtime.launch_counts()
        assert counts["pssa_attention"] == 9 * step
        assert counts["cross_attention_tips"] == 9 * step
        assert counts["bitslice_matmul"] == 18 * step
    done = eng.finished_slots(state)
    assert done == list(range(num_slots))
    imgs = eng.decode_slots(state, done)
    state = eng.retire(state, done)
    assert runtime.launch_counts()["pssa_attention"] == 27
    assert bool(torch.isfinite(imgs).all()) and not bool(state.active.any())


@pytest.mark.requires_cuda
def test_smoke_slots_bit_equal_to_one_shot_on_card(cuda):
    """Two requests admitted together run generate's batch-2 rows bit for
    bit on the kernels, and the accumulator's headline equals the
    one-shot ledger's."""
    from repro_torch.diffusion.pipeline import (energy_report_from_accum,
                                                energy_report_multi)
    cfg = _guided_smoke(SLICE)
    eng = DiffusionEngine(cfg)
    reqs = _slot_requests(cuda, cfg, 2, 2)
    state = eng.init_slots(2)
    for s, (toks, un, lat) in enumerate(reqs):
        state = eng.admit(state, s, toks, uncond_tokens=un, latents=lat)
    while not eng.finished_slots(state):
        state = eng.slot_step(state)
    out = eng.generate(torch.cat([r[0] for r in reqs]),
                       uncond_tokens=torch.cat([r[1] for r in reqs]),
                       latents=torch.cat([r[2] for r in reqs]))
    assert torch.equal(state.latents, out.latents)
    assert (energy_report_from_accum(cfg, state.accum).summary()
            == energy_report_multi(cfg, [out.stats]).summary())


@pytest.mark.requires_cuda
def test_smoke_pssa_scale_bank_takes_the_plain_route(cuda):
    """A bank that schedules pssa_scale runs self-attention on the plain
    version (per-row thresholds), so no pssa_attention launch; its
    counters and latents equal a run routed to the plain self-attention
    by the policy itself."""
    from repro_torch.diffusion.solvers import PhaseSchedule, SamplerPolicy
    bank = (SamplerPolicy.ddim(3, phases=PhaseSchedule(
        pssa_scale=(2.0, 1.0, 0.5))),)
    runs = {}
    for name, pol in (("slice", SLICE), ("plain", dataclasses.replace(
            SLICE, self_attention="reference"))):
        cfg = _guided_smoke(pol)
        eng = DiffusionEngine(cfg, generator=torch.Generator(
            device=cuda).manual_seed(0))
        reqs = _slot_requests(cuda, cfg, 2, 3)
        state = eng.init_slots(2, bank=bank)
        for s, (toks, un, lat) in enumerate(reqs):
            state = eng.admit(state, s, toks, uncond_tokens=un, latents=lat)
        runtime.reset_launch_counts()
        while not eng.finished_slots(state):
            state = eng.slot_step(state)
        runs[name] = (state, runtime.launch_counts())
    (state, counts), (plain, _) = runs["slice"], runs["plain"]
    assert counts.get("pssa_attention", 0) == 0
    assert counts["cross_attention_tips"] == 27
    assert counts["bitslice_matmul"] == 54
    assert torch.equal(state.latents, plain.latents)
    for f in ("nnz", "ones_xor", "imp", "rows"):
        assert torch.equal(getattr(state.accum, f), getattr(plain.accum, f))


@pytest.mark.requires_cuda
def test_smoke_dit_slot_step_under_reuse_goes_through_the_kernels(cuda):
    """A DiT slot step under temporal reuse on the slice route launches
    each kernel once a block (the bit-slice matmul twice): PSSA,
    cross-attention, the bit-slice matmul and the patch delta; a valid
    cache at a threshold nothing reaches computes no patch."""
    from repro_torch.configs import dit_s
    cfg = dataclasses.replace(_guided_smoke(SLICE), unet=dataclasses.replace(
        dit_s.SMOKE.unet, kernel_policy=dataclasses.replace(
            SLICE, reuse="kernel"), reuse_policy=ReusePolicy.temporal(1e9)))
    eng = DiffusionEngine(cfg)
    blocks = cfg.unet.depth
    state = eng.init_slots(2)
    for s, (toks, un, lat) in enumerate(_slot_requests(cuda, cfg, 2, 4)):
        state = eng.admit(state, s, toks, uncond_tokens=un, latents=lat)
    runtime.reset_launch_counts()
    for step in (1, 2):
        state = eng.slot_step(state)
        counts = runtime.launch_counts()
        assert counts["pssa_attention"] == blocks * step
        assert counts["cross_attention_tips"] == blocks * step
        assert counts["bitslice_matmul"] == 2 * blocks * step
        assert counts["patch_delta"] == blocks * step
    comp, tot = state.accum.reuse_computed, state.accum.reuse_total
    assert torch.equal(comp[0], tot[0]) and int(tot[1].sum()) > 0
    assert int(comp[1].sum()) == 0
    assert bool(torch.isfinite(state.latents).all())


# ROADMAP Queue 3: cuBLAS picks its fp32 GEMM by the shape, so at these
# shapes of the UNet (the time projection at 1280 channels, res-16
# projections and the text K/V projection at 4 slots under CFG) and of
# DiT (its projections at 4 slots) a row's bits follow the row count.
# While this holds, slot rows equal one-shot rows only at equal batch.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,k,n", [(8, 1280, 1280), (2048, 1280, 1280),
                                   (616, 768, 320), (2048, 384, 384)])
def test_cublas_gemm_rows_follow_the_row_count(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda)
    assert not torch.equal((x @ w)[:m // 2], x[:m // 2] @ w)
    assert torch.equal(x @ w, x @ w)            # the same shape repeats


@pytest.mark.requires_cuda
@pytest.mark.parametrize("family", ["unet", "dit"])
def test_smoke_slots_under_reuse_equal_one_shot_at_equal_shape(cuda,
                                                                family):
    """Two requests through 4 slots under temporal reuse on the fused
    attention + float FFN route: each row bit-equal to generate of the
    two tiled to 4 rows, and the reuse buckets half the one-shot run's."""
    from repro_torch.configs import dit_s
    pol = KernelPolicy(self_attention="fused", cross_attention="fused",
                       reuse="kernel")
    cfg = _guided_smoke(pol)
    if family == "dit":
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            dit_s.SMOKE.unet, kernel_policy=pol))
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, reuse_policy=ReusePolicy.temporal(1.0)))
    eng = DiffusionEngine(cfg)
    reqs = _slot_requests(cuda, cfg, 2, 5)
    state = eng.init_slots(4)
    for s, (toks, un, lat) in enumerate(reqs):
        state = eng.admit(state, s, toks, uncond_tokens=un, latents=lat)
    while not eng.finished_slots(state):
        state = eng.slot_step(state)
    take = reqs * 2
    out = eng.generate(torch.cat([r[0] for r in take]),
                       uncond_tokens=torch.cat([r[1] for r in take]),
                       latents=torch.cat([r[2] for r in take]))
    assert torch.equal(state.latents[:2], out.latents[:2])
    comp = sum(c.computed.to(torch.int64).sum(1) for c in out.stats.reuse)
    assert torch.equal(2 * state.accum.reuse_computed.sum(1), comp)


def _ssd_inputs(cuda, bh, t, p, n, heads, dt_scale, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((bh, t, p), generator=g, device=cuda)
    dA = -dt_scale * torch.nn.functional.softplus(
        torch.randn((bh, t), generator=g, device=cuda))
    B, C = (0.3 * torch.randn((bh // heads, t, n), generator=g, device=cuda)
            for _ in range(2))
    return x, dA, B, C


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bh,t,p,n,chunk,heads", [
    (16, 128, 16, 8, 32, 8), (16, 128, 16, 8, 128, 8),   # smoke model
    (4, 256, 64, 128, 128, 2), (6, 100, 16, 16, 100, 1),  # chunk % 32 != 0
    (4, 97, 16, 8, 1, 2), (2, 256, 32, 16, 256, 1),      # chunk 1, > 128
    (24, 1024, 64, 128, 128, 24),     # the serve layout at a shorter T
    (8, 128, 64, 128, 128, 4),        # T == chunk: one tile, no carry
    (24, 512, 64, 128, 256, 24),      # 24 heads, chunk 256 (two tiles)
    (8, 4000, 64, 128, 32, 4),        # many chunks, T ragged against 128
    (96, 4095, 64, 128, 1, 24),       # serve width, odd T (chunk 1)
    (4, 200, 13, 10, 100, 2),         # p, n, p n not multiples of 4
    (200, 2048, 64, 16, 128, 50),     # hymba-1.5b's prefill: n 16, 50 heads
    (100, 2049, 64, 16, 1, 50)])      # hymba, T + 1 (chunk 1)
def test_ssd_scan_kernel_matches_plain(cuda, bh, t, p, n, chunk, heads):
    x, dA, B, C = _ssd_inputs(cuda, bh, t, p, n, heads, 1.0, t + p)
    y, s = ssd_scan_kernel(x, dA, B, C, chunk=chunk, heads=heads)
    y_p, s_p = ssd_scan_ref(x, dA, B.repeat_interleave(heads, 0),
                            C.repeat_interleave(heads, 0))
    torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s, s_p, rtol=2e-4, atol=2e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", ["x", "bc"])
def test_ssd_scan_kernel_reads_unaligned_inputs(cuda, offset):
    """x, or B and C, as contiguous views 4 bytes past a 16-byte boundary:
    the kernel loads them 4 bytes at a time instead of 16."""
    bh, t, p, n, heads = 8, 300, 64, 128, 4
    ins = _ssd_inputs(cuda, bh, t, p, n, heads, 1.0, 11)

    def shifted(a):
        flat = torch.empty(a.numel() + 1, device=cuda)
        view = flat[1:].view(a.shape)
        view.copy_(a)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view
    x, dA, B, C = ins
    if offset == "x":
        x = shifted(x)
    else:
        B, C = shifted(B), shifted(C)
    y, s = ssd_scan_kernel(x, dA, B, C, chunk=100, heads=heads)
    y_p, s_p = ssd_scan_ref(*ins[:2], ins[2].repeat_interleave(heads, 0),
                            ins[3].repeat_interleave(heads, 0))
    torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s, s_p, rtol=2e-4, atol=2e-4)


@pytest.mark.requires_cuda
def test_ssd_scan_kernel_large_dt_has_no_nan(cuda):
    """|dA| sums past 88 inside a chunk: exp above the diagonal would be
    inf, and inf * 0 NaN, if the decay tile were masked by a product."""
    x, dA, B, C = _ssd_inputs(cuda, 4, 256, 64, 128, 1, 12.0, 5)
    assert float(-dA[0, :128].sum()) > 88.0
    y, s = ssd_scan_kernel(x, dA, B, C, chunk=128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    y_p, s_p = ssd_scan_ref(x, dA, B, C)
    torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s, s_p, rtol=2e-4, atol=2e-4)


@pytest.mark.requires_cuda
def test_smoke_prefill_goes_through_the_ssd_kernel(cuda):
    """One launch per layer in prefill, none in decode."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch("mamba2-130m").smoke().scaled(use_ssd_kernel=True)
    params = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda)
    runtime.reset_launch_counts()
    logits, cache = T.prefill(params, cfg, tokens=toks)
    assert runtime.launch_counts()["ssd_scan"] == cfg.num_layers
    T.decode_step(params, cache, logits[:, -1].argmax(-1)[:, None], 128, cfg)
    assert runtime.launch_counts()["ssd_scan"] == cfg.num_layers
    plain, _ = T.prefill(params, cfg.scaled(use_ssd_kernel=False),
                         tokens=toks)
    assert float((logits - plain).abs().max()
                 / plain.abs().max()) < 2e-2


@pytest.mark.requires_cuda
def test_smoke_hybrid_prefill_goes_through_the_ssd_kernel(cuda):
    """hymba's prefill (state 8 at smoke widths): one launch per layer,
    none in decode; the decode cache carries the ring buffers over."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch("hymba-1.5b").smoke().scaled(use_ssd_kernel=True)
    params = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    runtime.reset_launch_counts()
    logits, pcache = T.prefill(params, cfg, tokens=toks)
    assert runtime.launch_counts()["ssd_scan"] == cfg.num_layers
    cache = T.decode_cache_from_prefill(cfg, pcache, 44)
    T.decode_step(params, cache, logits[:, -1].argmax(-1)[:, None], 40, cfg)
    assert runtime.launch_counts()["ssd_scan"] == cfg.num_layers


@pytest.mark.requires_cuda
def test_ssd_kernel_route_refuses_a_gradient(cuda):
    """The kernel has no backward: with inputs that require a gradient
    under autograd the route raises (nothing falls back to the plain
    scan), a hybrid model with ``use_ssd_kernel=True`` cannot train, and
    under ``torch.inference_mode`` and ``no_grad`` the kernel still
    runs."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_fused
    from repro_torch.models import transformer as T
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(1, 64, 2, 16, generator=g, device=cuda)
    dt = torch.rand(1, 64, 2, generator=g, device=cuda) * 0.1
    A = -torch.rand(2, generator=g, device=cuda)
    B = torch.randn(1, 64, 8, generator=g, device=cuda)
    C = torch.randn(1, 64, 8, generator=g, device=cuda)
    runtime.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan_fused(x.clone().requires_grad_(), dt, A, B, C, chunk=32)
    assert runtime.launch_counts().get("ssd_scan", 0) == 0
    with torch.inference_mode():
        y, _ = ssd_scan_fused(x, dt, A, B, C, chunk=32)
    with torch.no_grad():
        y2, _ = ssd_scan_fused(x.clone().requires_grad_(), dt, A, B, C,
                               chunk=32)
    assert runtime.launch_counts()["ssd_scan"] == 2 and torch.equal(y, y2)
    cfg = get_arch("hymba-1.5b").smoke().scaled(use_ssd_kernel=True)
    params = T.init_params(torch.Generator(device=cuda).manual_seed(1), cfg)
    params["layers"]["ssm"]["in_xbc"].requires_grad_()
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda)
    with pytest.raises(RuntimeError, match="use_ssd_kernel=False"):
        T.loss_fn(params, {"tokens": toks, "labels": toks}, cfg)


# the train step's float32 bound between the card and the CPU: cuBLAS
# against the CPU's sum order, through Adam's per-element normalisation
# (tests/test_torch_train_step.py), features off
TRAIN_CARD_PARAM_SHARE = 0.01


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["plain", "compressed", "microbatches"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b"])
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda, arch, mode):
    """Two train steps from the same state on the card and on the CPU
    (float32, PSSA and TIPS off), plain, with int8 gradient compression
    and with two microbatches: losses within 1e-5, parameters within
    1e-2 lr on all but 1 % of the elements and 4 lr everywhere (a flipped
    int8 code moves an element as a float32-noise gradient does: the
    bounds of tests/test_torch_train_step.py); the card launches no
    hand-written kernel."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW, linear_warmup_cosine
    from repro_torch.train.trainer import make_train_step
    from repro_torch import tree as tree_util
    cfg = get_arch(arch).smoke().scaled(dtype="float32", tips=False,
                                        pssa=False)
    lr = 1e-3
    opt = AdamW(lr=linear_warmup_cosine(lr, 1, 10))
    compression = mode == "compressed"
    step = make_train_step(cfg, opt, compression,
                           2 if mode == "microbatches" else 1)
    cpu_p = T.init_params(torch.Generator().manual_seed(0), cfg)
    states = {}
    for dev in ("cpu", "cuda"):
        p = tree_util.tree_map(lambda a: a.to(dev), cpu_p)
        res = (tree_util.tree_map(
            lambda a: torch.zeros_like(a, dtype=torch.float32), p)
            if compression else torch.zeros((), device=dev))
        states[dev] = (p, opt.init(p), res)
    toks = torch.randint(0, cfg.vocab_size, (2, 4, 32),
                         generator=torch.Generator().manual_seed(1))
    runtime.reset_launch_counts()
    for i in range(2):
        batch = {"tokens": toks[i], "labels": toks[i].roll(-1, dims=1)}
        metrics = {}
        for dev in ("cpu", "cuda"):
            states[dev], metrics[dev] = step(
                states[dev], {k: v.to(dev) for k, v in batch.items()})
        assert abs(float(metrics["cuda"]["loss"])
                   - float(metrics["cpu"]["loss"])) \
            <= 1e-5 * float(metrics["cpu"]["loss"])
        if mode == "microbatches":
            assert float(metrics["cuda"]["aux"]) == 0.0
    assert sum(runtime.launch_counts().values()) == 0
    if compression:
        assert all(r.is_cuda and r.dtype == torch.float32
                   for r in tree_util.leaves(states["cuda"][2]))
    d = torch.cat([(a.cpu() - b).abs().ravel() for a, b in zip(
        tree_util.leaves(states["cuda"][0]),
        tree_util.leaves(states["cpu"][0]))])
    assert float(d.max()) <= 4 * lr
    assert float((d > 1e-2 * lr).float().mean()) <= TRAIN_CARD_PARAM_SHARE


@pytest.mark.requires_cuda
def test_train_main_runs_on_the_card_by_default(cuda, capsys, tmp_path):
    from repro_torch.launch import train as train_cli
    history = train_cli.main(["--arch", "hymba-1.5b", "--smoke", "--steps",
                              "3", "--batch", "2", "--seq", "32",
                              "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "device cuda" in out and len(history) == 3
    assert all(torch.isfinite(torch.tensor(v)) for _, v in history)


# float32 models with PSSA and TIPS on: cuBLAS against the CPU's sum
# order, and a TIPS code on a rounding boundary that flips by a step (the
# FEATURES_RTOL of tests/test_torch_lm.py)
LM_CARD_RTOL = 1e-3


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b",
                                  "hymba-1.5b"])
def test_smoke_lm_on_the_card_matches_the_cpu(cuda, arch):
    """The same weights on the card and on the CPU: prefill logits and
    three greedy decode steps (fed the CPU's tokens); ``serve`` on the
    card gives tokens in the vocabulary."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    cfg = get_arch(arch).smoke().scaled(dtype="float32",
                                        use_ssd_kernel=True)
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg)

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda)
    gpu = to_card(cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))

    def rel(a, ref):
        return float((a.cpu() - ref).abs().max() / ref.abs().max())
    lc, pc = T.prefill(cpu, cfg, tokens=toks)
    lg, pg = T.prefill(gpu, cfg, tokens=toks.to(cuda))
    assert rel(lg, lc) < LM_CARD_RTOL
    cc = T.decode_cache_from_prefill(cfg, pc, 28)
    cg = T.decode_cache_from_prefill(cfg, pg, 28)
    tok = lc[:, -1].argmax(-1)[:, None]
    for i in range(3):
        sc, cc = T.decode_step(cpu, cc, tok, 24 + i, cfg)
        sg, cg = T.decode_step(gpu, cg, tok.to(cuda), 24 + i, cfg)
        assert rel(sg, sc) < LM_CARD_RTOL, i
        tok = sc[:, -1].argmax(-1)[:, None]
    seq, tm = serve(cfg, gpu, toks.to(cuda), 4)
    assert seq.is_cuda and tuple(seq.shape) == (2, 4)
    assert int(seq.min()) >= 0 and int(seq.max()) < cfg.vocab_size
    want = cfg.num_layers if cfg.family == "hybrid" else 0
    assert tm["launches"]["prefill"].get("ssd_scan", 0) == want
    assert tm["launches"]["decode"].get("ssd_scan", 0) == 0


@pytest.mark.requires_cuda
def test_smoke_continuous_scheduler_goes_through_the_kernels(cuda):
    """``ContinuousScheduler`` on the route a CLI spec names: 9 / 9 / 18
    launches per slot step over the whole drain (admit, decode and
    retire launch none)."""
    from repro_torch.launch.scheduler import (ContinuousScheduler,
                                              make_requests)
    pol = KernelPolicy.parse("self_attention=fused,cross_attention=fused,"
                             "ffn=dbsc")
    assert pol == SLICE
    eng = DiffusionEngine(_guided_smoke(pol))
    sched = ContinuousScheduler(eng, 2)
    sched.warmup()
    runtime.reset_launch_counts()
    m = sched.run(make_requests(eng.cfg, 3, seed=4))
    counts = runtime.launch_counts()
    steps = m["engine_steps"]
    assert steps == 2 * eng.cfg.ddim.num_inference_steps
    assert counts["pssa_attention"] == 9 * steps
    assert counts["cross_attention_tips"] == 9 * steps
    assert counts["bitslice_matmul"] == 18 * steps
    assert m["mode"] == "continuous" and m["mean_occupancy"] == 0.75


@pytest.mark.requires_cuda
def test_smoke_continuous_equals_fixed_batch_on_card(cuda):
    """Four requests at t = 0 through 2 slots and micro-batches of 2 on
    the kernels: images and the energy dict equal bit for bit (each slot
    batch holds one micro-batch's requests, so DBSC's shared scale and
    cuBLAS's row count are equal)."""
    from repro_torch.launch.scheduler import (ContinuousScheduler,
                                              FixedBatchScheduler,
                                              make_requests)
    eng = DiffusionEngine(_guided_smoke(SLICE))
    rc, rf = (make_requests(eng.cfg, 4, seed=9) for _ in range(2))
    mc = ContinuousScheduler(eng, 2).run(rc, ledger=True)
    mf = FixedBatchScheduler(eng, 2).run(rf, ledger=True)
    for a, b in zip(rc, rf):
        assert a.image.tobytes() == b.image.tobytes(), a.rid
    assert mc["energy"] == mf["energy"]


@pytest.mark.requires_cuda
def test_serve_diffusion_main_runs_on_the_card_by_default(cuda, capsys):
    import json

    from repro_torch.launch import serve_diffusion
    runtime.reset_launch_counts()
    serve_diffusion.main(["--smoke", "--continuous", "--slots", "2",
                          "--requests", "2", "--steps", "2", "--ledger"])
    head, _, body = capsys.readouterr().out.partition("\n")
    assert "device cuda" in head
    m = json.loads(body)
    assert m["kernel_policy"]["backend"] == "cuda"
    assert m["kernel_policy"]["self_attention"] == "fused"   # auto
    assert m["kernel_policy"]["ffn"] == "reference"
    assert runtime.launch_counts()["pssa_attention"] > 0
    assert runtime.launch_counts().get("bitslice_matmul", 0) == 0


@pytest.mark.requires_cuda
def test_smoke_router_round_goes_through_the_kernels(cuda):
    """``ClusterRouter`` on the slice route: 9 / 9 / 18 launches per
    occupied replica per round; an idle replica is not stepped."""
    from repro_torch.launch.router import ClusterRouter
    from repro_torch.launch.scheduler import make_requests
    eng = DiffusionEngine(_guided_smoke(SLICE))
    router = ClusterRouter(eng, 2, 2)
    router.warmup()
    n = eng.cfg.ddim.num_inference_steps
    for count, steps in ((3, 2 * n), (1, n)):
        runtime.reset_launch_counts()
        m = router.run(make_requests(eng.cfg, count, seed=4))
        counts = runtime.launch_counts()
        assert m["rounds"] == n and m["engine_steps"] == steps
        assert counts["pssa_attention"] == 9 * steps
        assert counts["cross_attention_tips"] == 9 * steps
        assert counts["bitslice_matmul"] == 18 * steps


@pytest.mark.requires_cuda
def test_smoke_router_replica_counts_bit_equal_on_card(cuda):
    """Four requests through 1 and 2 replicas x 2 slots on the fused
    attention + float FFN: the replicas pair other requests, yet the
    images, the merged int64 buckets and the energy dict are equal bit
    for bit (every step runs 2 rows, so cuBLAS's row count is equal)."""
    from repro_torch.diffusion.pipeline import merge_ledger_accums
    from repro_torch.launch.router import ClusterRouter
    from repro_torch.launch.scheduler import make_requests
    eng = DiffusionEngine(_guided_smoke(KernelPolicy.fused()))
    runs = []
    for replicas in (1, 2):
        reqs = make_requests(eng.cfg, 4, seed=6)
        m = ClusterRouter(eng, replicas, 2).run(reqs, ledger=True)
        runs.append((reqs, m, merge_ledger_accums(
            st.accum for st in m["states"])))
    (r1, m1, a1), (r2, m2, a2) = runs
    for a, b in zip(r1, r2):
        assert a.image.tobytes() == b.image.tobytes(), a.rid
    for f in dataclasses.fields(a1):
        assert torch.equal(getattr(a1, f.name), getattr(a2, f.name)), f.name
    assert int(a1.nnz.sum()) > 0
    assert m1["energy"] == m2["energy"]
    assert m1["rounds"] == 2 * m2["rounds"]


@pytest.mark.requires_cuda
def test_router_main_runs_on_the_card_by_default(cuda, capsys):
    import json

    from repro_torch.launch import router
    assert router._main(["--check-identity", "--requests", "4", "--steps",
                         "2"]) == 0
    m = json.loads(capsys.readouterr().out)
    assert m["policies"]["kernels"]["backend"] == "cuda"
    assert m["ledger_bit_identical_across_replicas"] is True
    assert m["images_bit_identical_across_replicas"] is True


@pytest.mark.requires_cuda
def test_serve_diffusion_main_replicas_runs_on_the_card_by_default(cuda,
                                                                  capsys):
    """``serve_diffusion --replicas 2`` with a bank, an SLO and previews,
    on the card with no ``--device``: fused attention on the float FFN,
    9 / 9 / 0 launches per replica step (the warm-up's one included)."""
    import json
    import math

    from repro_torch.launch import serve_diffusion
    runtime.reset_launch_counts()
    serve_diffusion.main(["--smoke", "--replicas", "2", "--slots", "2",
                          "--requests", "3", "--steps", "2", "--ledger",
                          "--tiers", "ddim,steps=2", "ddim,steps=1",
                          "--slo-steps", "3", "--preview-every", "1"])
    head, _, body = capsys.readouterr().out.partition("\n")
    assert "device cuda" in head and "router replicas=2" in head
    m = json.loads(body)
    assert m["mode"] == "cluster_router" and m["events"]["finished"] == 3
    assert m["kernel_policy"]["backend"] == "cuda"
    assert m["kernel_policy"]["self_attention"] == "fused"   # auto
    assert m["kernel_policy"]["ffn"] == "reference"
    assert m["preview"]["decodes"] > 0 and m["slo"]["met"] == 3
    assert all(math.isfinite(e["mj_per_iter_with_ema"])
               for e in m["energy"]["per_policy"])
    steps = m["engine_steps"] + 1
    counts = runtime.launch_counts()
    assert counts["pssa_attention"] == 9 * steps
    assert counts["cross_attention_tips"] == 9 * steps
    assert counts.get("bitslice_matmul", 0) == 0


# (spec, launches per step): autotuned is fused() on the float FFN; the
# int8 spec overrides the reference preset, so no kernel launches and its
# DBSC products go to torch._int_mm
@pytest.mark.requires_cuda
@pytest.mark.parametrize("spec,per_step", [
    ("autotuned", {"pssa_attention": 9, "cross_attention_tips": 9,
                   "bitslice_matmul": 0}),
    ("ffn=dbsc,ffn_quant=int8", {"pssa_attention": 0,
                                 "cross_attention_tips": 0,
                                 "bitslice_matmul": 0})])
def test_serve_diffusion_main_compiled_specs_run_on_the_card(cuda, capsys,
                                                             monkeypatch,
                                                             spec,
                                                             per_step):
    import json

    from repro_torch.launch import serve_diffusion
    int8 = []
    real = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm",
                        lambda a, b: int8.append(a.device) or real(a, b))
    runtime.reset_launch_counts()
    serve_diffusion.main(["--smoke", "--continuous", "--slots", "2",
                          "--requests", "2", "--steps", "2", "--ledger",
                          "--kernels", spec])
    head, _, body = capsys.readouterr().out.partition("\n")
    assert "device cuda" in head
    m = json.loads(body)
    assert m["requests"] == 2
    assert m["kernel_policy"]["backend"] == "cuda"
    assert m["kernel_policy"]["tuned"] == (spec == "autotuned")
    assert m["kernel_policy"]["ffn_quant"] == (
        "model" if spec == "autotuned" else "int8")
    steps = m["engine_steps"] + 1
    counts = runtime.launch_counts()
    assert {k: counts.get(k, 0) for k in per_step} == {
        k: v * steps for k, v in per_step.items()}
    # 9 FFNs a step, 2 DBSC matmuls each, 2 products each
    assert len(int8) == (0 if spec == "autotuned" else 36 * steps)
    assert all(d.type == "cuda" for d in int8)


# ---------------------------------------------------------------------------
# The launch knobs (``kernels.autotune``) and the int8 route
# ---------------------------------------------------------------------------
def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _hold_candidates(op, geom, run):
    """Every candidate of ``op`` at ``geom`` gives the launch rule's bits
    (outputs and counters)."""
    from repro_torch.kernels import autotune
    want = run({name: None for name in autotune.OP_KNOBS[op]})
    cands = autotune._op_module(op).autotune_candidates(geom)
    assert len(cands) >= 1
    for blocks in cands:
        got = run(blocks)
        assert all(_same_bits(a, b) for a, b in zip(got, want)), blocks


# the main path's shapes: BK-SDM at res 64 / 32 / 16 (batch 1 under
# guidance: 2 rows x 8 heads), DiT-S/2 after its CFG tiling, a ragged Tq
@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,h,t,d,patch", [
    (2, 8, 4096, 40, 64), (2, 8, 1024, 80, 32), (2, 8, 256, 160, 16),
    (2, 6, 256, 64, 16), (1, 2, 100, 40, 4)])
def test_pssa_knob_candidates_equal_the_launch_rule(cuda, b, h, t, d,
                                                    patch):
    from repro_torch.kernels.pssa_attention.ops import pssa_attention
    g = torch.Generator(device=cuda).manual_seed(t + d)
    q, k, v = (torch.randn((b, h, t, d), generator=g, device=cuda)
               for _ in range(3))
    _hold_candidates("self_attention", (b, h, t, d, patch), lambda blk: (
        pssa_attention(q, k, v, THR, patch, bq=blk["attn_block_q"])))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,h,tq,d", [
    (2, 8, 4096, 40), (2, 8, 1024, 80), (2, 8, 256, 160), (2, 6, 256, 64),
    (1, 3, 100, 40)])
def test_cross_knob_candidates_equal_the_launch_rule(cuda, b, h, tq, d):
    from repro_torch.kernels.cross_attention_tips.ops import (
        cross_attention_cas)
    g = torch.Generator(device=cuda).manual_seed(tq + d)
    q = torch.randn((b, h, tq, d), generator=g, device=cuda)
    k, v = (torch.randn((b, h, 77, d), generator=g, device=cuda)
            for _ in range(2))
    _hold_candidates("cross_attention", (b, h, tq, d, 77), lambda blk: (
        cross_attention_cas(q, k, v, bq=blk["cross_block_q"])))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows,tk,patch", [(4096, 4096, 64), (70, 256, 16),
                                           (33, 64, 64)])
def test_bitmap_knob_candidates_equal_the_launch_rule(cuda, rows, tk, patch):
    from repro_torch.kernels.patch_bitmap.ops import patch_bitmap
    g = torch.Generator(device=cuda).manual_seed(rows)
    sas = torch.rand((rows, tk), generator=g, device=cuda) * 2 * THR
    _hold_candidates("bitmap", (rows, tk, patch), lambda blk: (
        patch_bitmap(sas, patch, THR, br=blk["bitmap_block_rows"])))


# (B, T, C, patch): the UNet's res 64 / 16 rows (W = patch * C = 20480),
# DiT's (W = 6144), a W that is no multiple of 4 (scalar loads)
@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,t,c,patch", [
    (2, 4096, 320, 64), (2, 256, 1280, 16), (2, 256, 384, 16),
    (2, 63, 143, 7)])
def test_reuse_knob_candidates_equal_the_launch_rule(cuda, b, t, c, patch):
    from repro_torch.kernels.patch_reuse.ops import patch_delta
    g = torch.Generator(device=cuda).manual_seed(t + c)
    x = torch.randn((b, t, c), generator=g, device=cuda)
    x_ref = x + 1e-3 * torch.randn((b, t, c), generator=g, device=cuda)
    _hold_candidates("reuse", (b, t, c, patch), lambda blk: (
        patch_delta(x, x_ref, patch, 1e-3,
                    bp=blk["reuse_block_patches"])))


@pytest.mark.requires_cuda
def test_an_illegal_knob_raises(cuda):
    """In the wrappers (never clamped), and in the C entry points, which
    refuse what the wrappers would have caught."""
    from repro_torch.kernels import build
    q = torch.zeros((2, 64, 96), device=cuda)
    kv = torch.zeros((2, 77, 96), device=cuda)
    for call in (
            lambda: pssa_attention_kernel(q, q, q, THR, 16, bq=128),
            lambda: pssa_attention_kernel(q, q, q, THR, 16, bq=0),
            lambda: cross_attention_tips_kernel(q, kv, kv, bq=32),
            lambda: patch_bitmap_kernel(torch.zeros((64, 64), device=cuda),
                                        16, THR, br=64),
            lambda: patch_delta_kernel(q, q, bp=3)):
        with pytest.raises(ValueError, match="expected None or one of"):
            call()
    out = torch.zeros((2, 64), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    err = build.library().launch_patch_delta(
        q.data_ptr(), q.data_ptr(), out.data_ptr(), 128, 96, 1, 3, stream)
    assert err != 0


# the six FFN products of BK-SDM at batch 1 under guidance (res 64 / 32 /
# 16, ff_geglu then ff_out)
FFN_SHAPES = [(8192, 320, 2560), (8192, 1280, 320), (2048, 640, 5120),
              (2048, 2560, 640), (512, 1280, 10240), (512, 5120, 1280)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,k,n", FFN_SHAPES)
def test_int8_route_equals_the_bitslice_kernel(cuda, m, k, n):
    from repro_torch.kernels.bitslice_matmul.ref import bitslice_matmul_int8
    hi, lo, w, prec = _bitslice_inputs(cuda, m, k, n, "random", "mixed")
    runtime.reset_launch_counts()
    got = bitslice_matmul_int8(hi, lo, w, prec)
    assert runtime.launch_counts().get("bitslice_matmul", 0) == 0
    assert torch.equal(got, bitslice_matmul_kernel(hi, lo, w, prec))


@pytest.mark.requires_cuda
def test_tune_smoke_geoms_writes_a_valid_table(cuda, tmp_path):
    from repro_torch.kernels import autotune
    table = autotune.tune(autotune.SMOKE_GEOMS, reps=1, verbose=False)
    path = autotune.save_table(table, str(tmp_path / "t.json"))
    autotune.clear_cache()
    loaded = autotune.load_table(path)
    assert len(loaded["entries"]) == sum(
        len(g) for g in autotune.SMOKE_GEOMS.values())
    for key, results in loaded["sweep"].items():
        assert key.startswith("cuda/")
        assert all(r["ms"] > 0 for r in results)
    assert loaded["generated_on"]["backend"] == "cuda"
    assert loaded["generated_on"]["device"]


@pytest.mark.requires_cuda
def test_smoke_autotuned_and_int8_bit_equal_on_card(cuda, tmp_path,
                                                    monkeypatch):
    """A table of the smallest launch of every geometry the smoke engine
    looks up (recorded from the dispatch layer): ``autotuned`` + DBSC gives
    the ``fused`` + DBSC image bit for bit and launches as many kernels;
    ``ffn_quant=int8`` gives it too, with no ``bitslice_matmul`` launch."""
    from repro_torch.kernels import autotune
    seen = set()
    real = autotune.lookup

    def spy(op, geom, **kw):
        seen.add((op, tuple(geom)))
        return real(op, geom, **kw)
    monkeypatch.setattr(autotune, "lookup", spy)
    slice_pol = dataclasses.replace(KernelPolicy.fused(), ffn="dbsc")
    tuned_pol = dataclasses.replace(slice_pol, tuned=True)
    base = DiffusionEngine(_guided_smoke(slice_pol))
    params = {"text": base.text_params, "unet": base.unet_params,
              "vae": base.vae_params}
    toks = torch.zeros((1, base.cfg.text.max_len), dtype=torch.int32,
                       device=cuda)
    lat = base.init_latents(1, torch.Generator(device=cuda).manual_seed(1))

    def run(pol):
        runtime.reset_launch_counts()
        out = DiffusionEngine(_guided_smoke(pol), params=params).generate(
            toks, uncond_tokens=torch.zeros_like(toks), latents=lat.clone())
        return out.images, runtime.launch_counts()
    img, counts = run(slice_pol)
    run(tuned_pol)                                 # records the geometries
    assert {op for op, _ in seen} == {"self_attention", "cross_attention"}
    entries = {}
    for op, geom in seen:
        cands = autotune._op_module(op).autotune_candidates(geom)
        entries[autotune.make_key("cuda", op, geom)] = cands[0]
    path = tmp_path / "table.json"
    path.write_text(json.dumps({"version": autotune.AUTOTUNE_VERSION,
                                "entries": entries}))
    monkeypatch.setattr(autotune, "DEFAULT_TABLE_PATH", str(path))
    autotune.clear_cache()
    img_t, counts_t = run(tuned_pol)
    assert torch.equal(img_t, img) and counts_t == counts
    img_8, counts_8 = run(dataclasses.replace(slice_pol, ffn_quant="int8"))
    assert torch.equal(img_8, img)
    assert counts_8.get("bitslice_matmul", 0) == 0
    autotune.clear_cache()
