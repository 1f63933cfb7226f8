"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.  Tolerances: PSSA counters and
DBSC integers exact (these shapes hold no score within an ulp of the
threshold); attention outputs rtol 1e-4, atol 1e-5 and CAS atol 1e-6
(float32 in another summation order); the patch delta and the PSXU bitmap
bit for bit (a max and a compare need no order), NaN where NaN.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import bk_sdm
from repro_torch.diffusion.engine import DiffusionEngine
from repro_torch.kernels import runtime
from repro_torch.kernels.bitslice_matmul.kernel import bitslice_matmul_kernel
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

THR = 1.0 / 8192.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bh,t,d,patch", [(4, 256, 40, 16), (2, 48, 8, 16),
                                          (2, 128, 160, 64)])
def test_pssa_kernel_matches_plain(cuda, bh, t, d, patch):
    g = torch.Generator(device=cuda).manual_seed(t + d)
    q, k, v = (torch.randn((bh, t, d), generator=g, device=cuda)
               for _ in range(3))
    out, nnz, xr = pssa_attention_kernel(q, k, v, THR, patch)
    out_p, nnz_p, xr_p = pssa_attention_stats_ref(q, k, v, THR, patch)
    assert torch.equal(nnz, nnz_p) and torch.equal(xr, xr_p)
    torch.testing.assert_close(out, out_p, rtol=1e-4, atol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bh,tq,tk,d,patch", [(4, 32, 256, 40, 16),
                                              (2, 128, 1024, 80, 64)])
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
                                   (3, 7, 2050), (2, 5, 3)])
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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bh,tq,tk,d", [(4, 256, 77, 40), (2, 100, 7, 8)])
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
@pytest.mark.parametrize("dataflow", ["weight_stationary",
                                      "input_stationary"])
def test_bitslice_kernel_matches_plain(cuda, dataflow):
    g = torch.Generator(device=cuda).manual_seed(0)
    hi, lo = (torch.randint(0, 64, (100, 77), generator=g, device=cuda,
                            dtype=torch.int32) for _ in range(2))
    w = torch.randint(-128, 128, (77, 50), generator=g, device=cuda,
                      dtype=torch.int32)
    prec = torch.randint(0, 2, (100, 1), generator=g, device=cuda,
                         dtype=torch.int32)
    assert torch.equal(bitslice_matmul_kernel(hi, lo, w, prec, dataflow),
                       bitslice_matmul_ref(hi, lo, w, prec))


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
    cfg = bk_sdm.with_kernel_policy(bk_sdm.SMOKE, KernelPolicy.auto(cuda))
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
        if reuse.threshold == 0.0:
            assert torch.equal(out.latents, out_d.latents)
        for c in out.stats.reuse:
            assert bool((c.computed <= c.total).all())
            assert torch.equal(c.computed[0], c.total[0])
