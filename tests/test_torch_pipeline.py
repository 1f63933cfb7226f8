"""Port parity: the whole smoke slice with classifier-free guidance.

``repro_torch``'s ``DiffusionEngine.generate`` and
``StableDiffusionPipeline.generate`` against the JAX package's, on the
same tokens, the same explicit latents and converted JAX weights, at
guidance 7.5 with unconditional tokens (``PipelineConfig.smoke()`` sets
1.0, which would switch CFG and the ``cfg_dup`` prefix path off).  JAX
runs its Pallas kernels in interpret mode.  Tolerances:
* the energy-ledger summary (``total_ema_reduction``,
  ``mj_per_iter_with_ema`` and the rest): identical — it is built from
  integer PSSA counters and TIPS masks that must match exactly;
* latents and images on the reference route through the engine: atol
  1e-4 (float32 in another summation order, three steps deep, guidance
  7.5 amplifying the cond/uncond difference);
* images through the pipeline's two-call loop: atol 2e-3 — its
  ``alphas_cumprod`` is evaluated eagerly on the JAX side (an ulp off the
  port's), enough to flip a TIPS INT6 fake-quant code on a rounding
  boundary (one quantization step);
* latents and images on the fused + DBSC route: atol 2e-2 / 2e-3 — an
  INT12 code on a rounding boundary can flip on an ulp of upstream
  difference (one quantization step), and guidance 7.5 amplifies it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bk_sdm as j_bk
from repro.diffusion.engine import DiffusionEngine as JEngine
from repro.diffusion.pipeline import StableDiffusionPipeline as JPipeline
from repro.diffusion.pipeline import energy_report as j_report
from repro.kernels.dispatch import KernelPolicy as JKP
from repro_torch.configs import bk_sdm as t_bk
from repro_torch.convert import convert_params
from repro_torch.diffusion.engine import DiffusionEngine as TEngine
from repro_torch.diffusion.pipeline import StableDiffusionPipeline as TPipe
from repro_torch.diffusion.pipeline import energy_report as t_report
from repro_torch.kernels.dispatch import KernelPolicy as TKP

ROUTES = {
    "reference": (JKP(), TKP(), dict(lat=1e-4, img=1e-4)),
    "fused_dbsc": (JKP(self_attention="fused", cross_attention="fused",
                       ffn="dbsc", interpret=True),
                   TKP(self_attention="fused", cross_attention="fused",
                       ffn="dbsc"), dict(lat=2e-2, img=2e-3)),
}


def _cfg(bk, policy):
    cfg = bk.with_kernel_policy(bk.SMOKE, policy)
    return dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, guidance_scale=7.5))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 256, (1, 8)).astype(np.int32)
    toks[:, 0] = 0
    un = np.zeros_like(toks)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    return toks, un, lat


def _assert_reports_equal(rj, rt):
    sj, st = rj.summary(), rt.summary()
    assert sj == st, (sj, st)


@pytest.mark.parametrize("route", list(ROUTES))
def test_engine_generate_matches_jax(inputs, route):
    jpol, tpol, tol = ROUTES[route]
    jcfg, tcfg = _cfg(j_bk, jpol), _cfg(t_bk, tpol)
    toks, un, lat = inputs
    je = JEngine(jcfg, key=jax.random.PRNGKey(0))
    params = convert_params(*jax.device_get(
        (je.text_params, je.unet_params, je.vae_params)))
    te = TEngine(tcfg, device="cpu", params=params)
    jo = je.generate(jnp.asarray(toks), None, uncond_tokens=jnp.asarray(un),
                     latents=jnp.asarray(lat))
    to = te.generate(torch.from_numpy(toks), uncond_tokens=torch.from_numpy(un),
                     latents=torch.from_numpy(lat))
    assert to.images.shape == (1, 128, 128, 3)
    assert to.stats.num_steps == 3 and te.last_wall_s > 0
    np.testing.assert_allclose(to.latents.numpy(), np.asarray(jo.latents),
                               rtol=0, atol=tol["lat"])
    np.testing.assert_allclose(to.images.numpy(), np.asarray(jo.images),
                               rtol=0, atol=tol["img"])
    _assert_reports_equal(j_report(jcfg, jo.stats), t_report(tcfg, to.stats))


def test_pipeline_generate_matches_jax(inputs):
    jpol, tpol, _ = ROUTES["reference"]
    jcfg, tcfg = _cfg(j_bk, jpol), _cfg(t_bk, tpol)
    toks, un, _ = inputs
    key = jax.random.PRNGKey(3)
    jp = JPipeline(jcfg, key=jax.random.PRNGKey(1))
    params = convert_params(*jax.device_get(
        (jp.text_params, jp.unet_params, jp.vae_params)))
    tp = TPipe(tcfg, device="cpu", params=params)
    img_j, stats_j = jp.generate(jnp.asarray(toks), key,
                                 uncond_tokens=jnp.asarray(un))
    s = jcfg.unet.latent_size
    lat = np.array(jax.random.normal(key, (1, s, s, 4)))
    img_t, stats_t = tp.generate(torch.from_numpy(toks),
                                 uncond_tokens=torch.from_numpy(un),
                                 latents=torch.from_numpy(lat))
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=0,
                               atol=2e-3)
    assert len(stats_t) == 3
    _assert_reports_equal(j_report(jcfg, stats_j), t_report(tcfg, stats_t))


def test_engine_cfg_contract():
    te = TEngine(t_bk.SMOKE, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="guidance_scale == 1.0"):
        te.generate(toks, uncond_tokens=toks)
    cfg = _cfg(t_bk, TKP())
    with pytest.raises(ValueError, match="uncond_tokens is None"):
        TEngine(cfg, device="cpu").generate(toks)
