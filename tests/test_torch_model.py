"""Port parity: the smoke-size model (text encoder, one transformer block,
the UNet forward with fused CFG, the VAE decoder) of ``repro_torch``
against the JAX package, on converted JAX weights.

JAX runs under ``jax.jit`` (as its engine does), Pallas kernels in
interpret mode.  Tolerances:
* PSSA counters / float32 ``PSSAStats`` and TIPS importance masks: exact;
* float activations: rtol 1e-4, atol 1e-5 — float32 with another
  summation order, a few layers deep;
* where the two sides' arithmetic differs upstream of a quantizer — the
  DBSC route, or the JAX blocked online softmax feeding the TIPS
  fake-quant of the float FFN through a whole UNet — atol 2e-3: an INT12
  or INT6 code sitting on a rounding boundary can flip on an ulp of
  difference, which moves that activation by one quantization step (the
  integer datapath itself is exact, see test_torch_kernels.py);
* sinusoidal time embedding: atol 2e-4 — angles up to 960 rad, where one
  float32 ulp of a frequency (XLA folds the constant ``exp`` at compile
  time) moves the angle by ~6e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bk_sdm as j_bk
from repro.diffusion import sampler as j_sampler
from repro.diffusion import text_encoder as j_text
from repro.diffusion import unet as j_unet
from repro.diffusion import vae as j_vae
from repro.kernels.dispatch import KernelPolicy as JKP
from repro_torch.configs import bk_sdm as t_bk
from repro_torch.convert import convert_tree
from repro_torch.diffusion import sampler as t_sampler
from repro_torch.diffusion import text_encoder as t_text
from repro_torch.diffusion import unet as t_unet
from repro_torch.diffusion import vae as t_vae
from repro_torch.kernels.dispatch import KernelPolicy as TKP

ROUTES = {
    "reference": (JKP(), TKP()),
    "fused": (JKP(self_attention="fused", cross_attention="fused",
                  interpret=True), TKP.fused()),
    "fused_dbsc": (JKP(self_attention="fused", cross_attention="fused",
                       ffn="dbsc", interpret=True),
                   TKP(self_attention="fused", cross_attention="fused",
                       ffn="dbsc")),
}
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def unet_params():
    jp = j_unet.init_unet_params(jax.random.PRNGKey(1), j_bk.SMOKE.unet)
    return jp, convert_tree(jax.device_get(jp))


def _t(x):
    return torch.from_numpy(np.array(x))


def _pssa_equal(sj, st):
    for f in sj._fields:
        assert (np.asarray(getattr(sj, f)).tobytes()
                == getattr(st, f).numpy().tobytes()), f


def _tips_equal(rj, rt):
    np.testing.assert_array_equal(np.asarray(rj.important),
                                  rt.important.numpy())
    assert (np.asarray(rj.low_precision_ratio).tobytes()
            == rt.low_precision_ratio.numpy().tobytes())


def test_encode_text_matches_jax():
    cfg = j_bk.SMOKE.text
    jp = j_text.init_text_encoder_params(jax.random.PRNGKey(2), cfg)
    tp = convert_tree(jax.device_get(jp))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    hj = jax.jit(lambda t: j_text.encode_text(jp, t, cfg))(
        jnp.asarray(toks, jnp.int32))
    ht = t_text.encode_text(tp, torch.from_numpy(toks), t_bk.SMOKE.text)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
def test_transformer_block_matches_jax(unet_params, route, dup):
    jp, tp = unet_params
    jpol, tpol = ROUTES[route]
    jcfg = dataclasses.replace(j_bk.SMOKE.unet, kernel_policy=jpol)
    tcfg = dataclasses.replace(t_bk.SMOKE.unet, kernel_policy=tpol)
    rng = np.random.default_rng(3)
    b = 1 if dup else 2
    x = rng.standard_normal((b, 16, 16, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    bj = jp["down"][0]["attns"][0]
    bt = tp["down"][0]["attns"][0]
    fn = jax.jit(functools.partial(j_unet._transformer_block, cfg=jcfg,
                                   stats_rows=1, dup_after_self=dup))
    oj, sj, rj, _ = fn(jnp.asarray(x), bj, jnp.asarray(ctx),
                       tips_active=jnp.asarray(True))
    ot, st, rt, _ = t_unet._transformer_block(_t(x), bt, _t(ctx), tcfg,
                                              True, stats_rows=1,
                                              dup_after_self=dup)
    assert ot.shape == (2, 16, 16, 32)
    _pssa_equal(sj, st)
    _tips_equal(rj, rt)
    if route == "fused_dbsc":
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                                   atol=2e-3)
    else:
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)


@pytest.mark.parametrize("route", ["reference", "fused"])
def test_unet_forward_cfg_dup_matches_jax(unet_params, route):
    jp, tp = unet_params
    jpol, tpol = ROUTES[route]
    jcfg = dataclasses.replace(j_bk.SMOKE.unet, kernel_policy=jpol)
    tcfg = dataclasses.replace(t_bk.SMOKE.unet, kernel_policy=tpol)
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    t = np.array([480], np.int32)
    fn = jax.jit(functools.partial(j_unet.unet_forward, cfg=jcfg,
                                   stats_rows=1, cfg_dup=True))
    ej, sj = fn(jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx),
                tips_active=jnp.asarray([True]))
    et, st = t_unet.unet_forward(tp, _t(lat), _t(t), _t(ctx), tcfg,
                                 tips_active=torch.tensor([True]),
                                 stats_rows=1, cfg_dup=True)
    assert et.shape == (2, 16, 16, 4)
    tol = TOL if route == "reference" else dict(rtol=0, atol=2e-3)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), **tol)
    assert [k.name for k in st.layers] == [k.name for k in sj.layers]
    for a, b in zip(sj.pssa, st.pssa):
        _pssa_equal(a, b)
    for a, b in zip(sj.tips, st.tips):
        _tips_equal(a, b)


def test_vae_decode_matches_jax():
    cfg = j_bk.SMOKE.vae
    jp = j_vae.init_vae_params(jax.random.PRNGKey(5), cfg)
    tp = convert_tree(jax.device_get(jp))
    lat = np.random.default_rng(6).standard_normal((1, 16, 16, 4)) \
        .astype(np.float32)
    ij = jax.jit(lambda l: j_vae.decode(jp, l, cfg))(jnp.asarray(lat))
    it = t_vae.decode(tp, _t(lat), t_bk.SMOKE.vae)
    assert it.shape == (1, 128, 128, 3)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), **TOL)


def test_upsample_and_schedule_match_jax():
    x = np.random.default_rng(7).standard_normal((2, 3, 5, 4)) \
        .astype(np.float32)
    up = jax.image.resize(jnp.asarray(x), (2, 6, 10, 4), "nearest")
    np.testing.assert_array_equal(np.asarray(up),
                                  t_unet.upsample_nearest2x(_t(x)).numpy())
    ddim = j_bk.CONFIG.ddim
    # XLA evaluates linspace/cumprod in another order: a few f32 ulps
    np.testing.assert_allclose(
        t_sampler.alphas_cumprod(t_bk.CONFIG.ddim).numpy(),
        np.asarray(j_sampler.alphas_cumprod(ddim)), rtol=2e-6, atol=1e-6)
    np.testing.assert_array_equal(
        t_sampler.timestep_schedule(t_bk.CONFIG.ddim).numpy(),
        np.asarray(j_sampler.timestep_schedule(ddim)))
    t = np.array([960, 480, 0], np.int32)
    np.testing.assert_allclose(
        t_unet.timestep_embedding(_t(t), 320).numpy(),
        np.asarray(j_unet.timestep_embedding(jnp.asarray(t), 320)),
        rtol=0, atol=2e-4)
