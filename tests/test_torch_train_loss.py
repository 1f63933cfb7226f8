"""The port's training objective against the JAX package, on the CPU, at
smoke widths: ``loss_fn`` and its gradients for one architecture of each
family, remat on and off, and the TIPS straight-through gradient.

JAX-initialised weights go through ``convert_lm_params``; the same numpy
tokens (or embeddings) and labels go through both packages; the JAX side
runs ``jax.value_and_grad(loss_fn)`` under ``jax.jit``.  The JAX LM
modules are imported inside a fixture under a filter for the deprecated
``jax.experimental.shard_map`` (as ``tests/test_torch_lm.py`` does).

Tolerances (each gradient leaf against the largest value of its JAX leaf;
each with its reason):

* the loss, nll and aux: 1e-5 relative (float32 sum order; 2.2e-7
  measured);
* ``GRAD_F32_RTOL`` 1e-5: float32 with PSSA and TIPS off, no SSM (1.9e-6
  measured: sum order only);
* ``GRAD_FEATURES_RTOL`` 1e-3 with PSSA and TIPS on, as
  ``test_torch_lm.FEATURES_RTOL``: a probability within an ulp of the PSSA
  threshold is dropped on one side only, which moves that score's
  gradient (6.2e-5 measured);
* ``GRAD_SSM_RTOL`` one bf16 ulp (2^-8) for the families with a Mamba-2
  mixer, features on or off: the chunked SSD scan rounds its scores, decay
  tile and inputs to bf16 in both packages, so the backward rounds their
  cotangents to bf16, and a cotangent on a rounding boundary rounds
  differently on float32 sum-order noise.  The dt path (``A_log``,
  ``dt_bias``, ``in_dt``) sums many such terms with cancellation: 3.0e-4
  measured at this batch, 1.4e-3 at batch 4;
* remat on against remat off in the port: bit for bit;
* the TIPS fake-quant: forward bit for bit against the jitted JAX value,
  gradient all ones (JAX's straight-through estimator) exactly.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import get_arch
from repro_torch.convert import convert_lm_params
from repro_torch.core import tips as t_tips
from repro_torch.models import transformer as T

pytestmark = pytest.mark.filterwarnings(
    "ignore:jax.experimental.shard_map is deprecated:DeprecationWarning")

LOSS_RTOL = 1e-5
GRAD_F32_RTOL = 1e-5
GRAD_FEATURES_RTOL = 1e-3
GRAD_SSM_RTOL = 2.0 ** -8

ARCHS = ["llama3-8b", "qwen2-moe-a2.7b", "mamba2-130m", "hymba-1.5b",
         "musicgen-large"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-width tensors gain nothing from intra-op threads, and the
    suite's workers share the cores: one thread a worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def J():
    from repro.configs import get_arch as jax_get_arch
    from repro.models import transformer as jax_t
    return types.SimpleNamespace(get_arch=jax_get_arch, T=jax_t)


def _batch(cfg, seed, b=2, t=32, dtype="float32"):
    """The same batch for both packages: (JAX dict, torch dict)."""
    r = np.random.default_rng(seed)
    labels = r.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    bj = {"labels": jnp.asarray(labels)}
    bt = {"labels": torch.from_numpy(labels)}
    if cfg.embedding_input:
        e = r.standard_normal((b, t, cfg.d_model)).astype(np.float32)
        bj["embeds"] = jnp.asarray(e).astype(jnp.dtype(dtype))
        bt["embeds"] = torch.from_numpy(e).to(getattr(torch, dtype))
    else:
        toks = r.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
        bj["tokens"] = jnp.asarray(toks)
        bt["tokens"] = torch.from_numpy(toks)
    return bj, bt


def _grads(tp, bt, cfg, remat=True):
    leaves = [p.detach().requires_grad_() for p in tree_util.leaves(tp)]
    loss, metrics = T.loss_fn(tree_util.unflatten(tp, leaves), bt, cfg,
                              remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _grad_rtol(cfg, features):
    if cfg.family in ("ssm", "hybrid"):
        return GRAD_SSM_RTOL
    return GRAD_FEATURES_RTOL if features else GRAD_F32_RTOL


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(J, arch, remat):
    """float32, PSSA and TIPS as configured (on): the loss, nll, aux and
    every gradient leaf against ``jax.value_and_grad(loss_fn)``."""
    jc = J.get_arch(arch).smoke().scaled(dtype="float32")
    pc = get_arch(arch).smoke().scaled(dtype="float32")
    jp = J.T.init_params(jax.random.PRNGKey(0), jc)
    tp = convert_lm_params(jax.device_get(jp))
    bj, bt = _batch(jc, 5)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, b: J.T.loss_fn(p, b, jc, None), has_aux=True))(jp, bj)
    lt, mt, gt = _grads(tp, bt, pc, remat=remat)
    for a, ref in ((lt, lj), (mt["nll"], mj["nll"]), (mt["aux"], mj["aux"])):
        assert abs(float(a) - float(ref)) <= LOSS_RTOL * abs(float(ref))
    if pc.family == "moe":
        assert float(mt["aux"]) > 0
    else:
        assert float(mt["aux"]) == 0.0
    assert float(lt) == pytest.approx(float(mt["nll"]) + 0.01
                                      * float(mt["aux"]), rel=1e-6)
    gjl = jax.tree.leaves(gj)
    assert len(gjl) == len(gt)
    rtol = _grad_rtol(pc, True)
    for i, (a, ref) in enumerate(zip(gt, gjl)):
        ref = np.asarray(ref)
        assert tuple(a.shape) == ref.shape and a.dtype == torch.float32
        scale = np.abs(ref).max()
        assert np.abs(a.numpy() - ref).max() <= rtol * scale + 1e-30, i


@pytest.mark.parametrize("arch", ["llama3-8b", "hymba-1.5b"])
def test_loss_and_grads_match_jax_features_off(J, arch):
    """float32, PSSA and TIPS off: the float32 bound where the family has
    no SSM (the bf16 one where it does)."""
    kw = {"tips": False, "pssa": False}
    jc = J.get_arch(arch).smoke().scaled(dtype="float32", **kw)
    pc = get_arch(arch).smoke().scaled(dtype="float32", **kw)
    jp = J.T.init_params(jax.random.PRNGKey(1), jc)
    tp = convert_lm_params(jax.device_get(jp))
    bj, bt = _batch(jc, 6)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p, b: J.T.loss_fn(p, b, jc, None), has_aux=True))(jp, bj)
    lt, _, gt = _grads(tp, bt, pc)
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    rtol = _grad_rtol(pc, False)
    for i, (a, ref) in enumerate(zip(gt, jax.tree.leaves(gj))):
        ref = np.asarray(ref)
        assert np.abs(a.numpy() - ref).max() <= rtol * np.abs(ref).max(), i


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b"])
def test_remat_changes_no_value(arch):
    """The port's remat recomputes each layer in the backward pass: the
    loss and every gradient bit for bit as without it (bf16, features
    on)."""
    cfg = get_arch(arch).smoke()
    params = T.init_params(torch.Generator().manual_seed(3), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(4))
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}
    l1, m1, g1 = _grads(params, batch, cfg, remat=True)
    l0, m0, g0 = _grads(params, batch, cfg, remat=False)
    assert torch.equal(l1, l0) and torch.equal(m1["aux"], m0["aux"])
    for a, b, p in zip(g1, g0, tree_util.leaves(params)):
        assert a.dtype == p.dtype and torch.equal(a, b)


def test_forward_returns_aux_and_prefill_drops_it():
    """``forward`` -> (logits, aux, cache); the moe aux is the sum over
    layers of each layer's load-balance loss, and ``prefill`` returns the
    logits and cache alone, equal to ``forward``'s."""
    cfg = get_arch("qwen2-moe-a2.7b").smoke().scaled(dtype="float32")
    params = T.init_params(torch.Generator().manual_seed(5), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        logits, aux, cache = T.forward(params, cfg, tokens=toks)
        assert cache is None and aux.dtype == torch.float32
        x = params["embed"][toks]
        pos = torch.arange(16)[None].expand(2, 16)
        per_layer = []
        for i in range(cfg.num_layers):
            x, a, _ = T._block_train(x, T._layer(params["layers"], i), cfg,
                                     pos)
            per_layer.append(a)
        assert all(float(a) > 0 for a in per_layer)
        assert torch.equal(aux, per_layer[0] + per_layer[1])
        lp, cp = T.prefill(params, cfg, tokens=toks)
        lf, _, cf = T.forward(params, cfg, tokens=toks, collect_cache=True,
                              last_logit_only=True)
        assert torch.equal(lp, lf)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_util.leaves(cp), tree_util.leaves(cf)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tips_straight_through_matches_jax(dtype):
    """``apply_precision_mask`` is a straight-through estimator: its
    forward value equals the jitted JAX value bit for bit, and its
    gradient equals ``jax.grad`` of the JAX function (all ones), where
    the port once gave zero on ~99 % of the entries."""
    from repro.core import tips as j_tips
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 8, 16)).astype(np.float32) * 3
    imp = r.random((2, 8)) < 0.5
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    yj = jax.jit(j_tips.apply_precision_mask)(xj, jnp.asarray(imp))
    gj = jax.jit(jax.grad(lambda a: jnp.sum(
        j_tips.apply_precision_mask(a, jnp.asarray(imp)).astype(
            jnp.float32))))(xj)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    yt = t_tips.apply_precision_mask(xt, torch.from_numpy(imp))
    (gt,) = torch.autograd.grad(yt.to(torch.float32).sum(), xt)
    np.testing.assert_array_equal(
        yt.detach().to(torch.float32).numpy(),
        np.asarray(yj.astype(jnp.float32)))
    assert not np.array_equal(yt.detach().to(torch.float32).numpy(),
                              x.astype(np.float32))   # it does quantize
    np.testing.assert_array_equal(gt.to(torch.float32).numpy(),
                                  np.asarray(gj.astype(jnp.float32)))
    assert bool((gt == 1).all())


def test_ssd_plain_route_trains_on_the_cpu():
    """On the CPU ``ssd_scan_fused`` (``use_ssd_kernel=True``) runs its
    plain recurrence, which has a gradient; only the kernel route, on the
    card, refuses one (``tests/test_torch_cuda.py``)."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_fused
    g = torch.Generator().manual_seed(8)
    x = torch.randn(1, 8, 2, 4, generator=g, requires_grad=True)
    dt = torch.rand(1, 8, 2, generator=g)
    A = -torch.rand(2, generator=g)
    B = torch.randn(1, 8, 3, generator=g)
    C = torch.randn(1, 8, 3, generator=g)
    y, _ = ssd_scan_fused(x, dt, A, B, C, chunk=4)
    (gx,) = torch.autograd.grad(y.sum(), x)
    assert bool(torch.isfinite(gx).all()) and bool((gx != 0).any())
