"""The port's train step against the JAX package's, on the CPU, at smoke
widths: two steps of ``make_train_step`` from the same state, plain, with
int8 gradient compression and with two microbatches, for one
architecture of each family, and one step from a JAX state taken mid-run
(``convert_train_state``).

Both packages start from the JAX-initialised state and take the same
numpy batches; the JAX step runs under ``jax.jit``.  The steps run in
float32 with PSSA and TIPS off: a TIPS code or a PSSA key on its threshold
flips on float32 sum order, which ``tests/test_torch_train_loss.py``
bounds for the gradients.

Bounds (each with its reason):

* loss, nll, aux: 1e-5 relative (float32 sum order; 6e-7 measured);
  ``grad_norm``: 1e-4 relative;
* the moments, plain and microbatched: 1e-4 of each leaf's largest value
  without an SSM (5.6e-5 measured after two steps), one bf16 ulp (2^-8)
  with one (1.4e-3 measured; the SSD scan's bf16 cotangents, see
  ``test_torch_train_loss.GRAD_SSM_RTOL``);
* the parameters: within ``PARAM_LR_SHARE`` (1e-2) of the learning rate
  on all but 1 % of the model's elements, and within 2 lr a step
  everywhere.  Adam divides each moment by its own root mean square, so
  a relative moment difference e moves an element by about e lr (up to
  2^-8 with an SSM: 6.3e-3 lr measured), and an element whose gradient
  lies within float32 noise of zero steps by about +-lr on either side
  of it (up to 1.3 lr measured, on under 0.5 % of the elements);
* compressed: an int8 code on a rounding boundary flips on float32 noise,
  moving that element by one step of its leaf's scale (amax / 127).  The
  first moment then stays within 1.5 / 127 of its leaf's largest value
  (7.9e-3 measured), the second within 2.5 / 127 (1.1e-2).  Before each
  step, the codes that each package would put on the wire (its own
  gradients plus its own residual, through its own ``compress_gradients``)
  differ on at most ``CODE_FLIP_SHARE`` (1e-3) of the elements (1.2e-4
  measured), there by at most one step for each step taken so far (a
  flipped code leaves a residual one step apart, which the next step
  carries in; 2 measured at step 2), and the scales agree within the
  loss bound (the moment bound with an SSM; 3.5e-5 measured).  The port's
  step then leaves exactly the residual its own round trip gives: bit
  for bit, so a step that dropped or negated the error feedback fails.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import get_arch
from repro_torch.convert import convert_train_state
from repro_torch.optim import (AdamW, AdamWState, compress_gradients,
                               linear_warmup_cosine)
from repro_torch.train.trainer import _value_and_grad, make_train_step

pytestmark = pytest.mark.filterwarnings(
    "ignore:jax.experimental.shard_map is deprecated:DeprecationWarning")

LR = 1e-3
METRIC_RTOL = 1e-5
GNORM_RTOL = 1e-4
CODE_FLIP_SHARE = 1e-3
MOMENT_RTOL = 1e-4
MOMENT_SSM_RTOL = 2.0 ** -8
PARAM_LR_SHARE = 1e-2
ARCHS = ["llama3-8b", "qwen2-moe-a2.7b", "mamba2-130m", "hymba-1.5b",
         "musicgen-large"]
FEATURES_OFF = {"tips": False, "pssa": False, "dtype": "float32"}


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
    from repro.optim import AdamW as jax_adamw
    from repro.optim import compress_gradients as jax_compress
    from repro.optim import linear_warmup_cosine as jax_lwc
    from repro.train.trainer import make_train_step as jax_mts
    return types.SimpleNamespace(get_arch=jax_get_arch, T=jax_t,
                                 AdamW=jax_adamw, lwc=jax_lwc, mts=jax_mts,
                                 compress=jax_compress)


def _batches(cfg, n, b=4, t=32, seed=3):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = r.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
        bj = {"labels": jnp.asarray(labels)}
        bt = {"labels": torch.from_numpy(labels)}
        if cfg.embedding_input:
            e = r.standard_normal((b, t, cfg.d_model)).astype(np.float32)
            bj["embeds"], bt["embeds"] = jnp.asarray(e), torch.from_numpy(e)
        else:
            toks = r.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
            bj["tokens"], bt["tokens"] = (jnp.asarray(toks),
                                          torch.from_numpy(toks))
        out.append((bj, bt))
    return out


def _setup(J, arch, compression, m=1):
    jc = J.get_arch(arch).smoke().scaled(**FEATURES_OFF)
    pc = get_arch(arch).smoke().scaled(**FEATURES_OFF)
    jopt = J.AdamW(lr=J.lwc(LR, 1, 10))
    topt = AdamW(lr=linear_warmup_cosine(LR, 1, 10))
    jp = J.T.init_params(jax.random.PRNGKey(0), jc)
    res = (jax.tree.map(lambda p: jnp.zeros_like(p, jnp.float32), jp)
           if compression else jnp.zeros(()))
    jstate = (jp, jopt.init(jp), res)
    return (jc, pc, jax.jit(J.mts(jc, None, jopt, compression, m)),
            make_train_step(pc, topt, compression, m), jstate,
            convert_train_state(jax.device_get(jstate)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _hold_state(pc, tstate, jstate, steps, compression):
    tp, topt, tres = tstate
    jp, jopt, jres = jstate
    assert isinstance(topt, AdamWState) and int(topt.step) == steps
    ssm = pc.family in ("ssm", "hybrid")
    d = np.concatenate([np.abs(_np(a) - _np(ref)).ravel() for a, ref in zip(
        tree_util.leaves(tp), jax.tree.leaves(jp))])
    assert d.max() <= 2 * LR * steps * 1.01
    assert np.mean(d > PARAM_LR_SHARE * LR) <= 0.01
    for k, (tt, jt) in enumerate(((topt.m, jopt.m), (topt.v, jopt.v))):
        if compression:
            rtol = (1.5, 2.5)[k] / 127
        else:
            rtol = MOMENT_SSM_RTOL if ssm else MOMENT_RTOL
        for a, ref in zip(tree_util.leaves(tt), jax.tree.leaves(jt)):
            a, ref = _np(a), _np(ref)
            assert np.abs(a - ref).max() <= rtol * np.abs(ref).max() + 1e-30
    if not compression:
        assert tres.shape == () and float(tres) == 0.0


def _wire(J, jc, pc):
    """-> hold(jstate, tstate, bj, bt, steps_before): the int8 codes and
    scales that each package's next step puts on the wire, held against
    each other; returns the residual the port's step must leave."""
    jgrad = jax.jit(jax.grad(lambda p, b: J.T.loss_fn(p, b, jc, None)[0]))
    jcomp = jax.jit(J.compress)
    srtol = (MOMENT_SSM_RTOL if pc.family in ("ssm", "hybrid")
             else METRIC_RTOL)

    def hold(jstate, tstate, bj, bt, steps_before):
        qj, _ = jcomp(jgrad(jstate[0], bj), jstate[2])
        _, gt = _value_and_grad(tstate[0], bt, pc)
        qt, rt = compress_gradients(gt, tstate[2])
        lt, lj = tree_util.leaves(qt), jax.tree.leaves(qj)
        flips = []
        for ct, st, cj, sj in zip(lt[0::2], lt[1::2], lj[0::2], lj[1::2]):
            assert ct.dtype == torch.int8 and cj.dtype == jnp.int8
            assert abs(float(st) - float(sj)) <= srtol * float(sj)
            d = np.abs(ct.numpy().astype(np.int32)
                       - np.asarray(cj).astype(np.int32))
            assert d.max() <= steps_before + 1
            flips.append(d.ravel() > 0)
        assert np.mean(np.concatenate(flips)) <= CODE_FLIP_SHARE
        return rt

    return hold


def _hold_residual(tstate, rt):
    for a, b in zip(tree_util.leaves(tstate[2]), tree_util.leaves(rt)):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def _hold_metrics(mt, mj):
    assert set(mt) == {"loss", "nll", "aux", "grad_norm"} == set(mj)
    for k in ("loss", "nll", "aux"):
        assert abs(float(mt[k]) - float(mj[k])) <= METRIC_RTOL * abs(
            float(mj[k])) + 1e-30, k
    assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) \
        <= GNORM_RTOL * float(mj["grad_norm"])


@pytest.mark.parametrize("mode", ["plain", "compressed", "microbatches"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_match_jax(J, arch, mode):
    compression, m = mode == "compressed", 2 if mode == "microbatches" else 1
    jc, pc, fj, ft, jstate, tstate = _setup(J, arch, compression, m)
    wire = _wire(J, jc, pc) if compression else None
    for i, (bj, bt) in enumerate(_batches(jc, 2)):
        rt = wire(jstate, tstate, bj, bt, i) if compression else None
        jstate, mj = fj(jstate, bj)
        tstate, mt = ft(tstate, bt)
        if compression:
            _hold_residual(tstate, rt)
        _hold_metrics(mt, mj)
        if m > 1:
            assert float(mt["aux"]) == 0.0
        _hold_state(pc, tstate, jstate, i + 1, compression)


def test_step_from_a_mid_run_jax_state(J):
    """Two JAX steps (compressed, so the residual is a tree), the state
    carried across by ``convert_train_state``, then one step in each
    package from it."""
    jc, pc, fj, ft, jstate, _ = _setup(J, "qwen2-moe-a2.7b", True)
    batches = _batches(jc, 3, seed=9)
    for bj, _ in batches[:2]:
        jstate, _ = fj(jstate, bj)
    tstate = convert_train_state(jax.device_get(jstate))
    assert int(tstate[1].step) == 2
    assert tstate[1].step.dtype == torch.int32
    for a, ref in zip(tree_util.leaves(tstate), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_np(a), _np(ref))
    bj, bt = batches[2]
    rt = _wire(J, jc, pc)(jstate, tstate, bj, bt, 0)
    jstate, mj = fj(jstate, bj)
    tstate, mt = ft(tstate, bt)
    _hold_residual(tstate, rt)
    _hold_metrics(mt, mj)
    _hold_state(pc, tstate, jstate, 3, True)
