"""The port's training infrastructure against the JAX package, on the CPU:
AdamW and its schedules, int8 gradient compression, the data pipeline,
the checkpoint store and the model-FLOP accounting.

The JAX side runs jitted where it computes (``jax.jit``), since the JAX
trainer's step is jitted.  Bounds (each with its reason):

* the schedules, steps 0 to 40: within 2 float32 ulps of the base rate
  (``SCHED_RTOL``).  The port folds the constants as XLA does inside
  ``jit`` (the warm-up bit for bit), but XLA's CPU backend fuses the
  cosine's ``a * 0.45 + 0.1`` into one FMA where torch rounds twice, and
  its ``cos`` may differ by an ulp, which ``1 + cos`` magnifies near the
  end of the schedule (2.5e-8 of the base rate measured);
* AdamW over 40 steps on the same gradients: parameters and moments
  within ``ADAMW_RTOL`` (1e-5) of each leaf's largest value, the global
  norm within 1e-6 (the same FMA contractions in the moment updates, and
  the global norm's float32 sum order; the learning rate's ulp); a bf16
  parameter within one bf16 ulp of its leaf's largest value (a float32 ulp
  before the cast can move its rounding);
* compression: the int8 codes, the scales and the dequantized gradients
  bit for bit (XLA keeps ``x / scale`` a division and folds ``amax /
  127`` into ``amax * float32(1 / 127)``, as the port does); the residual
  ``x - q * scale`` within ``RESIDUAL_ULPS`` float32 ulps of the leaf's
  amax (XLA's CPU backend computes it as one FMA, torch rounds the
  product first);
* the data pipeline, the checkpoint store and the FLOP counts: equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
from repro_torch.convert import convert_lm_params
from repro_torch.data import DataState, SyntheticLMDataset, shard_assignment
from repro_torch.launch import model_flops as t_mf
from repro_torch.models import transformer as T
from repro_torch.optim import (AdamW, AdamWState, compress_gradients,
                               cosine_schedule, decompress_gradients,
                               error_feedback_update, linear_warmup_cosine)

pytestmark = pytest.mark.filterwarnings(
    "ignore:jax.experimental.shard_map is deprecated:DeprecationWarning")

SCHED_RTOL = 2.0 ** -22
ADAMW_RTOL = 1e-5
RESIDUAL_ULPS = 2


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ----------------------------------------------------------------------------
# Schedules and AdamW
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("make", [
    ("cosine_schedule", (3e-4, 37)),
    ("cosine_schedule", (1e-3, 40, 0.05)),
    ("linear_warmup_cosine", (3e-4, 5, 40)),
    ("linear_warmup_cosine", (1e-3, 7, 33, 0.2)),
    ("linear_warmup_cosine", (3e-4, 1, 4))])
def test_schedules_match_jitted_jax(make):
    from repro.optim import schedules as j_sched
    name, args = make
    fj = jax.jit(getattr(j_sched, name)(*args))
    ft = {"cosine_schedule": cosine_schedule,
          "linear_warmup_cosine": linear_warmup_cosine}[name](*args)
    for s in range(41):
        ref = float(fj(jnp.asarray(s, jnp.int32)))
        got = ft(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - ref) <= SCHED_RTOL * args[0], s
        if name == "linear_warmup_cosine" and s <= args[1]:
            assert float(got) == ref, s              # the warm-up exactly


@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_matches_jitted_jax_for_40_steps(weight_decay):
    """The same gradients each step (large ones, so that the clip acts on
    some steps) through both optimisers, with a warm-up + cosine schedule
    and a bf16 leaf."""
    from repro.optim import AdamW as JAdamW
    from repro.optim import linear_warmup_cosine as j_lwc
    r = np.random.default_rng(0)
    params = {"w": r.standard_normal((6, 5)).astype(np.float32),
              "blk": {"b": r.standard_normal((5,)).astype(np.float32),
                      "a": r.standard_normal((3, 4)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    jp["blk"]["a"] = jp["blk"]["a"].astype(jnp.bfloat16)
    tp = convert_lm_params(jax.device_get(jp))
    jopt = JAdamW(lr=j_lwc(1e-2, 5, 40), weight_decay=weight_decay)
    topt = AdamW(lr=linear_warmup_cosine(1e-2, 5, 40),
                 weight_decay=weight_decay)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    assert isinstance(tstate, AdamWState)
    assert all(a.dtype == torch.float32 for a in tree_util.leaves(tstate.m))
    upd = jax.jit(jopt.update)
    clipped = 0
    for step in range(41):
        g = jax.tree.map(lambda p: np.asarray(
            r.standard_normal(p.shape) * (0.1 if step % 3 else 2.0),
            np.float32), params)
        gj = jax.tree.map(jnp.asarray, g)
        gt = convert_lm_params(g)
        jp, jstate, nj = upd(gj, jstate, jp)
        tp, tstate, nt = topt.update(gt, tstate, tp)
        clipped += float(nj) > 1.0
        assert abs(float(nt) - float(nj)) <= 1e-6 * float(nj)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for tt, jt in ((tp, jp), (tstate.m, jstate.m), (tstate.v, jstate.v)):
            for a, ref in zip(tree_util.leaves(tt), jax.tree.leaves(jt)):
                bf16 = ref.dtype == jnp.bfloat16
                assert a.dtype == (torch.bfloat16 if bf16 else torch.float32)
                rtol = 2.0 ** -8 if bf16 else ADAMW_RTOL
                a, ref = _np(a), _np(ref)
                assert np.abs(a - ref).max() <= rtol * np.abs(ref).max(), step
    assert 0 < clipped < 41


def test_adamw_is_functional():
    """``update`` returns new trees and leaves its arguments as they
    were."""
    p = {"w": torch.ones(3), "v": {"x": torch.full((2,), 2.0)}}
    opt = AdamW(lr=0.1)
    st = opt.init(p)
    before = [a.clone() for a in tree_util.leaves((p, st))]
    g = {"w": torch.full((3,), 0.5), "v": {"x": torch.full((2,), -1.0)}}
    p2, st2, _ = opt.update(g, st, p)
    for a, b in zip(tree_util.leaves((p, st)), before):
        assert torch.equal(a, b)
    assert not torch.equal(p2["w"], p["w"]) and int(st2.step) == 1


def test_adamw_decreases_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.5


# ----------------------------------------------------------------------------
# Gradient compression
# ----------------------------------------------------------------------------
def _grad_tree(r):
    return {"a": (r.standard_normal((40, 7)) * 3e-3).astype(np.float32),
            "b": {"c": (r.standard_normal((13,)) * 50).astype(np.float32),
                  "z": np.zeros((4,), np.float32)}}


def test_compression_matches_jitted_jax():
    """The int8 wire format over three error-feedback rounds, each round
    from the same gradients and residual in both packages: the codes and
    scales bit for bit (values on the half-step boundaries of the grid
    included), the dequantized gradients bit for bit, and the residual
    within ``RESIDUAL_ULPS``."""
    from repro.optim import compression as j_comp
    r = np.random.default_rng(1)
    jres = None
    for rnd in range(3):
        g = _grad_tree(r)
        if rnd == 2:       # values on the half-step boundaries of the grid
            s = np.float32(np.float32(np.abs(g["a"]).max())
                           * np.float32(1 / 127.0))
            g["a"][0, :5] = (np.arange(5) + 0.5).astype(np.float32) * s
        tres = None if jres is None else convert_lm_params(
            jax.device_get(jres))
        qj, jres = jax.jit(j_comp.compress_gradients)(
            jax.tree.map(jnp.asarray, g), jres)
        qt, tres = compress_gradients(convert_lm_params(g), tres)
        pairs = list(zip([qt["a"], qt["b"]["c"], qt["b"]["z"]],
                         [qj["a"], qj["b"]["c"], qj["b"]["z"]]))
        for (cq, cs), (jq, js) in pairs:
            assert cq.dtype == torch.int8 and cs.dtype == torch.float32
            np.testing.assert_array_equal(cq.numpy(), np.asarray(jq))
            assert float(cs) == float(js)
        for a, ref, ((_, cs), _) in zip(tree_util.leaves(tres),
                                        jax.tree.leaves(jres), pairs):
            bound = RESIDUAL_ULPS * 2.0 ** -23 * 127 * float(cs)
            assert np.abs(a.numpy() - np.asarray(ref)).max() <= bound
        deq_j = jax.jit(j_comp.decompress_gradients)(qj)
        deq_t = decompress_gradients(qt)
        for a, ref in zip(tree_util.leaves(deq_t), jax.tree.leaves(deq_j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(ref))
    assert not qt["b"]["z"][0].any()


def test_error_feedback_carries_the_quantization_error():
    """deq + new residual == grad + old residual (to float32 rounding),
    and an all-zero leaf stays zero."""
    r = np.random.default_rng(2)
    g = convert_lm_params(_grad_tree(r))
    res = tree_util.tree_map(lambda a: torch.randn(a.shape) * 1e-4, g)
    deq, new = error_feedback_update(g, res)
    for a, b, c, d in zip(*(tree_util.leaves(t) for t in (deq, new, g, res))):
        torch.testing.assert_close(a + b, c + d, rtol=0, atol=1e-6
                                   * float((c + d).abs().max()) + 1e-12)
    z, _ = error_feedback_update({"z": torch.zeros(5)}, None)
    assert not z["z"].any()


# ----------------------------------------------------------------------------
# Data pipeline
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,host,num_hosts", [
    (0, 0, 0, 1), (7, 12, 1, 3), (3, 5, 2, 3), (123, 99, 0, 4)])
def test_batch_at_matches_jax(seed, step, host, num_hosts):
    from repro.data import SyntheticLMDataset as JDataset
    kw = dict(vocab_size=1000, seq_len=24, global_batch=10, seed=seed)
    bj = JDataset(**kw).batch_at(step, host, num_hosts)
    bt = SyntheticLMDataset(**kw).batch_at(step, host, num_hosts,
                                           device="cpu")
    assert set(bt) == {"tokens", "labels"}
    for k in bt:
        assert bt[k].dtype == torch.int32
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
    ekw = dict(kw, embedding_input=True, d_model=16)
    ej = JDataset(**ekw).batch_at(step, host, num_hosts)
    et = SyntheticLMDataset(**ekw).batch_at(step, host, num_hosts,
                                            device="cpu")
    assert set(et) == {"embeds", "labels"}
    assert et["embeds"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(et["embeds"]), _np(ej["embeds"]))
    np.testing.assert_array_equal(et["labels"].numpy(),
                                  np.asarray(ej["labels"]))


def test_data_pure_in_seed_step():
    ds = SyntheticLMDataset(vocab_size=100, seq_len=8, global_batch=4, seed=3)
    b1 = ds.batch_at(12, device="cpu")
    assert torch.equal(b1["tokens"], ds.batch_at(12, device="cpu")["tokens"])
    assert not torch.equal(b1["tokens"],
                           ds.batch_at(13, device="cpu")["tokens"])
    assert DataState(3, 12).advance(2) == DataState(3, 14)


def test_shard_assignment_partitions_exactly():
    from repro.data import shard_assignment as j_shard
    for gb, hosts in [(256, 7), (32, 32), (100, 9), (5, 8)]:
        rows = []
        for h in range(hosts):
            lo, hi = shard_assignment(gb, h, hosts)
            assert (lo, hi) == j_shard(gb, h, hosts)
            rows.extend(range(lo, hi))
        assert rows == list(range(gb))


def test_straggler_takeover_same_rows():
    """Any host regenerates another host's shard (pure in seed/step)."""
    ds = SyntheticLMDataset(vocab_size=100, seq_len=8, global_batch=8, seed=1)
    full = ds.batch_at(3, device="cpu")["tokens"]
    for h in range(4):
        part = ds.batch_at(3, host=h, num_hosts=4, device="cpu")["tokens"]
        lo, hi = shard_assignment(8, h, 4)
        assert torch.equal(part, full[lo:hi])


def test_batch_at_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    ds = SyntheticLMDataset(vocab_size=100, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.batch_at(0)


# ----------------------------------------------------------------------------
# Checkpoint store
# ----------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10.0),
            "b": {"c": torch.randn(3, 4).to(torch.bfloat16),
                  "i": torch.tensor(7, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 5, tree, meta={"x": 1})
    assert latest_step(str(tmp_path)) == 5
    out, meta = load_checkpoint(str(tmp_path), 5, tree)
    assert meta == {"x": 1}
    for a, b in zip(tree_util.leaves(out), tree_util.leaves(tree)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    tree = {"a": torch.arange(4.0)}
    save_checkpoint(str(tmp_path), 1, tree)
    # a crash mid-write: a .tmp dir without a manifest
    os.makedirs(tmp_path / "step_00000002.tmp-999")
    assert latest_step(str(tmp_path)) == 1
    save_checkpoint(str(tmp_path), 3, tree)
    assert not (tmp_path / "step_00000002.tmp-999").exists()
    assert latest_step(str(tmp_path)) == 3


def test_checkpoint_gc_keeps_last_3(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in range(1, 6):
        save_checkpoint(str(tmp_path), s, tree, keep=3)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4, 5]


def test_checkpoint_refuses_another_tree(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2),
                                           "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="leaf 0"):
        load_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)})


def test_jax_checkpoint_loads_into_the_port_and_back(tmp_path):
    """A bf16 params tree written by the JAX store loads through the
    port's ``load_checkpoint`` into ``convert_lm_params``'s tree bit for
    bit, with the same manifest; and the port's file loads into JAX."""
    import json

    from repro.checkpoint import load_checkpoint as j_load
    from repro.checkpoint import save_checkpoint as j_save
    from repro.configs import get_arch as j_get_arch
    from repro.models import transformer as j_t
    jc = j_get_arch("hymba-1.5b").smoke()
    jp = j_t.init_params(jax.random.PRNGKey(0), jc)
    j_save(str(tmp_path / "jax"), 4, jp, meta={"arch": jc.name})
    like = T.init_params(torch.Generator().manual_seed(1), get_arch(
        "hymba-1.5b").smoke())
    got, meta = load_checkpoint(str(tmp_path / "jax"), 4, like)
    assert meta == {"arch": jc.name}
    want = convert_lm_params(jax.device_get(jp))
    for a, b in zip(tree_util.leaves(got), tree_util.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    save_checkpoint(str(tmp_path / "port"), 4, got, meta={"arch": jc.name})
    mj = json.loads((tmp_path / "jax" / "step_00000004" /
                     "manifest.json").read_text())
    mt = json.loads((tmp_path / "port" / "step_00000004" /
                     "manifest.json").read_text())
    assert mj["leaves"] == mt["leaves"]
    back, _ = j_load(str(tmp_path / "port"), 4, jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_np(a), _np(b))


# ----------------------------------------------------------------------------
# Model FLOPs
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_count_matches_init_and_jax(arch):
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_arch as j_get_arch
    from repro.launch import model_flops as j_mf
    smoke = get_arch(arch).smoke()
    params = T.init_params(torch.Generator().manual_seed(0), smoke)
    assert t_mf.param_count(smoke) == sum(
        a.numel() for a in tree_util.leaves(params))
    full, jfull = get_arch(arch), j_get_arch(arch)
    for active in (False, True):
        assert t_mf.param_count(full, active) == j_mf.param_count(jfull,
                                                                  active)
    for name, shape in SHAPES.items():
        assert t_mf.model_flops(full, shape) == j_mf.model_flops(
            jfull, J_SHAPES[name])
        assert t_mf.model_bytes_decode(full, shape) == \
            j_mf.model_bytes_decode(jfull, J_SHAPES[name])
