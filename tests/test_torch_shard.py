"""Port parity: tensor- and expert-parallel LMs on a (data, model) mesh.

Covers ``models.layers.ShardCtx``, the spec trees (``param_specs``,
``cache_specs``, ``moe_mode`` / ``moe_param_specs``,
``data.make_batch_specs``), the sharded forward / loss / prefill /
``decode_step``, ``make_train_step(ctx=)``, ``Trainer(ctx=)``'s
checkpoints, ``remat_save_collectives`` and ``launch.train --sharded``,
on the CPU at smoke widths.

The JAX package runs a sharded step as ONE GSPMD program; the port runs
one process a rank with explicit model-axis collectives.  Its ranks here
are gloo processes spawned once (``launch.mesh.spawn``, one intra-op
thread each) on a (2, 2) mesh; ``_rank_checks`` runs every sharded case
in that one group.  What is held, and how tightly:

* the spec trees equal the JAX package's as nested tuples, all ten
  architectures at tp 1, 2 and 16 (JAX imported inside a fixture);
* at degree 1 (a one-rank group, ``make_smoke_mesh()``) the sharded
  forward, train step and ``decode_step`` are bit for bit ``ctx=None``;
* (a) the sharded forward against the unsharded port on each rank's rows:
  with PSSA / TIPS off within ``REL_OFF`` (1e-4) of the largest logit;
  with them on, within the JAX package's own mean-relative bounds for its
  sharded forward (``tests/test_system.py``: 2e-2 dense / ssm, 5e-2 moe);
  a TIPS code or a PSSA key on its threshold flips on float32 sum order;
* (b) one DP x TP step against the unsharded step: the loss within
  ``STEP_RTOL`` (1e-5), the grad norm within ``GN_RTOL`` (1e-4; one bf16
  ulp, 2^-8, with an SSM, whose scan rounds its cotangents to bf16 as
  ``test_torch_train_step.py`` bounds them), the parameters within 2 lr
  everywhere and within 1e-2 lr on all but 1 % of the elements (Adam's
  first step moves an element by about +-lr, and one whose gradient is
  float32 noise away from zero may step either way).  Adam's step hides
  a gradient's scale, so the gradients are held leaf by leaf too: the
  sharded ``_value_and_grad`` averaged over the data group and gathered,
  against the data ranks' rows through the unsharded port, averaged,
  within ``LEAF_RTOL`` of each leaf's largest value (1e-5; 2^-8 where an
  SSM's bf16 cotangents reach the leaf: ~1e-6 and ~6e-4 measured).  The
  sharded moe aux is the JAX package's ``pmean`` over the data ranks of
  their own rows' aux, not the whole batch's, so the moe step with an
  aux and the gradient cases (aux coefficient 0.01) take that mean as
  the reference; the moe steps without one take the unsharded step.
  AdamW's clip norm of one gradient placed on the mesh is held to its
  unsharded norm within ``NORM_RTOL`` (1e-6; ~1e-7 measured), a bound
  that a Mamba-2 ``in_xbc``'s replicated B / C tail counted on both
  model ranks would exceed (the test checks that it would);
* the sharded forward of ``JAX_CASES`` against the JAX package's
  unsharded forward (jitted) on the same parameters, at ``REL_OFF``;
* (c) ``remat_save_collectives``: a dense layer's forward-plus-backward
  model-axis all-reduces read 6 without it and 4 with it when the
  recomputation replays the whole layer (JAX ``transformer.py``: 6 -> 4);
  with ``torch.utils.checkpoint``'s early stop (its default) the
  recomputation ends before the FFN's all-reduce, and the count without
  it reads 5; the gradients bit-equal throughout;
* (d) a checkpoint the ``Trainer`` wrote under the mesh loads unsharded
  to the gathered state bit for bit, and the next step from it matches
  the sharded next step at (b)'s bounds;
* (e) ``prefill`` and two ``decode_step`` under ``ctx`` against the
  unsharded ones at (a)'s bounds;
* (f) ZeRO-1 (``make_train_step(zero1=True)``: the moments split over the
  data group, the parameters all-gathered after the update) against the
  sharded step without it, bit for bit (the same gradients, an
  elementwise update on slices), and against the unsharded step at (b)'s
  bounds, its moments gathered within ``LEAF_RTOL`` + ``GN_RTOL`` of each
  leaf's largest value (a moment is the gradient times the clip scale,
  which carries the grad norm's error; twice that for the second);
* (g) the collective bytes and counts a dry-run cell's step
  (``launch.dryrun.step_callable``) records when it runs on this gloo
  group equal what ``dryrun._trace_cell`` records for the same cell on a
  fake (2, 2) group.
"""
import contextlib
import dataclasses
import os
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import ARCH_NAMES, SHAPES, ShapeConfig, get_arch
from repro_torch.data import SyntheticLMDataset, make_batch_specs
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import mesh as M
from repro_torch.launch import train as train_cli
from repro_torch.models import moe as MOE
from repro_torch.models import parallel as PAR
from repro_torch.models import transformer as T
from repro_torch.models.layers import ShardCtx
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import zero_gather, zero_slice
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.trainer import (_value_and_grad, make_train_step,
                                       state_layout, zero_plan)

pytestmark = pytest.mark.filterwarnings(
    "ignore:jax.experimental.shard_map is deprecated:DeprecationWarning")

REL_OFF = 1e-4
MEAN_REL_ON = {"dense": 2e-2, "ssm": 2e-2, "hybrid": 2e-2, "moe": 5e-2}
STEP_RTOL = 1e-5
GN_RTOL = {False: 1e-4, True: 2.0 ** -8}     # keyed by "has an SSM"
LEAF_RTOL = {False: 1e-5, True: 2.0 ** -8}   # keyed by "an SSM's backward
#                                              reaches the leaf"
ABOVE_THE_MIXERS = {("unembed",), ("final_norm",)}
NORM_RTOL = 1e-6
LR = 1e-3
PARAM_LR_SHARE = 1e-2
SPAWN_TIMEOUT_S = 240.0
JOIN_TIMEOUT_S = 300.0
BATCH, SEQ = 4, 16          # two rows a data rank at dp = 2


def _cfg(arch, **kw):
    """Smoke widths in float32; PSSA / TIPS off unless ``kw`` turns them
    on."""
    base = dict(dtype="float32", pssa=False, tips=False)
    base.update(kw)
    return get_arch(arch).smoke().scaled(**base)


# the sharded cases: name -> (arch, overrides)
CASES = {
    "dense_kv2": ("llama3-8b", {}),
    "dense_kv1": ("llama3-8b", {"num_kv_heads": 1}),
    "dense_v511": ("llama3-8b", {"vocab_size": 511}),
    "moe_ep": ("qwen2-moe-a2.7b", {}),
    "moe_tp": ("qwen2-moe-a2.7b", {"num_experts": 3}),
    "ssm": ("mamba2-130m", {}),
    "hybrid": ("hymba-1.5b", {}),
    "dense_on": ("llama3-8b", {"pssa": True, "tips": True}),
    "moe_on": ("qwen2-moe-a2.7b", {"pssa": True, "tips": True}),
    "ssm_on": ("mamba2-130m", {"pssa": True, "tips": True}),
    "hybrid_on": ("hymba-1.5b", {"pssa": True, "tips": True}),
}
# the step cases: name -> (forward case, aux_coef)
STEP_CASES = {"dense_kv2": ("dense_kv2", 0.01),
              "dense_v511": ("dense_v511", 0.01),
              "moe_ep": ("moe_ep", 0.0), "moe_tp": ("moe_tp", 0.0),
              "moe_ep_aux": ("moe_ep", 0.01),
              "ssm": ("ssm", 0.01), "hybrid": ("hybrid", 0.01)}
GRAD_CASES = ("dense_kv2", "dense_v511", "moe_ep", "moe_tp", "ssm",
              "hybrid")
JAX_CASES = ("moe_ep", "hybrid")
DECODE_CASES = ("dense_kv2", "dense_kv1", "moe_ep", "ssm", "hybrid")
ZERO_CASES = ("dense_kv2", "moe_ep", "ssm", "hybrid")
# dry-run cells on this group: name -> (arch, shape); the dense cells
# TP-fold (a small model, the batch divides the 4 ranks)
TRACE_CELLS = {
    "moe_train": ("qwen2-moe-a2.7b", ShapeConfig("smoke_train", SEQ, BATCH,
                                                 "train")),
    "dense_train": ("llama3-8b", ShapeConfig("smoke_train", SEQ, BATCH,
                                             "train")),
    "moe_decode": ("qwen2-moe-a2.7b", ShapeConfig("smoke_decode", SEQ,
                                                  BATCH, "decode")),
    "dense_prefill": ("llama3-8b", ShapeConfig("smoke_prefill", SEQ, BATCH,
                                               "prefill")),
}


def _case_cfg(case):
    arch, kw = CASES[case]
    return _cfg(arch, **kw)


def _params(cfg, seed=0):
    return T.init_params(torch.Generator().manual_seed(seed), cfg)


def _tokens(cfg, rows=BATCH, t=SEQ, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (rows, t), generator=g)


def _rows(x, ctx):
    n = x.shape[0] // ctx.dp_size
    return x[ctx.dp_rank * n:(ctx.dp_rank + 1) * n]


def _np(tree):
    return [a.detach().to(torch.float32).numpy()
            for a in tree_util.leaves(tree)]


def _paths(tree, prefix=()):
    """The key path of each leaf of ``tree``, in flatten order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k],
                                                         prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree) for q in _paths(v,
                                                               prefix + (i,))]
    return [prefix]


def _dataset(cfg):
    return SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                              global_batch=BATCH, seed=0,
                              embedding_input=cfg.embedding_input,
                              d_model=cfg.d_model)


def _row_group_grads(params, ds, cfg, ctx, aux_coef):
    """The unsharded (loss, gradients) a sharded step stands for: each data
    rank's rows of batch 0 through the unsharded port, averaged over the
    data ranks (so the moe aux is the JAX package's ``pmean`` of the
    ranks' own aux, and the capacity that of a rank's tokens)."""
    outs = [_value_and_grad(params, ds.batch_at(0, r, ctx.dp_size,
                                                device="cpu"), cfg, aux_coef)
            for r in range(ctx.dp_size)]
    n = len(outs)
    loss = sum(o[0][0] for o in outs) / n
    grads = tree_util.tree_map(lambda *g: sum(g) / n, *[o[1] for o in outs])
    return loss, grads


def _grad_case(cfg, ctx):
    """The sharded gradient (``_value_and_grad`` under ``ctx``, then the
    data average) gathered, against ``_row_group_grads`` leaf by leaf; and
    AdamW's global norm of that reference gradient cut by the layout
    against its unsharded norm, with the squares of the replicated tails
    (what a norm counting them on every rank would add once more)."""
    aux_coef = 0.01
    params = _params(cfg)
    ds = _dataset(cfg)
    _, ref = _row_group_grads(params, ds, cfg, ctx, aux_coef)
    local = T.shard_params(params, cfg, ctx)
    _, g = _value_and_grad(local, ds.rank_batch_at(0, ctx, device="cpu"),
                           cfg, aux_coef, ctx=ctx)
    got = T.gather_params(PAR.average_over_dp(g, ctx), cfg, ctx)
    opt = AdamW(lr=LR)
    splits = PAR.leaf_splits(params, T.param_layout(cfg, ctx.tp_size))
    ref_local = T.shard_params(ref, cfg, ctx)
    gn_ref = opt.update(ref, opt.init(params), params)[2]
    gn_got = opt.update(ref_local, opt.init(local), local, splits,
                        ctx.tp_group)[2]
    tail_sq = sum(float(torch.sum(torch.square(s.parts(a, ctx.tp_size)[1])))
                  for a, s in zip(tree_util.leaves(ref_local), splits)
                  if s is not None and s.head is not None)
    return dict(paths=_paths(params), ref=_np(ref), got=_np(got),
                gn_ref=float(gn_ref), gn_got=float(gn_got), tail_sq=tail_sq)


def _forward_case(cfg, ctx):
    params = _params(cfg)
    toks = _tokens(cfg)
    with torch.no_grad():
        ref, aux_ref, _ = T.forward(params, cfg, tokens=toks, remat=False)
        got, aux, _ = T.forward(T.shard_params(params, cfg, ctx), cfg,
                                tokens=_rows(toks, ctx), remat=False,
                                ctx=ctx)
        rows = T.forward(params, cfg, tokens=_rows(toks, ctx),
                         remat=False)[1]
    return dict(ref=_rows(ref, ctx).numpy(), got=got.numpy(),
                aux=float(aux), aux_ref=float(aux_ref), aux_rows=float(rows))


def _decode_case(cfg, ctx):
    """prefill of SEQ tokens, then two decode steps, sharded and not."""
    params = _params(cfg)
    toks = _tokens(cfg, t=SEQ + 2)
    mine = _rows(toks, ctx)
    local = T.shard_params(params, cfg, ctx)
    out = {}
    with torch.no_grad():
        for tag, p, tk, c in (("ref", params, toks, None),
                              ("got", local, mine, ctx)):
            lg, pc = T.prefill(p, cfg, tokens=tk[:, :SEQ], ctx=c)
            cache = T.decode_cache_from_prefill(cfg, pc, SEQ + 2, ctx=c)
            seq = [lg]
            for i in range(2):
                lg, cache = T.decode_step(p, cache, tk[:, SEQ + i:SEQ + i + 1],
                                          SEQ + i, cfg, ctx=c)
                seq.append(lg)
            out[tag] = torch.cat(seq, dim=1)
    out["ref"] = _rows(out["ref"], ctx)
    return {k: v.numpy() for k, v in out.items()}


def _step_case(cfg, ctx, aux_coef):
    """One unsharded and one sharded train step from the same state and
    batch; the sharded state gathered back.  A moe step with an aux is
    held to the data ranks' mean (``_row_group_grads``) stepped by the
    same AdamW."""
    opt = AdamW(lr=LR)
    params = _params(cfg)
    state = (params, opt.init(params), torch.zeros(()))
    ds = _dataset(cfg)
    layout = state_layout(cfg, ctx)
    if cfg.family == "moe" and aux_coef:
        loss, grads = _row_group_grads(params, ds, cfg, ctx, aux_coef)
        ref_params, _, gn = opt.update(grads, state[1], params)
        ref_m = {"loss": loss, "grad_norm": gn}
    else:
        ref_state, ref_m = make_train_step(cfg, opt, aux_coef=aux_coef)(
            state, ds.batch_at(0, device="cpu"))
        ref_params = ref_state[0]
    local = PAR.shard_tree(state, layout, ctx)
    got_state, got_m = make_train_step(cfg, opt, aux_coef=aux_coef,
                                       ctx=ctx)(
        local, ds.rank_batch_at(0, ctx, device="cpu"))
    got_full = PAR.gather_tree(got_state, layout, ctx)
    return dict(ref_params=_np(ref_params), got_params=_np(got_full[0]),
                ref_loss=float(ref_m["loss"]), got_loss=float(got_m["loss"]),
                ref_gn=float(ref_m["grad_norm"]),
                got_gn=float(got_m["grad_norm"]))


def _remat_case(ctx):
    """Model-axis all-reduces of one value_and_grad with remat, with and
    without remat_save_collectives and checkpoint's early stop, at 1 and
    2 layers (their difference: one layer's); the gradients."""
    import torch.utils.checkpoint as ckpt
    out = {}
    for save in (False, True):
        for early in (True, False):
            counts, grads = [], None
            for layers in (1, 2):
                cfg = _cfg("llama3-8b", num_layers=layers,
                           remat_save_collectives=save)
                params = T.shard_params(_params(cfg), cfg, ctx)
                ds = SyntheticLMDataset(vocab_size=cfg.vocab_size,
                                        seq_len=SEQ, global_batch=BATCH,
                                        seed=0)
                batch = ds.rank_batch_at(0, ctx, device="cpu")
                PAR.reset_collective_counts()
                with ckpt.set_checkpoint_early_stop(early):
                    _, g = _value_and_grad(params, batch, cfg, ctx=ctx)
                counts.append(PAR.collective_counts()["tp_all_reduce"])
                grads = _np(g)
            out[save, early] = dict(per_layer=counts[1] - counts[0],
                                    grads=grads)
    return out


def _ckpt_case(ctx, root):
    """Two Trainer steps under the mesh, a checkpoint at step 2; the
    gathered state, and the sharded third step's state gathered."""
    cfg = _cfg("qwen2-moe-a2.7b")
    opt = AdamW(lr=LR)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH, seed=0)
    tc = TrainConfig(steps=2, checkpoint_every=2, log_every=1,
                     checkpoint_dir=os.path.join(root, "ckpt"))
    tr = Trainer(cfg, ds, opt, tc, device="cpu", ctx=ctx)
    state, hist = tr.run(torch.Generator().manual_seed(0))
    full = PAR.gather_tree(state, tr.layout, ctx)
    nxt, _ = tr.step_fn(state, ds.rank_batch_at(2, ctx, device="cpu"))
    return dict(state=_np(full),
                next=_np(PAR.gather_tree(nxt, tr.layout, ctx)[0]),
                hist=hist)


def _zero_moments(state, zero):
    """This data rank's slices of whole moments (copies)."""
    def cut(tree):
        return tree_util.unflatten(tree, (
            zero_slice(a, d, zero).clone() for a, d in zip(
                tree_util.leaves(tree), zero.dims)))
    return state._replace(m=cut(state.m), v=cut(state.v))


def _zero_case(cfg, ctx):
    """One sharded step with and without ZeRO-1 from the same state and
    rows, and the unsharded step; the ZeRO moments gathered over the data
    group, then everything over the model axis."""
    opt = AdamW(lr=LR)
    params = _params(cfg)
    state = (params, opt.init(params), torch.zeros(()))
    ds = _dataset(cfg)
    layout = state_layout(cfg, ctx)
    local = PAR.shard_tree(state, layout, ctx)
    batch = ds.rank_batch_at(0, ctx, device="cpu")
    plain, m_plain = make_train_step(cfg, opt, ctx=ctx)(local, batch)
    zero = zero_plan(local[0], cfg, ctx)
    zstate = (local[0], _zero_moments(local[1], zero), local[2])
    got, m_got = make_train_step(cfg, opt, ctx=ctx, zero1=True)(zstate,
                                                                 batch)
    moments = got[1]._replace(m=zero_gather(got[1].m, zero),
                              v=zero_gather(got[1].v, zero))
    same = all(torch.equal(a, b) for a, b in zip(
        tree_util.leaves((plain[0], plain[1], m_plain)),
        tree_util.leaves((got[0], moments, m_got))))
    if cfg.family == "moe":     # the aux: the data ranks' mean (_step_case)
        loss, grads = _row_group_grads(params, ds, cfg, ctx, 0.01)
        ref_p, ref_o, gn = opt.update(grads, state[1], params)
        ref, m_ref = (ref_p, ref_o), {"loss": loss, "grad_norm": gn}
    else:
        ref, m_ref = make_train_step(cfg, opt)(
            state, ds.batch_at(0, device="cpu"))
    full = PAR.gather_tree((got[0], moments, got[2]), layout, ctx)
    return dict(same=same, split=sum(d is not None for d in zero.dims),
                whole=sum(d is None for d in zero.dims),
                slice_share=sum(a.numel() for a in tree_util.leaves(
                    got[1].m)) / sum(a.numel() for a in tree_util.leaves(
                        local[1].m)),
                ref_loss=float(m_ref["loss"]), got_loss=float(m_got["loss"]),
                ref_gn=float(m_ref["grad_norm"]),
                got_gn=float(m_got["grad_norm"]),
                ref_params=_np(ref[0]), got_params=_np(full[0]),
                paths=_paths(params), ref_m=_np(ref[1].m),
                got_m=_np(full[1].m), ref_v=_np(ref[1].v),
                got_v=_np(full[1].v))


def _cell_args(cfg, shape, mesh):
    """Zeros of the shapes a dry-run cell gives this rank (its tokens
    vocabulary index 0)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake, _ = DRY.input_specs(cfg, shape, mesh)
    return tree_util.tree_map(
        lambda a: torch.zeros(a.shape, dtype=a.dtype)
        if isinstance(a, torch.Tensor) else a, fake)


def _executed_records(mesh) -> dict:
    """Each ``TRACE_CELLS`` step run once on this group: what it issued."""
    out = {}
    for name, (arch, shape) in TRACE_CELLS.items():
        cfg = _cfg(arch)
        args = _cell_args(cfg, shape, mesh)
        step = DRY.step_callable(cfg, shape, mesh)
        PAR.reset_collective_counts()
        step(*args)
        out[name] = PAR.collective_bytes()
    return out


def _rank_checks(root):
    torch.manual_seed(0)
    mesh = M.make_elastic_mesh(2)
    ctx = ShardCtx(mesh=mesh, dp_axes=("data",))
    out = {"rank": dist.get_rank(), "shape": M.mesh_shape(mesh),
           "coords": (ctx.dp_rank, ctx.tp_rank, ctx.dp_size, ctx.tp_size)}
    out["forward"] = {k: _forward_case(_case_cfg(k), ctx) for k in CASES}
    fold = ShardCtx(mesh=mesh, dp_axes=("data", "model"), tp_axis=None)
    out["fold"] = _forward_case(_cfg("llama3-8b"), fold)
    out["fold_coords"] = (fold.dp_rank, fold.dp_size, fold.tp_size)
    out["step"] = {k: _step_case(_case_cfg(c), ctx, coef)
                   for k, (c, coef) in STEP_CASES.items()}
    out["grad"] = {k: _grad_case(_case_cfg(k), ctx) for k in GRAD_CASES}
    out["decode"] = {k: _decode_case(_case_cfg(k), ctx)
                     for k in DECODE_CASES}
    out["remat"] = _remat_case(ctx)
    out["ckpt"] = _ckpt_case(ctx, root)
    out["zero"] = {k: _zero_case(_case_cfg(k), ctx) for k in ZERO_CASES}
    out["executed"] = _executed_records(mesh)
    return out


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_mod():
    import jax
    import jax.numpy as jnp
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_arch as j_get_arch
    from repro.data import pipeline as j_pipeline
    from repro.models import moe as j_moe
    from repro.models import transformer as j_T
    return dict(jax=jax, jnp=jnp, SHAPES=J_SHAPES, get_arch=j_get_arch,
                pipeline=j_pipeline, moe=j_moe, T=j_T)


def _jax_logits(m, case):
    """The JAX package's unsharded forward, jitted, on ``case``'s
    parameters and tokens (the port's, converted)."""
    arch, kw = CASES[case]
    cfg = _case_cfg(case)
    jcfg = m["get_arch"](arch).smoke().scaled(
        **dict(dict(dtype="float32", pssa=False, tips=False), **kw))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [to_jax(v) for v in t]
        return m["jnp"].asarray(t.numpy())
    fwd = m["jax"].jit(lambda p, t: m["T"].forward(p, jcfg, None, tokens=t,
                                                   remat=False)[0])
    return np.asarray(fwd(to_jax(_params(cfg)),
                          m["jnp"].asarray(_tokens(cfg).numpy())))


def _background(fn, *args):
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:              # re-raised on join
            box["error"] = e
    th = threading.Thread(target=run)
    th.start()

    def join():
        th.join(timeout=JOIN_TIMEOUT_S)
        assert not th.is_alive(), f"{fn.__name__} not done in " \
            f"{JOIN_TIMEOUT_S} s"
        if "error" in box:
            raise box["error"]
        return box["out"]
    return join


CLI_ARGV = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--device", "cpu",
            "--steps", "2", "--batch", "4", "--seq", "16", "--sharded"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_mod):
    """The four-rank group, ``launch.train --sharded --mesh 2`` (a second
    group) and the JAX package's forward of ``JAX_CASES``, each on a
    thread of its own, with the CLI's one-rank run in this process beside
    them."""
    root = str(tmp_path_factory.mktemp("shard"))
    group = _background(M.spawn, _rank_checks, 4, (root,), "cpu",
                        SPAWN_TIMEOUT_S)
    cli2 = _background(train_cli.main, CLI_ARGV + [
        "--mesh", "2", "--ckpt-dir", os.path.join(root, "cli2")])
    jax_out = _background(lambda: {c: _jax_logits(jax_mod, c)
                                   for c in JAX_CASES})
    cli1 = train_cli.main(CLI_ARGV + ["--ckpt-dir",
                                      os.path.join(root, "cli1")])
    return dict(ranks=group(), cli=(cli1, cli2()), jax=jax_out(), root=root)


# ---------------------------------------------------------------------------
# Spec trees against the JAX package's
# ---------------------------------------------------------------------------
def _plain(tree):
    """Nested dicts / lists of plain tuples (a PartitionSpec of either
    package is a tuple)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_trees_match_jax(jax_mod, arch):
    cfg, jcfg = get_arch(arch), jax_mod["get_arch"](arch)
    for tp in (1, 2, 16):
        assert _plain(T.param_specs(cfg, tp)) == _plain(
            jax_mod["T"].param_specs(jcfg, tp)), tp
        for batch in (1, 128):
            assert _plain(T.cache_specs(cfg, batch, ("data",), tp)) == \
                _plain(jax_mod["T"].cache_specs(jcfg, batch, ("data",), tp))
        if cfg.family == "moe":
            assert MOE.moe_mode(cfg, tp) == jax_mod["moe"].moe_mode(jcfg, tp)
            assert _plain(MOE.moe_param_specs(cfg, tp)) == _plain(
                jax_mod["moe"].moe_param_specs(jcfg, tp))
    for name, shape in SHAPES.items():
        for dp in (("data",), ("pod", "data")):
            got = make_batch_specs(cfg, shape, dp)
            want = jax_mod["pipeline"].make_batch_specs(
                jcfg, jax_mod["SHAPES"][name], dp)
            assert sorted(got) == sorted(want)
            for k, (spec, p) in got.items():
                wspec, wp = want[k]
                assert spec.shape == tuple(wspec.shape), (name, k)
                assert str(spec.dtype).split(".")[-1] == str(wspec.dtype)
                assert tuple(p) == tuple(wp)


SSM_HEAD_LEAVES = ("in_dt", "A_log", "D", "dt_bias")


@pytest.mark.parametrize("tp", [1, 2, 3, 16])
def test_param_layout_covers_every_leaf(tp):
    """The executed layout has the spec tree's structure, each split
    divides its leaf and lies on the dimension the spec splits."""
    for arch in ARCH_NAMES:
        cfg = get_arch(arch).smoke()
        specs, layout = T.param_specs(cfg, tp), T.param_layout(cfg, tp)
        params = _params(cfg)

        def walk(s, lay, p, path):
            if isinstance(s, dict):
                assert set(p) == set(s), path
                assert lay is None or set(lay) == set(s), path
                for k in s:
                    walk(s[k], None if lay is None else lay[k], p[k],
                         path + (k,))
                return
            assert len(s) == p.ndim, (arch, path)
            if lay is not None:
                n = p.shape[lay.dim] if lay.head is None else lay.head
                assert n % tp == 0, (arch, path)
                # a split follows the spec's "model" dimension, but for
                # the Mamba-2 per-head vectors the spec replicates
                # (ssm.py's docstring)
                if path[-1] not in SSM_HEAD_LEAVES:
                    assert s[lay.dim] == "model", (arch, path, s, lay)
        walk(specs, layout, params, ())


# ---------------------------------------------------------------------------
# ShardCtx and degree 1 in this process
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _one_rank():
    with M.process_group(device="cpu"):
        yield ShardCtx(mesh=M.make_smoke_mesh(), dp_axes=("data",))


def test_shardctx_tp_substitution():
    with _one_rank() as ctx:
        mesh = ctx.mesh
        fold = ShardCtx(mesh=mesh, dp_axes=("data",), tp_axis=None)
        x = torch.zeros((4, 8))
        assert fold.cs(x, "data", "model") is x
        assert fold.spec("data", "model") == ("data", None)
        assert fold.tp_size == 1 and fold.tp_group is None
        assert ctx.tp_size == M.mesh_shape(mesh)["model"] == 1
        assert ctx.spec("data", "model") == ("data", "model")
        assert ctx.dp == "data" and ShardCtx(
            mesh=mesh, dp_axes=("data", "model"), tp_axis=None).dp == (
                "data", "model")
        with pytest.raises(ValueError, match="no mesh axis 'pod'"):
            ctx.cs(x, "pod", None)


DEGREE1 = ["llama3-8b", "qwen2-moe-a2.7b", "mamba2-130m", "hymba-1.5b"]


@pytest.mark.parametrize("arch", DEGREE1)
def test_degree1_bit_for_bit(arch):
    """bf16 smoke widths, PSSA / TIPS on: forward, one train step (remat
    and remat_save_collectives) and prefill + decode_step, ``ctx`` on the
    one-rank smoke mesh against ``ctx=None``."""
    cfg = get_arch(arch).smoke().scaled(remat_save_collectives=True)
    with _one_rank() as ctx:
        params = _params(cfg)
        toks = _tokens(cfg)
        with torch.no_grad():
            a = T.forward(params, cfg, tokens=toks, remat=False)[0]
            b = T.forward(T.shard_params(params, cfg, ctx), cfg,
                          tokens=toks, remat=False, ctx=ctx)[0]
        assert torch.equal(a, b)
        opt = AdamW(lr=LR)
        ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                global_batch=BATCH, seed=0)
        state = (params, opt.init(params), torch.zeros(()))
        batch = ds.batch_at(0, device="cpu")
        ref = make_train_step(cfg, opt)(state, batch)
        PAR.reset_collective_counts()
        got = make_train_step(cfg, opt, ctx=ctx)(
            state, ds.rank_batch_at(0, ctx, device="cpu"))
        counts = PAR.collective_counts()
        for x, y in zip(tree_util.leaves(ref), tree_util.leaves(got)):
            assert torch.equal(x, y)
        # identity collectives over the one rank, issued all the same: a
        # gradient average a leaf and the loss's data mean, at least
        assert counts["dp_all_reduce"] > len(tree_util.leaves(params))
        if cfg.family != "ssm":
            assert counts["tp_all_reduce"] > 0
        cache_a = T.decode_cache_from_prefill(
            cfg, T.prefill(params, cfg, tokens=toks)[1], SEQ + 1)
        cache_b = T.decode_cache_from_prefill(
            cfg, T.prefill(params, cfg, tokens=toks, ctx=ctx)[1], SEQ + 1,
            ctx=ctx)
        nxt = toks[:, :1]
        la = T.decode_step(params, cache_a, nxt, SEQ, cfg)[0]
        lb = T.decode_step(params, cache_b, nxt, SEQ, cfg, ctx=ctx)[0]
        assert torch.equal(la, lb)


# ---------------------------------------------------------------------------
# The four-rank group
# ---------------------------------------------------------------------------
def test_group_coordinates(runs):
    ranks = runs["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["shape"] == {"data": 2, "model": 2}
        assert r["fold_coords"] == (r["rank"], 4, 1)
    assert [r["coords"] for r in ranks] == [(0, 0, 2, 2), (0, 1, 2, 2),
                                            (1, 0, 2, 2), (1, 1, 2, 2)]


def _close(got, ref, case):
    if CASES.get(case, ("", {}))[1].get("pssa"):
        fam = _cfg(CASES[case][0]).family
        rel = np.abs(got - ref).mean() / (np.abs(ref).mean() + 1e-9)
        assert rel < MEAN_REL_ON[fam], (case, rel)
    else:
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel <= REL_OFF, (case, rel)


@pytest.mark.parametrize("case", list(CASES) + ["fold"])
def test_sharded_forward_matches_unsharded(runs, case):
    ranks = runs["ranks"]
    for r in ranks:
        out = r["fold"] if case == "fold" else r["forward"][case]
        assert out["got"].shape == out["ref"].shape
        _close(out["got"], out["ref"], case)
    if case.startswith("moe"):
        # the aux: the mean over the data ranks of their own rows' aux
        # (each data rank's two model ranks hold the same rows)
        outs = [r["forward"][case] for r in ranks]
        want = np.mean([o["aux_rows"] for o in outs])
        for o in outs:
            assert abs(o["aux"] - want) <= 1e-5 * abs(want), (o, want)
        assert abs(outs[0]["aux"] - outs[0]["aux_ref"]) > 1e-5


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_train_step_matches_unsharded(runs, case):
    ssm = _case_cfg(STEP_CASES[case][0]).family in ("ssm", "hybrid")
    for r in runs["ranks"]:
        out = r["step"][case]
        assert abs(out["got_loss"] - out["ref_loss"]) <= STEP_RTOL * abs(
            out["ref_loss"]), case
        assert abs(out["got_gn"] - out["ref_gn"]) <= GN_RTOL[ssm] * abs(
            out["ref_gn"]), case
        _params_close(out["got_params"], out["ref_params"])


@pytest.mark.parametrize("case", GRAD_CASES)
def test_sharded_gradients_match_unsharded(runs, case):
    """Each leaf's gathered gradient against the unsharded one, within its
    bound of the leaf's largest value: a gradient scaled by a missing or
    an extra all-reduce is off by a half or more.  The moe cases carry
    the aux (coefficient 0.01) through the expert split."""
    ssm = _case_cfg(case).family in ("ssm", "hybrid")
    for r in runs["ranks"]:
        out = r["grad"][case]
        for path, got, ref in zip(out["paths"], out["got"], out["ref"]):
            assert got.shape == ref.shape, path
            rtol = LEAF_RTOL[ssm and path not in ABOVE_THE_MIXERS]
            d = np.abs(got - ref).max()
            assert d <= rtol * np.abs(ref).max(), (case, path, d)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_global_norm_counts_each_part_once(runs, case):
    """AdamW's clip norm of one gradient, placed on the mesh, against its
    unsharded norm; with an SSM the bound is tight enough to see the
    replicated B / C tail counted on both model ranks."""
    for r in runs["ranks"]:
        out = r["grad"][case]
        gn = out["gn_ref"]
        assert abs(out["gn_got"] - gn) <= NORM_RTOL * gn, (case, out)
        if _case_cfg(case).family in ("ssm", "hybrid"):
            assert np.sqrt(gn * gn + out["tail_sq"]) - gn > \
                10 * NORM_RTOL * gn, (case, out["tail_sq"])


@pytest.mark.parametrize("case", JAX_CASES)
def test_sharded_forward_matches_jax(runs, case):
    """The sharded forward against the JAX package's unsharded forward on
    the same parameters and tokens, each rank on its rows."""
    want = runs["jax"][case]
    n = BATCH // 2
    for r in runs["ranks"]:
        dp_rank = r["coords"][0]
        got = r["forward"][case]["got"]
        ref = want[dp_rank * n:(dp_rank + 1) * n]
        assert got.shape == ref.shape
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel <= REL_OFF, (case, rel)


def _params_close(got, ref):
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, ref)])
    assert d.max() <= 2 * LR * (1 + 1e-3), d.max()
    assert (d > PARAM_LR_SHARE * LR).mean() <= 1e-2


@pytest.mark.parametrize("case", DECODE_CASES)
def test_sharded_prefill_decode_match(runs, case):
    for r in runs["ranks"]:
        out = r["decode"][case]
        assert out["got"].shape == out["ref"].shape == (
            BATCH // 2, 3, _case_cfg(case).vocab_size)
        _close(out["got"], out["ref"], case)


def test_remat_save_collectives_cuts_all_reduces(runs):
    for r in runs["ranks"]:
        got = {k: v["per_layer"] for k, v in r["remat"].items()}
        assert got == {(False, False): 6, (True, False): 4,
                       (False, True): 5, (True, True): 4}
        want = r["remat"][False, False]["grads"]
        for v in r["remat"].values():
            for a, b in zip(v["grads"], want):
                np.testing.assert_array_equal(a, b)


def test_checkpoint_saved_sharded_loads_unsharded(runs):
    ranks = runs["ranks"]
    want = ranks[0]["ckpt"]
    assert [h[0] for h in want["hist"]] == [1, 2]
    cfg = _cfg("qwen2-moe-a2.7b")
    opt = AdamW(lr=LR)
    params = _params(cfg, seed=5)
    like = (params, opt.init(params), torch.zeros(()))
    state, meta = load_checkpoint(os.path.join(runs["root"], "ckpt"), 2,
                                  like)
    assert meta["data_step"] == 2
    for a, b in zip(_np(state), want["state"]):
        np.testing.assert_array_equal(a, b)
    for r in ranks[1:]:
        for a, b in zip(r["ckpt"]["state"], want["state"]):
            np.testing.assert_array_equal(a, b)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                            global_batch=BATCH, seed=0)
    nxt, _ = make_train_step(cfg, opt)(state, ds.batch_at(2, device="cpu"))
    _params_close(want["next"], _np(nxt[0]))


def test_train_cli_sharded(runs):
    one, two = runs["cli"]
    assert [h[0] for h in one] == [1, 2] and [h[0] for h in two] == [1, 2]
    assert all(np.isfinite(h[1]) for h in one + two)
    assert abs(one[0][1] - two[0][1]) <= 1e-3 * abs(one[0][1])


def test_train_cli_mesh_needs_sharded(capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                        "--mesh", "2"])
    assert "--mesh counts the ranks of --sharded" in capsys.readouterr().err


@pytest.mark.parametrize("case", ZERO_CASES)
def test_zero1_step_matches_unsharded(runs, case):
    """(f): ZeRO-1 bit for bit against the sharded step without it, and
    the unsharded step's loss, grad norm, parameters and moments."""
    ssm = _case_cfg(case).family in ("ssm", "hybrid")
    for r in runs["ranks"]:
        out = r["zero"][case]
        assert out["same"], case
        # every stacked leaf splits over the two data ranks
        assert out["split"] > 0 and out["slice_share"] < 0.75, out
        assert abs(out["got_loss"] - out["ref_loss"]) <= STEP_RTOL * abs(
            out["ref_loss"]), case
        assert abs(out["got_gn"] - out["ref_gn"]) <= GN_RTOL[ssm] * abs(
            out["ref_gn"]), case
        _params_close(out["got_params"], out["ref_params"])
        for key, scale in (("m", 1.0), ("v", 2.0)):
            for path, got, ref in zip(out["paths"], out[f"got_{key}"],
                                      out[f"ref_{key}"]):
                assert got.shape == ref.shape, path
                # a moment is the clipped gradient: its leaf's bound plus
                # the grad norm's (the clip scale), twice that for v
                rtol = scale * (LEAF_RTOL[ssm and path not in
                                          ABOVE_THE_MIXERS] + GN_RTOL[ssm])
                d = np.abs(got - ref).max()
                assert d <= rtol * np.abs(ref).max(), (case, key, path, d)


@pytest.mark.parametrize("cell", TRACE_CELLS)
def test_executed_collectives_match_fake_trace(runs, cell):
    """(g): rank 0's step on the gloo group and every other rank's issue
    exactly the collectives ``_trace_cell`` records on a fake (2, 2)
    group of the same cell."""
    arch, shape = TRACE_CELLS[cell]
    with M.fake_process_group(4):
        mesh = M.make_elastic_mesh(2)
        assert M.mesh_shape(mesh) == {"data": 2, "model": 2}
        want = DRY._trace_cell(_cfg(arch), shape, mesh)["collective_bytes"]
    assert want["total"] > 0
    if shape.kind == "train":
        assert want["counts"]["all-gather"] > 0       # ZeRO-1's
    for r in runs["ranks"]:
        assert r["executed"][cell] == want, (cell, r["rank"])
