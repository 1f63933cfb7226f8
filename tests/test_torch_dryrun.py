"""Port parity: the dry-run and the FLOP counter (``launch/dryrun.py``,
``launch/flops.py``) with ``configs.shape_applicable``,
``transformer.abstract_params`` / ``abstract_cache`` and
``launch.mesh.make_production_mesh`` / ``fake_process_group``, on the CPU.

Held against the JAX package (its modules imported inside a fixture):

* the pure functions bit-equal: ``shape_applicable`` (10 archs x 4
  shapes), ``choose_tp_fold`` (x 256 / 512 devices), ``pick_microbatches``
  on a grid, ``_extrapolate`` and the collective record's ``weighted`` /
  ``total`` / ``counts`` on the same inputs;
* ``abstract_params`` / ``abstract_cache`` leaf for leaf, shapes and
  dtypes, at the published geometry of all ten archs (meta tensors: no
  storage);
* ``flops_of_callable``: JAX's three unit cases, and ``forward`` /
  ``prefill`` / ``decode_step`` / the train step at smoke widths for one
  arch a family, exactly (at two SSD chunks for the SSM families; at one
  chunk the JAX count holds dots the port's autograd never runs, pinned
  by ``test_flops_one_chunk_gap``);
* ``input_specs``' spec trees against JAX's ``input_specs`` on 256 fake
  host devices (one subprocess, specs only, nothing compiled) for
  llama3-8b x train_4k (ZeRO-1), mamba2-130m x train_4k (TP-fold) and
  qwen2-moe x decode_32k;
* ``run_cell`` at smoke widths on a fake 16 x 16 group, one arch a family
  x train / prefill / decode (worker processes, one a family, beside the
  JAX runs), ``long_500k`` skipped for a full-attention arch, and the CLI
  at llama3-8b's full width.
"""
import concurrent.futures
import json
import math
import multiprocessing
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch, shape_applicable
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch.flops import flops_of_callable
from repro_torch.models import transformer as T
from repro_torch.models.parallel import COLLECTIVES, P, collective_summary
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import AdamWState
from repro_torch.train import make_train_step

pytestmark = pytest.mark.filterwarnings(
    "ignore:jax.experimental.shard_map is deprecated:DeprecationWarning")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FAMILY_ARCHS = {"dense": "llama3-8b", "moe": "qwen2-moe-a2.7b",
                "ssm": "mamba2-130m", "hybrid": "hymba-1.5b"}
CELL_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SPEC_CELLS = (("llama3-8b", "train_4k"), ("mamba2-130m", "train_4k"),
              ("qwen2-moe-a2.7b", "decode_32k"))
# FLOP parity geometry: batch 2, two SSD chunks (the chunk is 128) for
# the SSM families, one layer
FLOP_BATCH = 2
FLOP_SEQ = {"dense": 32, "moe": 32, "ssm": 256, "hybrid": 256}
# At one SSD chunk the state entering it is the constant zero state: the
# port's autograd computes no gradient through the chunk-state einsum
# (B over l, and the decay-times-x product under it) nor for the
# off-diagonal read-out's state operand, while JAX's scan transposition
# runs those dot_generals all the same: 2 x 16384 + 3 x 131072 FLOPs a
# layer at mamba2-130m's smoke widths, batch 2 x 32 tokens.
ONE_CHUNK_GAP = 2 * 16384 + 3 * 131072


# ---------------------------------------------------------------------------
# Background work: the JAX spec trees, the run_cell cells, the CLI
# ---------------------------------------------------------------------------
_SPEC_SCRIPT = r"""
import json, os, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
warnings.filterwarnings("ignore")
from repro.configs import SHAPES, get_arch
from repro.launch.dryrun import input_specs
from repro.launch.mesh import make_production_mesh

mesh = make_production_mesh()


def plain(t):
    if isinstance(t, dict):
        return {k: plain(v) for k, v in t.items()}
    if hasattr(t, "spec"):
        return [list(a) if isinstance(a, tuple) else a for a in t.spec]
    return [plain(v) for v in t]


out = {}
for arch, shape in %(cells)r:
    _, shardings = input_specs(get_arch(arch), SHAPES[shape], mesh)
    out[arch + "|" + shape] = plain(shardings)
print("SPECS " + json.dumps(out))
"""


def _cell_cfg(arch: str, shape: str):
    """Smoke widths, PSSA / TIPS off (fewer ops to trace); three layers
    for the decode cells, so the 1- and 2-layer extrapolation is held to
    a deeper trace."""
    kw = dict(pssa=False, tips=False)
    if shape == "decode_32k":
        kw["num_layers"] = 3
    return get_arch(arch).smoke().scaled(**kw)


def _family_cells(arch: str) -> dict:
    """One family's three cells, on a fake 16 x 16 group each (a worker
    process of its own: the default group is per process)."""
    torch.set_num_threads(1)
    return {s: D.run_cell(arch, s, False, verbose=False,
                          cfg=_cell_cfg(arch, s), device="cpu", force_m=1)
            for s in CELL_SHAPES}


def _cli(out: str) -> list:
    torch.set_num_threads(1)
    return D.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                   "--device", "cpu", "--out", out])


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The JAX spec subprocess and a pool running the cells and the CLI,
    started before the other tests of the module and joined by the tests
    that read them."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    spec = subprocess.Popen(
        [sys.executable, "-c", _SPEC_SCRIPT % {"cells": SPEC_CELLS}],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = str(tmp_path_factory.mktemp("dryrun_cli"))
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(FAMILY_ARCHS) + 1,
        mp_context=multiprocessing.get_context("spawn"))
    cells = {a: pool.submit(_family_cells, a) for a in FAMILY_ARCHS.values()}
    cli = pool.submit(_cli, out)
    box = {}

    def specs():
        if "specs" not in box:
            so, se = spec.communicate(timeout=600)
            line = [x for x in so.splitlines() if x.startswith("SPECS ")]
            assert line, so + se
            box["specs"] = json.loads(line[0][6:])
        return box["specs"]
    yield dict(specs=specs, cells=lambda a: cells[a].result(timeout=600),
               cli=lambda: cli.result(timeout=600), out=out)
    pool.shutdown(wait=True, cancel_futures=True)
    if spec.poll() is None:
        spec.kill()
        spec.communicate()


@pytest.fixture(scope="module")
def jax_mod(background):
    import jax
    import jax.numpy as jnp
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_arch as j_get_arch
    from repro.configs import shape_applicable as j_shape_applicable
    from repro.launch import dryrun as j_dryrun
    from repro.launch.flops import flops_of_callable as j_flops
    from repro.models import transformer as j_T
    from repro.optim import AdamW as JAdamW
    from repro.train import make_train_step as j_make_train_step
    return dict(jax=jax, jnp=jnp, SHAPES=J_SHAPES, get_arch=j_get_arch,
                shape_applicable=j_shape_applicable, dryrun=j_dryrun,
                flops=j_flops, T=j_T, AdamW=JAdamW,
                make_train_step=j_make_train_step)


# ---------------------------------------------------------------------------
# Pure functions against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_shape_applicable_matches_jax(jax_mod, arch):
    cfg, jcfg = get_arch(arch), jax_mod["get_arch"](arch)
    for name, shape in SHAPES.items():
        assert shape_applicable(cfg, shape) == jax_mod["shape_applicable"](
            jcfg, jax_mod["SHAPES"][name]), (arch, name)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_choose_tp_fold_matches_jax(jax_mod, arch):
    cfg, jcfg = get_arch(arch), jax_mod["get_arch"](arch)
    for name, shape in SHAPES.items():
        for devices in (256, 512):
            assert D.choose_tp_fold(cfg, shape, devices) == \
                jax_mod["dryrun"].choose_tp_fold(
                    jcfg, jax_mod["SHAPES"][name], devices), (name, devices)


def test_pick_microbatches_matches_jax(jax_mod):
    grid = [(256, 16, 4096), (32, 16, 32768), (100, 10, 1000)]
    grid += [(b, dp, s) for b in (1, 4, 32, 128, 256, 512)
             for dp in (1, 2, 8, 16, 32, 256) for s in (16, 2048, 4096,
                                                         32768) if b >= dp]
    for gb, dp, seq in grid:
        m = D.pick_microbatches(gb, dp, seq)
        assert m == jax_mod["dryrun"].pick_microbatches(gb, dp, seq)
        assert gb % m == 0 and (gb // m) % dp == 0


def _record(seed: int) -> dict:
    """A cell record's numbers from ``seed``: flops, bytes and a
    collective record built by ``collective_summary``."""
    g = torch.Generator().manual_seed(seed)

    def draw(n):
        return int(torch.randint(0, n, (), generator=g))
    coll = collective_summary({k: draw(1 << 30) for k in COLLECTIVES},
                              {k: draw(100) for k in COLLECTIVES})
    return {"flops": float(draw(1 << 40)),
            "bytes_accessed": float(draw(1 << 36)), "collective_bytes": coll}


def test_extrapolate_matches_jax(jax_mod):
    for seed in range(6):
        r1, r2 = _record(2 * seed), _record(2 * seed + 1)
        if seed == 0:
            r2 = {k: (dict(v) if isinstance(v, dict) else v)
                  for k, v in r1.items()}
            r2["flops"] = r1["flops"] * 2        # an exact slope
        for L in (1, 2, 24, 80):
            assert D._extrapolate(r1, r2, L) == \
                jax_mod["dryrun"]._extrapolate(r1, r2, L)


def test_collective_summary_matches_jax_hlo_record(jax_mod):
    """``weighted`` / ``total`` / ``counts`` of the port's record against
    JAX's parser on an HLO text with the same payloads by kind."""
    hlo = """
      %ar = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} %x)
      %ar2 = bf16[64]{0} all-reduce(bf16[64]{0} %x2)
      %ag = bf16[64]{0} all-gather(bf16[16]{0} %y), dimensions={0}
      %rs.1 = f32[32]{0} reduce-scatter(f32[128]{0} %z), dimensions={0}
      %a2a = f32[8,8]{1,0} all-to-all(f32[8,8]{1,0} %a)
      %cp = u8[100]{0} collective-permute-start(u8[100]{0} %w)
    """
    ref = jax_mod["dryrun"].collective_bytes_from_hlo(hlo)
    got = collective_summary(
        {"all-reduce": 128 * 256 * 4 + 64 * 2, "all-gather": 64 * 2,
         "reduce-scatter": 128 * 4, "all-to-all": 8 * 8 * 4,
         "collective-permute": 100},
        {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1,
         "all-to-all": 1, "collective-permute": 1})
    assert got == ref


# ---------------------------------------------------------------------------
# Abstract trees at the published geometry
# ---------------------------------------------------------------------------
def _shapes(tree) -> list:
    return [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in tree_util.leaves(tree)]


def _jax_shapes(jax, tree) -> list:
    return [(tuple(a.shape), str(a.dtype))
            for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_trees_match_jax(jax_mod, arch):
    cfg, jcfg = get_arch(arch), jax_mod["get_arch"](arch)
    params = T.abstract_params(cfg)
    assert all(a.is_meta for a in tree_util.leaves(params))
    assert _shapes(params) == _jax_shapes(
        jax_mod["jax"], jax_mod["T"].abstract_params(jcfg))
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        cache = T.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        assert all(a.is_meta for a in tree_util.leaves(cache))
        assert _shapes(cache) == _jax_shapes(
            jax_mod["jax"], jax_mod["T"].abstract_cache(
                jcfg, shape.global_batch, shape.seq_len))


# ---------------------------------------------------------------------------
# FLOP counting
# ---------------------------------------------------------------------------
def test_flops_unit_cases_match_jax(jax_mod):
    """JAX's three cases: one product, a loop of 7, remat's recompute."""
    jax, jnp = jax_mod["jax"], jax_mod["jnp"]
    sds = jax.ShapeDtypeStruct
    jf = jax_mod["flops"]
    n = flops_of_callable(lambda a, b: a @ b, torch.zeros(8, 16),
                          torch.zeros(16, 4))
    assert n == 2 * 8 * 16 * 4 == jf(lambda a, b: a @ b,
                                     sds((8, 16), jnp.float32),
                                     sds((16, 4), jnp.float32))

    def loop(x):
        for _ in range(7):
            x = x @ x
        return x

    def jloop(x):
        return jax.lax.scan(lambda c, _: (c @ c, None), x, None,
                            length=7)[0]
    n = flops_of_callable(loop, torch.zeros(4, 4))
    assert n == 7 * 2 * 4 ** 3 == jf(jloop, sds((4, 4), jnp.float32))

    def remat(x):
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            y = torch.utils.checkpoint.checkpoint(
                lambda y: (y @ y).sum(), x, use_reentrant=False)
            return torch.autograd.grad(y, x)[0]

    def jremat(x):
        return jax.grad(jax.checkpoint(lambda y: (y @ y).sum()))(x)
    n = flops_of_callable(remat, torch.zeros(4, 4))
    assert n >= 3 * 2 * 4 ** 3
    assert n == jf(jremat, sds((4, 4), jnp.float32))


def _flop_pair(m, family: str, kind: str, seq: int):
    """(JAX's count, the port's) of one entry point at one layer of the
    family's smoke config, abstract parameters on both sides."""
    jax, jnp = m["jax"], m["jnp"]
    sds = jax.ShapeDtypeStruct
    arch = FAMILY_ARCHS[family]
    cfg = get_arch(arch).smoke().scaled(num_layers=1)
    jcfg = m["get_arch"](arch).smoke().scaled(num_layers=1)
    jT, b = m["T"], FLOP_BATCH
    jp, p = jT.abstract_params(jcfg), T.abstract_params(cfg)
    if cfg.embedding_input:
        key, jx = "embeds", sds((b, seq, cfg.d_model), jnp.bfloat16)
        x = torch.empty((b, seq, cfg.d_model), dtype=torch.bfloat16,
                        device="meta")
    else:
        key, jx = "tokens", sds((b, seq), jnp.int32)
        x = torch.empty((b, seq), dtype=torch.int32, device="meta")
    if kind == "forward":
        return (m["flops"](lambda q, v: jT.forward(
                    q, jcfg, None, remat=False, **{key: v})[0], jp, jx),
                flops_of_callable(lambda q, v: T.forward(
                    q, cfg, remat=False, **{key: v})[0], p, x))
    if kind == "prefill":
        return (m["flops"](lambda q, v: jT.prefill(q, jcfg, None,
                                                    **{key: v}), jp, jx),
                flops_of_callable(lambda q, v: T.prefill(q, cfg,
                                                         **{key: v}), p, x))
    if kind == "decode":
        tok = torch.empty((b, 1), dtype=torch.int32, device="meta")
        return (m["flops"](lambda q, c, t: jT.decode_step(
                    q, c, t, seq - 1, jcfg, None), jp,
                    jT.abstract_cache(jcfg, b, seq), sds((b, 1), jnp.int32)),
                flops_of_callable(lambda q, c, t: T.decode_step(
                    q, c, t, seq - 1, cfg), p,
                    T.abstract_cache(cfg, b, seq), tok))
    jopt, opt = m["AdamW"](), AdamW()
    jstate = (jp, jax.eval_shape(jopt.init, jp), sds((), jnp.float32))
    jbatch = {key: jx, "labels": sds((b, seq), jnp.int32)}
    batch = {key: x, "labels": torch.empty((b, seq), dtype=torch.int32,
                                           device="meta")}
    with torch.device("meta"):
        state = (p, opt.init(p), torch.zeros(()))
    return (m["flops"](m["make_train_step"](jcfg, None, jopt), jstate,
                       jbatch),
            flops_of_callable(make_train_step(cfg, opt), state, batch))


@pytest.mark.parametrize("kind", ("forward", "prefill", "decode", "train"))
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_flops_match_jax(jax_mod, family, kind):
    want, got = _flop_pair(jax_mod, family, kind, FLOP_SEQ[family])
    assert got > 0
    assert got == want


def test_flops_one_chunk_gap(jax_mod):
    """mamba2-130m's train step at one SSD chunk: the port counts exactly
    ``ONE_CHUNK_GAP`` less than JAX (the dots of the zero entering state
    that only JAX runs); forward, prefill and decode stay exact."""
    want, got = _flop_pair(jax_mod, "ssm", "train", 32)
    assert want - got == ONE_CHUNK_GAP
    want, got = _flop_pair(jax_mod, "ssm", "forward", 32)
    assert got == want


# ---------------------------------------------------------------------------
# input_specs against JAX's, and the shard shapes behind them
# ---------------------------------------------------------------------------
def _plain(t):
    if isinstance(t, dict):
        return {k: _plain(v) for k, v in t.items()}
    if isinstance(t, P):
        return [list(a) if isinstance(a, tuple) else a for a in t]
    return [_plain(v) for v in t]


def test_input_specs_match_jax(background):
    from torch._subclasses.fake_tensor import FakeTensorMode
    want = background["specs"]()
    shapes = {}
    with M.fake_process_group(256):
        mesh = M.make_production_mesh()
        with FakeTensorMode():
            with pytest.raises(ValueError, match="use_ssd_kernel"):
                D.step_callable(get_arch("mamba2-130m").scaled(
                    use_ssd_kernel=True), SHAPES["decode_32k"], mesh)
            for arch, name in SPEC_CELLS:
                args, specs = D.input_specs(get_arch(arch), SHAPES[name],
                                            mesh)
                assert json.loads(json.dumps(_plain(specs))) == \
                    want[f"{arch}|{name}"], (arch, name)
                shapes[arch, name] = args
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        with M.fake_process_group(256):
            D.input_specs(get_arch("llama3-8b"), SHAPES["train_4k"],
                          M.make_production_mesh())
    # llama3-8b x train_4k: tp 16 (its 8 KV heads do not divide it, so
    # attention is whole), dp 16, 16 rows a rank, ZeRO-1 over the 32
    # layers (their leading axis)
    (params, opt, _), batch = shapes["llama3-8b", "train_4k"]
    cfg = get_arch("llama3-8b")
    assert tuple(batch["tokens"].shape) == (16, 4096)
    assert tuple(params["layers"]["wq"].shape) == (32, 4096, 4096)
    assert tuple(params["layers"]["w_up"].shape) == (32, 4096,
                                                     cfg.d_ff // 16)
    assert tuple(opt.m["layers"]["w_up"].shape) == (2, 4096, cfg.d_ff // 16)
    assert tuple(params["embed"].shape) == (cfg.vocab_size // 16, 4096)
    # the embedding's first dim splits over the model axis, so ZeRO-1
    # takes its second
    assert tuple(opt.v["embed"].shape) == (cfg.vocab_size // 16, 256)
    # mamba2-130m x train_4k: TP-folded, one row on each of 256 ranks
    (params, opt, _), batch = shapes["mamba2-130m", "train_4k"]
    assert tuple(batch["tokens"].shape) == (1, 4096)
    full = T.abstract_params(get_arch("mamba2-130m"))
    assert _shapes(params) == _shapes(full)
    # qwen2-moe x decode_32k: 8 rows a rank, 60 experts whole (tp mode)
    params, cache, tok, pos = shapes["qwen2-moe-a2.7b", "decode_32k"]
    assert tuple(tok.shape) == (8, 1) and pos == 32767
    assert cache["k"].shape[1:3] == (8, 32768)


# ---------------------------------------------------------------------------
# run_cell and the CLI
# ---------------------------------------------------------------------------
def test_run_cell_skips_long_500k_full_attention():
    rec = D.run_cell("llama3-8b", "long_500k", False, verbose=False,
                     device="cpu")
    assert rec["status"] == "skipped" and "524k" in rec["reason"]
    assert rec["devices"] == 256 and rec["mesh"] == "16x16"


def test_run_cell_refuses_the_ssd_kernel():
    with pytest.raises(ValueError, match="fake tensors"):
        D.run_cell("mamba2-130m", "decode_32k", False, verbose=False,
                   cfg=get_arch("mamba2-130m").scaled(use_ssd_kernel=True),
                   device="cpu")


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_run_cell_families(background, family):
    arch = FAMILY_ARCHS[family]
    recs = background["cells"](arch)
    for name, rec in recs.items():
        assert rec["status"] == "ok", (name, rec.get("traceback"))
        assert rec["mesh"] == "16x16" and rec["devices"] == 256
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["flops_global"] >= rec["flops"]
        coll = rec["collective_bytes"]
        assert coll["total"] > 0 and coll["counts"]["all-reduce"] > 0
        assert coll["weighted"] == 2 * coll["all-reduce"] + sum(
            coll[k] for k in COLLECTIVES if k != "all-reduce")
        mem = rec["memory_analysis"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["temp_size_in_bytes"] > 0
        kind = SHAPES[name].kind
        if kind == "train":
            assert mem["alias_size_in_bytes"] > 0
            # ZeRO-1: the data axes gather the parameters after the update
            assert coll["counts"]["all-gather"] > 0
        elif kind == "prefill":
            assert mem["alias_size_in_bytes"] == 0
        else:
            assert 0 < mem["alias_size_in_bytes"] <= \
                mem["argument_size_in_bytes"]
        # a layer-uniform stack: the 1- and 2-layer line is the full trace
        ext = rec["extrapolated"]
        assert ext["flops"] == rec["flops"], name
        assert ext["collective_bytes"]["total"] == coll["total"], name


def test_run_cell_global_flops_of_a_replicated_block(background):
    """A rank's FLOPs times the world size is not the global count where
    a block runs replicated: smoke llama3-8b's heads do not divide tp 16,
    so every rank of a model row runs the whole attention."""
    rec = background["cells"]("llama3-8b")["prefill_32k"]
    assert rec["flops"] * 256 > rec["flops_global"]


def test_dryrun_cli_full_width(background):
    (rec,) = background["cli"]()
    assert rec["status"] == "ok", rec.get("traceback")
    path = os.path.join(background["out"], D._record_name(rec))
    with open(path) as f:
        saved = json.load(f)
    assert saved["arch"] == "llama3-8b" and saved["shape"] == "decode_32k"
    assert saved["extrapolated"]["flops"] == saved["flops"]
    assert saved["flops"] > 0 and saved["collective_bytes"]["total"] > 0
    # the whole stacked KV cache of this rank's 8 rows is donated
    cfg = get_arch("llama3-8b")
    kv = 2 * cfg.num_layers * 8 * 32768 * cfg.num_kv_heads \
        * cfg.head_dim * 2
    assert saved["memory_analysis"]["alias_size_in_bytes"] == kv
    assert not os.path.exists(os.path.join(SRC, "..", "benchmarks",
                                           "results", D._record_name(rec)))


def test_dryrun_cli_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.main(["--arch", "llama3-8b", "--shape", "decode_32k"])


def test_production_mesh_shapes():
    for multi, tp, want in ((False, 16, {"data": 16, "model": 16}),
                            (False, 8, {"data": 32, "model": 8}),
                            (True, 16, {"pod": 2, "data": 16,
                                        "model": 16})):
        with M.fake_process_group(512 if multi else 256):
            mesh = M.make_production_mesh(multi_pod=multi, tp_size=tp)
            assert M.mesh_shape(mesh) == want
            assert M.dp_axes_of(mesh) == (("pod", "data") if multi
                                          else ("data",))
            if multi:
                # the data group of two axes: the 32 ranks of model index 0
                ctx = D._ctx(mesh, False)
                assert (ctx.dp_rank, ctx.dp_size, ctx.tp_size) == (0, 32, 16)
                import torch.distributed as dist
                assert dist.get_process_group_ranks(ctx.dp_group) == \
                    list(range(0, 512, 16))
    assert not torch.distributed.is_initialized()
    assert math.prod(want.values()) == 512
