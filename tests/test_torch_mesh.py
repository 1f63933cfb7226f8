"""Port parity: data-parallel diffusion on a device mesh.

Covers ``repro_torch.launch.mesh``, ``DiffusionEngine(mesh=)`` /
``place_on_mesh``, ``serve_diffusion.serve(mesh=)`` and ``--mesh``, and
``ClusterRouter(engines=)``, on the CPU at smoke widths with guidance 7.5.

The JAX package runs a mesh as ONE GSPMD program, where every reduction
over the batch is global.  The port runs one process a rank and makes the
three batch-coupled reductions explicit over the data group: the DBSC
FFN's INT12 amax, the PSSA counters and the TIPS counts.  Here the ranks
are gloo processes (the counterpart of the JAX package's fake host
devices), spawned through a ``FileStore`` with a timeout, one intra-op
thread each (ROADMAP Queue 3 item 14).  Two groups of two ranks run:
``_rank_checks`` (below) and ``serve_diffusion --mesh 2 --device cpu``.

What is held, and how tightly:

* (a) a 1-rank mesh (the first rank of the group) against the unsharded
  engine on the same rows: images, latents and every stats leaf
  bit-equal (the JAX package's ``test_dp1_mesh_bit_parity``);
* (b) dp = 2 against the unsharded engine on the DBSC slice route at
  knife-edge thresholds (PSSA 1/T, TIPS 1/text_len: every counter moves
  with its input), the two ranks' rows drawn to different amaxes: the
  PSSA stats, the TIPS masks and ratios bit-equal, every rank's INT12
  scales equal to the unsharded run's, images within 1e-4 (the JAX
  package's bound for its dp > 1 images, ``tests/test_sharded_engine.py``);
  the positive control: a rank's rows run on their own (a local amax)
  take other scales and other images;
* (c) dp = 2 against the JAX package's unsharded engine (reference
  attention + DBSC, its paper thresholds), on the same converted weights:
  the energy summary identical (integer counters), latents and images
  within ``tests/test_torch_pipeline.py``'s DBSC-route bounds (2e-2 /
  2e-3: an INT12 code on a rounding boundary flips on an ulp);
* (d) micro-batch 2 at dp = 2 with ``stats_rows=1``, so rank 1 accounts
  for nothing: the PSSA and TIPS integers and the energy summary equal the
  JAX engine's unsharded ``stats_rows=1`` run (the summary identical, as
  ``test_torch_pipeline.py`` holds it);
* (e) the mesh helpers against the JAX package's on equivalent meshes and
  its messages (divisibility, slots, ``--mesh``, ``engines=``);
* (f) ``serve(mesh=)``'s metrics through ``--mesh 2 --device cpu``: the
  JAX package's ``mesh`` dict, the micro-batch rounded up to dp, and the
  ledger equal to the unsharded serve of the same micro-batches.
"""
import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import bk_sdm as t_bk
from repro_torch.core import quant
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.diffusion.engine import DiffusionEngine as TEngine
from repro_torch.diffusion.pipeline import energy_report as t_report
from repro_torch.diffusion.pipeline import init_params
from repro_torch.diffusion.stats import attn_layer_order
from repro_torch.kernels.dispatch import KernelPolicy as TKP
from repro_torch.launch import mesh as M
from repro_torch.launch import serve_diffusion
from repro_torch.launch.router import ClusterRouter
from repro_torch.tree import leaves, tree_map

SLICE = dict(self_attention="fused", cross_attention="fused", ffn="dbsc")
REF_DBSC = dict(ffn="dbsc")
ROWS = 4                     # (a)-(c): two rows a rank at dp = 2
IMG_ATOL_DP = 1e-4           # the JAX package's dp > 1 image bound
LAT_ATOL_JAX, IMG_ATOL_JAX = 2e-2, 2e-3   # test_torch_pipeline, DBSC route
SPAWN_TIMEOUT_S = 120.0
JOIN_TIMEOUT_S = 300.0       # a background thread of the fixture


def _cfg(route, knife=False):
    cfg = t_bk.with_kernel_policy(t_bk.SMOKE, TKP(**route))
    cfg = dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, guidance_scale=7.5))
    if knife:
        t = cfg.unet.latent_size ** 2
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, pssa_threshold=1.0 / t,
            precision=PrecisionPolicy(threshold=1.0 / cfg.unet.text_len)))
    return cfg


def _inputs(rows, seed=0):
    """(tokens, uncond tokens, latents) numpy arrays of ``rows`` requests;
    the second half's latents are scaled up, so the two ranks' FFN inputs
    reach different amaxes."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 256, (rows, 8)).astype(np.int32)
    toks[:, 0] = 0
    lat = rng.standard_normal((rows, 16, 16, 4)).astype(np.float32)
    lat[rows // 2:] *= 1.5
    return toks, np.zeros_like(toks), lat


def _gen(eng, inputs, stats_rows=None):
    toks, un, lat = (torch.from_numpy(x) for x in inputs)
    return eng.generate(toks, uncond_tokens=un, latents=lat,
                        stats_rows=stats_rows)


def _run(cfg, params, inputs, mesh=None, stats_rows=None):
    """One generate on a fresh engine over copies of ``params``, as numpy:
    images, latents, every stats leaf and the energy summary."""
    eng = TEngine(cfg, device="cpu", params=_copy(params), mesh=mesh)
    out = _gen(eng, inputs, stats_rows)
    return dict(images=out.images.numpy(), latents=out.latents.numpy(),
                stats=[x.numpy() for x in leaves(
                    [out.stats.pssa, out.stats.tips, out.stats.reuse])],
                summary=t_report(cfg, out.stats).summary())


def _copy(params):
    return tree_map(torch.clone, params)


@contextlib.contextmanager
def _scales():
    """Record the scale of every activation quantization in the block."""
    seen = []
    real = quant.quantize_act

    def record(*a, **kw):
        q = real(*a, **kw)
        seen.append(q.scale.item())
        return q
    quant.quantize_act = record
    try:
        yield seen
    finally:
        quant.quantize_act = real


def _rank_checks(params):
    """One rank of the two-rank group: (a)-(e)'s runs on this rank."""
    rank = dist.get_rank()
    out = {"rank": rank}
    mesh = M.make_data_mesh(2)
    out["signature"] = M.mesh_signature(mesh)
    out["dp_size"] = M.dp_size_of(mesh)
    out["dp_axes"] = M.dp_axes_of(mesh)
    out["shape"] = M.mesh_shape(mesh)
    out["elastic"] = [M.mesh_shape(M.make_elastic_mesh(tp))
                      for tp in (16, 1)]
    try:
        M.make_data_mesh(3)
    except ValueError as e:
        out["too_many"] = str(e)
    slice_knife = _cfg(SLICE, knife=True)
    big = _inputs(ROWS)
    # (b) dp = 2 on the slice route; its INT12 scales as this rank saw them
    with _scales() as seen:
        out["b_mesh"] = _run(slice_knife, params, big, mesh)
    out["b_scales"] = seen
    # (c), (d) against the JAX engine: reference attention + DBSC
    ref_dbsc = _cfg(REF_DBSC)
    out["c_mesh"] = _run(ref_dbsc, params, big, mesh)
    out["d_mesh"] = _run(ref_dbsc, params, _inputs(2, seed=5), mesh,
                         stats_rows=1)
    # (e) the engine's refusals under the mesh
    eng = TEngine(ref_dbsc, device="cpu", params=_copy(params), mesh=mesh)
    for what, fn in (("odd", lambda: _gen(eng, _inputs(3))),
                     ("slots", lambda: eng.init_slots(2))):
        try:
            fn()
        except ValueError as e:
            out[what] = str(e)
    # (a) a 1-rank mesh on the first rank of the group; the other rank is
    # not on it and must refuse it
    one = M.make_data_mesh(1)
    if rank == 0:
        out["a_mesh"] = _run(slice_knife, params, big, one)
        with _scales() as seen:
            out["b_ref"] = _run(slice_knife, params, big)
        out["b_ref_scales"] = seen
    else:
        try:
            TEngine(ref_dbsc, device="cpu", params=_copy(params), mesh=one)
        except ValueError as e:
            out["off_mesh"] = str(e)
        # (b)'s positive control: this rank's rows alone, on their own
        # amax
        mine = tuple(x[ROWS // 2:] for x in big)
        with _scales() as seen:
            out["b_local"] = _run(slice_knife, params, mine)
        out["b_local_scales"] = seen
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
    from repro.configs import bk_sdm as j_bk
    from repro.diffusion import denoiser as j_denoiser
    from repro.diffusion import engine as j_engine
    from repro.diffusion.pipeline import energy_report as j_report
    from repro.kernels.dispatch import KernelPolicy as JKP
    from repro.launch import mesh as jmesh
    return dict(jax=jax, jnp=jnp, j_bk=j_bk, j_denoiser=j_denoiser,
                j_engine=j_engine, j_report=j_report, JKP=JKP, jmesh=jmesh)


def _to_jax(jnp, tree):
    """The port's parameter tree in the JAX package's layout (the inverse
    of ``repro_torch.convert.convert_tree``: 4-D leaves OIHW -> HWIO)."""
    if isinstance(tree, dict):
        return {k: _to_jax(jnp, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_jax(jnp, v) for v in tree]
    arr = tree.numpy()
    return jnp.array(arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr,
                     copy=True)


def _jax_engine(m, cfg, trees):
    """The JAX package's engine on ``trees`` (the port's weights through
    ``_to_jax``): its three random initialisers, the slow part of its
    construction, are stood in for by the trees while it is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(m["j_engine"], "init_text_encoder_params",
                   lambda key, c: trees["text"])
        mp.setattr(m["j_engine"], "init_vae_params",
                   lambda key, c: trees["vae"])
        mp.setattr(m["j_denoiser"].Denoiser, "init_params",
                   lambda self, key: trees["unet"])
        return m["j_engine"].DiffusionEngine(cfg,
                                             key=m["jax"].random.PRNGKey(0))


def _background(fn, *args):
    """Run ``fn(*args)`` on a thread; the returned callable joins it and
    returns (or raises) its result."""
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


SERVE_ARGV = ["--smoke", "--device", "cpu", "--requests", "3", "--steps",
              "2", "--guidance", "7.5", "--kernels", "ffn=dbsc", "--ledger"]


@pytest.fixture(scope="module")
def runs(jax_mod):
    """Everything that takes time, at once: the two-rank group on the
    port's weights, ``serve_diffusion --mesh 2`` (a second group), the
    unsharded serve it is held against, and the JAX engine's (c) and (d)
    on the same weights, each call on a thread of its own."""
    params = init_params(_cfg(REF_DBSC), torch.Generator().manual_seed(0),
                         "cpu")
    jnp = jax_mod["jnp"]
    # copied before the group is spawned: spawning moves the tensors'
    # storage to shared memory and frees the buffers they had
    trees = {k: _to_jax(jnp, v) for k, v in params.items()}
    group = _background(M.spawn, _rank_checks, 2, (params,), "cpu",
                        SPAWN_TIMEOUT_S)
    cli = _background(serve_diffusion.main,
                      SERVE_ARGV + ["--micro-batch", "1", "--mesh", "2"])
    jcfg = jax_mod["j_bk"].with_kernel_policy(
        jax_mod["j_bk"].SMOKE, jax_mod["JKP"](**REF_DBSC))
    jcfg = dataclasses.replace(jcfg, ddim=dataclasses.replace(
        jcfg.ddim, guidance_scale=7.5))
    def jax_run(je, inputs, rows):
        toks, un, lat = (jnp.asarray(x) for x in inputs)
        o = je.generate(toks, None, uncond_tokens=un, latents=lat,
                        stats_rows=rows)
        return dict(images=np.asarray(o.images),
                    latents=np.asarray(o.latents), stats=o.stats,
                    summary=jax_mod["j_report"](jcfg, o.stats).summary())
    # one engine a thread, built here: the stand-ins are patched in and
    # out of the JAX modules one engine at a time
    jax_c, jax_d = (
        _background(jax_run, _jax_engine(jax_mod, jcfg, trees), inputs, rows)
        for inputs, rows in ((_inputs(ROWS), None), (_inputs(2, seed=5), 1)))
    unsharded = serve_diffusion.main(SERVE_ARGV + ["--micro-batch", "2"])
    return dict(ranks=group(), jax={"c": jax_c(), "d": jax_d()},
                serve=(cli(), unsharded))


# ---------------------------------------------------------------------------
# (a), (b): the port against itself
# ---------------------------------------------------------------------------
def _same_stats(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        np.testing.assert_array_equal(x, y, err_msg=f"stats leaf {i}")


def test_dp1_mesh_bit_parity(runs):
    ranks = runs["ranks"]
    ref, one = ranks[0]["b_ref"], ranks[0]["a_mesh"]
    np.testing.assert_array_equal(one["images"], ref["images"])
    np.testing.assert_array_equal(one["latents"], ref["latents"])
    _same_stats(one["stats"], ref["stats"])
    assert one["summary"] == ref["summary"]
    assert "rank 1 is not on the mesh" in ranks[1]["off_mesh"]


def test_dp2_counters_bit_equal_images_close(runs):
    ranks = runs["ranks"]
    ref = ranks[0]["b_ref"]
    for r in ranks:
        got = r["b_mesh"]
        # every rank returns the global output
        assert got["images"].shape == ref["images"].shape == (ROWS, 128,
                                                              128, 3)
        _same_stats(got["stats"], ref["stats"])
        assert got["summary"] == ref["summary"]
        d = np.abs(got["images"] - ref["images"]).max()
        assert d < IMG_ATOL_DP, d
    np.testing.assert_array_equal(ranks[0]["b_mesh"]["images"],
                                  ranks[1]["b_mesh"]["images"])


def test_dp2_int12_scale_is_the_groups(runs):
    """Every rank quantizes on the unsharded run's scales; its rows on
    their own take other ones and give other images."""
    ranks = runs["ranks"]
    want = ranks[0]["b_ref_scales"]
    cfg = _cfg(SLICE)
    # one scale a DBSC matmul: two a block's FFN, every block, every step
    assert len(want) == (2 * len(attn_layer_order(cfg.unet))
                         * cfg.ddim.num_inference_steps)
    for r in ranks:
        assert r["b_scales"] == want
    local = ranks[1]["b_local_scales"]
    assert len(local) == len(want) and local != want
    mine = ranks[1]["b_mesh"]["images"][ROWS // 2:]
    assert np.abs(ranks[1]["b_local"]["images"] - mine).max() > 10 * \
        IMG_ATOL_DP


# ---------------------------------------------------------------------------
# (c), (d): the port's mesh against the JAX package's unsharded engine
# ---------------------------------------------------------------------------
def _jax_ints(stats):
    """Each layer's PSSA counters and TIPS masks of a JAX stats object."""
    return ([np.asarray(s.nnz) for s in stats.pssa]
            + [np.asarray(s.bitmap_ones_xor) for s in stats.pssa]
            + [np.asarray(t.important) for t in stats.tips])


def _port_ints(np_out, n_layers):
    """The same leaves of a ``_np`` output, by position in the flattened
    (pssa, tips) stats: PSSAStats has ten fields, TIPSResult three."""
    st = np_out["stats"]
    pssa = [st[10 * i:10 * i + 10] for i in range(n_layers)]
    tips = [st[10 * n_layers + 3 * i:10 * n_layers + 3 * i + 3]
            for i in range(n_layers)]
    return ([p[0] for p in pssa] + [p[3] for p in pssa]
            + [t[0] for t in tips])


@pytest.mark.parametrize("part", ["c", "d"])
def test_dp2_matches_jax_unsharded(runs, part):
    ranks, jout = runs["ranks"], runs["jax"]
    want = jout[part]
    n_layers = len(want["stats"].pssa)
    for r in ranks:
        got = r[f"{part}_mesh"]
        for x, y in zip(_port_ints(got, n_layers), _jax_ints(want["stats"])):
            assert x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        assert got["summary"] == want["summary"]
        np.testing.assert_allclose(got["latents"], want["latents"], rtol=0,
                                   atol=LAT_ATOL_JAX)
        np.testing.assert_allclose(got["images"], want["images"], rtol=0,
                                   atol=IMG_ATOL_JAX)
    if part == "d":
        # rank 1's row is past stats_rows=1: one row accounted in all
        assert want["stats"].tips[0].important.shape[1] == 1


# ---------------------------------------------------------------------------
# (e): helpers and messages against the JAX package's
# ---------------------------------------------------------------------------
class _JaxMeshLike:
    """What the JAX package's mesh helpers read of a ``jax.sharding.Mesh``
    (axis names, shape, device ids) for an N-device mesh this host cannot
    make (it has one CPU device)."""

    class _Dev:
        def __init__(self, i):
            self.id = i

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self.devices = np.array([self._Dev(i) for i in range(
            int(np.prod(shape)))], dtype=object).reshape(shape)


def test_mesh_helpers_match_jax(runs, jax_mod):
    ranks = runs["ranks"]
    jm = jax_mod["jmesh"]
    like = _JaxMeshLike((2, 1))
    for r in ranks:
        assert r["signature"] == jm.mesh_signature(like)
        assert r["dp_size"] == jm.dp_size_of(like) == 2
        assert r["dp_axes"] == jm.dp_axes_of(like)
        assert r["shape"] == like.shape
        assert [tuple(s.values()) for s in r["elastic"]] == [(1, 2), (2, 1)]
        assert r["too_many"] == "--mesh 3 needs 3 devices, have 2"
        assert "multiple of the data-parallel degree 2" in r["odd"]
        assert r["slots"].startswith("slot-state mode is single-device")
    assert M.mesh_signature(None) is jm.mesh_signature(None) is None


@pytest.mark.parametrize("n", range(1, 21))
def test_elastic_shape_rule_matches_jax(jax_mod, monkeypatch, n):
    """``make_elastic_mesh``'s (data, model) shape for n live devices, the
    JAX package's function run on n stand-in devices."""
    jax = jax_mod["jax"]
    monkeypatch.setattr(jax, "devices", lambda: list(range(n)))
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: shape)
    for tp in (1, 2, 3, 4, 8, 16):
        assert M.elastic_shape(n, tp) == tuple(
            jax_mod["jmesh"].make_elastic_mesh(tp)), tp


def test_engine_mesh_needs_a_group_and_its_device():
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_data_mesh(1)
    with M.process_group(device="cpu"):
        mesh = M.make_smoke_mesh()
        assert M.mesh_shape(mesh) == {"data": 1, "model": 1}
        with pytest.raises(ValueError, match="--mesh 2 needs 2 devices, "
                                             "have 1"):
            M.make_data_mesh(2)
        eng = TEngine(_cfg(REF_DBSC), device="cpu", mesh=mesh)
        assert eng.dp_size == 1 and M.active_mesh() is None
    assert not dist.is_initialized()


@pytest.mark.parametrize("argv,msg", [
    (["--mesh", "-1"], "--mesh must be >= 0"),
    (["--mesh", "2", "--continuous"], "--continuous is single-device"),
    (["--mesh", "2", "--replicas", "2"],
     "--replicas runs the single-device slot runtime per replica")])
def test_mesh_cli_guards(argv, msg, capsys):
    with pytest.raises(SystemExit):
        serve_diffusion.main(["--smoke", "--device", "cpu"] + argv)
    assert msg in capsys.readouterr().err


def test_router_engines_messages():
    cfg = _cfg(REF_DBSC)
    e0 = TEngine(cfg, device="cpu")
    other = TEngine(dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, num_inference_steps=2)), device="cpu")
    with pytest.raises(ValueError, match="engines= carries 1 engines for "
                                         "2 replicas"):
        ClusterRouter(e0, 2, 2, engines=[e0])
    with pytest.raises(ValueError, match="per-replica engines must share "
                                         "the pipeline config"):
        ClusterRouter(e0, 2, 2, engines=[e0, other])
    r = ClusterRouter(e0, 2, 2, engines=[e0, TEngine(cfg, device="cpu")])
    assert len(r.engines) == 2 and r.engines[0] is e0


# ---------------------------------------------------------------------------
# (f): serve(mesh=) through the CLI
# ---------------------------------------------------------------------------
def test_serve_mesh_cli_matches_unsharded(runs):
    got, want = runs["serve"]
    assert got["mesh"] == {"dp": 2, "shape": {"data": 2, "model": 1},
                           "devices": 2}
    assert want["mesh"] is None
    assert got["micro_batch"] == 2 and got["engine_calls"] == 2
    assert got["padded_rows"] == 1 and got["requests"] == 3
    assert got["energy"] == want["energy"]
    assert got["tips_low_ratio_per_iter"] == want["tips_low_ratio_per_iter"]
