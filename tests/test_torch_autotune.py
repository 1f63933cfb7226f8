"""Port parity: the compiled-path kernel policy (``kernels.autotune``, the
launch knobs and the ``ffn_quant="int8"`` route), case for case as
``tests/test_autotune.py`` holds the JAX package.

* Keys are the JAX package's strings; the port's table holds ``cuda``
  entries only, and a malformed, stale or illegal table raises when it is
  loaded.
* Knobs move no bit: on the CPU the plain versions ignore them, so each
  candidate's output equals the JAX kernel's (interpret mode) at its own
  blocks, counters exactly, attention outputs at atol 1e-5 (float32 in
  another order, as ``tests/test_autotune.py`` holds its blocks).
* ``ffn_quant="int8"``: accumulators bit-equal to ``bitslice_matmul_ref``
  and to JAX's ``bitslice_matmul_int8``, the products on ``torch.int8``.
* The smoke-size engine: images bit-equal and the energy headline equal
  across ``tuned`` and ``ffn_quant``, and against the JAX engine under the
  same specs at ``tests/test_torch_pipeline.py``'s fused + DBSC tolerances
  (latents 2e-2, images 2e-3; the summary identical).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.attention  # noqa: F401  (resolves the ops<->core cycle)
from repro.configs import bk_sdm as j_bk
from repro.diffusion.engine import DiffusionEngine as JEngine
from repro.diffusion.pipeline import energy_report as j_report
from repro.kernels import autotune as j_autotune
from repro.kernels.bitslice_matmul.ref import (
    bitslice_matmul_int8 as j_int8)
from repro.kernels.dispatch import KernelPolicy as JKP
from repro.kernels.patch_bitmap.ops import patch_bitmap as j_bitmap
from repro.kernels.patch_reuse.ops import patch_delta as j_delta
from repro.kernels.pssa_attention.ops import pssa_attention as j_pssa
from repro_torch.configs import bk_sdm as t_bk
from repro_torch.convert import convert_params
from repro_torch.diffusion.engine import DiffusionEngine as TEngine
from repro_torch.diffusion.pipeline import energy_report as t_report
from repro_torch.kernels import autotune, dispatch, runtime
from repro_torch.kernels.autotune import AutotuneTableError
from repro_torch.kernels.bitslice_matmul.ops import bitslice_matmul
from repro_torch.kernels.bitslice_matmul.ref import (bitslice_matmul_int8,
                                                     bitslice_matmul_ref)
from repro_torch.kernels.cross_attention_tips.ops import cross_attention_cas
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.kernels.patch_bitmap.ops import patch_bitmap
from repro_torch.kernels.patch_reuse.ops import patch_delta
from repro_torch.kernels.pssa_attention.ops import pssa_attention


@pytest.fixture(autouse=True)
def _fresh_table_cache():
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def _write_table(tmp_path, table):
    path = tmp_path / "table.json"
    path.write_text(json.dumps(table))
    return str(path)


# ----------------------------------------------------------------------------
# Key round trip + table validation
# ----------------------------------------------------------------------------
GEOMS = {
    "self_attention": (2, 8, 4096, 40, 64),
    "cross_attention": (2, 8, 1024, 80, 77),
    "bitmap": (4096, 4096, 64),
    "reuse": (2, 4096, 320, 64),
}


@pytest.mark.parametrize("op", sorted(GEOMS))
def test_key_round_trip(op):
    geom = GEOMS[op]
    key = autotune.make_key("cuda", op, geom)
    assert key == j_autotune.make_key("cuda", op, geom)
    assert autotune.parse_key(key) == ("cuda", op, geom)
    assert j_autotune.parse_key(key) == ("cuda", op, geom)
    backend, opname, dims = key.split("/")
    assert (backend, opname) == ("cuda", op)
    assert all("=" in part for part in dims.split(","))


@pytest.mark.parametrize("bad", [
    "cuda/self_attention",                                   # no geometry
    "cuda/unknown_op/b=1,h=8,t=64,d=8,patch=16",             # unknown op
    "cuda/self_attention/b=1,h=8,t=64,d=8",                  # missing field
    "cuda/self_attention/t=64,b=1,h=8,d=8,patch=16",         # wrong order
    "cuda/self_attention/b=1,h=8,t=sixty,d=8,patch=16",      # non-int
])
def test_parse_key_rejects_what_jax_rejects(bad):
    with pytest.raises(j_autotune.AutotuneTableError):
        j_autotune.parse_key(bad)
    with pytest.raises(AutotuneTableError):
        autotune.parse_key(bad)


def test_missing_table_is_empty_and_lookup_falls_back(tmp_path):
    path = str(tmp_path / "nope.json")
    assert autotune.load_table(path)["entries"] == {}
    assert autotune.lookup("self_attention", (1, 1, 64, 8, 16),
                           path=path) is None
    # an unknown geometry in the committed table falls back too
    assert autotune.lookup("self_attention", (9, 9, 144, 9, 9)) is None


def test_stale_version_rejected_loudly(tmp_path):
    path = _write_table(tmp_path, {"version": autotune.AUTOTUNE_VERSION + 1,
                                   "entries": {}})
    with pytest.raises(AutotuneTableError, match="version"):
        autotune.load_table(path)


def test_malformed_json_rejected_loudly(tmp_path):
    path = tmp_path / "broken.json"
    path.write_text("{not json")
    with pytest.raises(AutotuneTableError, match="not valid JSON"):
        autotune.load_table(str(path))


SA_KEY = "cuda/self_attention/b=1,h=8,t=64,d=8,patch=16"


@pytest.mark.parametrize("entries,match", [
    ({SA_KEY: {"bogus_knob": 128}}, "unknown knob"),
    ({SA_KEY: {"attn_block_q": "big"}}, "positive int"),
    ({SA_KEY: {"attn_block_q": 0}}, "positive int"),
    ({SA_KEY: {}}, "knob"),
    ({"cuda/self_attention/b=1,t=64": {"attn_block_q": 64}}, "fields"),
    # the port's kernels take a set of launches, and a table is held to it
    ({SA_KEY: {"attn_block_q": 128}}, "kernel takes"),
    # the JAX package's key tile is no knob of the port's PSSA kernel
    ({SA_KEY: {"attn_block_k": 64}}, "unknown knob"),
    ({"cuda/cross_attention/b=2,h=8,tq=256,d=160,tk=77":
      {"cross_block_q": 32}}, "kernel takes"),
    ({"cuda/bitmap/rows=64,tk=64,patch=16": {"bitmap_block_rows": 64}},
     "kernel takes"),
    ({"cuda/reuse/b=1,t=64,c=8,patch=8": {"reuse_block_patches": 3}},
     "kernel takes"),
])
def test_bad_entries_rejected_loudly(tmp_path, entries, match):
    path = _write_table(tmp_path, {"version": autotune.AUTOTUNE_VERSION,
                                   "entries": entries})
    with pytest.raises(AutotuneTableError, match=match):
        autotune.load_table(path)


def test_lookup_hits_and_dispatch_blocks(tmp_path, monkeypatch):
    geom = (1, 2, 64, 8, 16)
    key = autotune.make_key("cuda", "self_attention", geom)
    path = _write_table(tmp_path, {
        "version": autotune.AUTOTUNE_VERSION,
        "entries": {key: {"attn_block_q": 16}}})
    monkeypatch.setattr(autotune, "DEFAULT_TABLE_PATH", path)

    assert autotune.lookup("self_attention", geom) == {"attn_block_q": 16}
    # tuned takes the table's winner on the card; untuned, an unknown
    # geometry and the CPU (no entries) take no knob: the launch rule
    tuned = KernelPolicy.autotuned()
    assert dispatch._blocks(tuned, "self_attention", geom, "cuda") == {
        "attn_block_q": 16}
    assert dispatch._blocks(KernelPolicy.fused(), "self_attention", geom,
                            "cuda") == {}
    assert dispatch._blocks(tuned, "self_attention", (1, 2, 128, 8, 16),
                            "cuda") == {}
    assert dispatch._blocks(tuned, "self_attention", geom, "cpu") == {}


def test_committed_table_is_valid():
    """The committed table loads (validation is load-time), holds only
    ``cuda`` keys, covers DEFAULT_GEOMS and names the card it came from."""
    table = autotune.load_table()
    assert table["version"] == autotune.AUTOTUNE_VERSION
    assert table["entries"], "the committed table should not be empty"
    for key in table["entries"]:
        backend, op, _ = autotune.parse_key(key)
        assert backend == "cuda" and op in autotune.OP_KNOBS
    for op, geoms in autotune.DEFAULT_GEOMS.items():
        for geom in geoms:
            assert autotune.make_key("cuda", op, geom) in table["entries"]
    gen = table["generated_on"]
    assert gen["backend"] == "cuda" and "H100" in gen["device"]
    assert "W" in gen["device"] and gen["torch"] and gen["cuda"]
    for key, results in table["sweep"].items():
        best = min(results, key=lambda r: r["ms"])["blocks"]
        assert table["entries"][key] == best


def test_tune_with_the_timer_stubbed_writes_a_valid_table(tmp_path,
                                                          monkeypatch):
    """The sweep end to end with the card's clock stubbed: each probe runs
    once on the CPU (its plain version), the stub prefers the middle
    candidate, and the table saves, reloads and hits."""
    monkeypatch.setattr(autotune, "_card",
                        lambda device=None: torch.device("cpu"))
    seen = []

    def fake_min_ms(fn, sets, reps=3):
        fn(*sets[0])
        seen.append(len(sets))
        return (3.0, 2.0, 1.0, 2.0, 3.0)[(len(seen) - 1) % 5]
    monkeypatch.setattr(runtime, "min_ms", fake_min_ms)
    geoms = {"bitmap": ((64, 64, 16),), "reuse": ((1, 64, 8, 8),)}
    table = autotune.tune(geoms, reps=1, verbose=False)
    assert len(table["entries"]) == 2 and set(seen) == {1}
    assert table["entries"]["cpu/bitmap/rows=64,tk=64,patch=16"] == {
        "bitmap_block_rows": 8}
    assert all(len(r) == 5 and all("ms" in c for c in r)
               for r in table["sweep"].values())
    path = autotune.save_table(table, str(tmp_path / "t.json"))
    loaded = autotune.load_table(path)
    won = autotune.lookup("bitmap", (64, 64, 16), backend="cpu", path=path)
    assert won and set(won) == {"bitmap_block_rows"}
    assert loaded["generated_on"]["backend"] == "cpu"
    assert loaded["generated_on"]["torch"] == torch.__version__


def test_tune_off_the_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune.tune(autotune.SMOKE_GEOMS, verbose=False)
    with pytest.raises(ValueError, match="plain versions"):
        autotune.sweep_op("bitmap", (64, 64, 16), device="cpu")


# ----------------------------------------------------------------------------
# Block invariance: every candidate's output equals the JAX kernel's
# ----------------------------------------------------------------------------
def _np_qkv(b=1, h=2, t=96, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, t, d), dtype=np.float32)
                 for _ in range(3))


def test_pssa_counters_match_jax_across_blocks():
    # t = 96 is ragged against every JAX block (the pad-and-slice path)
    q, k, v = _np_qkv(t=96)
    thr = 1.0 / 1024.0
    jouts = [j_pssa(*map(jnp.asarray, (q, k, v)), threshold=thr, patch=16,
                    bq=bq, bk=bk, interpret=True)
             for bq, bk in [(128, 128), (64, 32), (96, 48), (32, 64)]]
    geom = (1, 2, 96, 16, 16)
    for blocks in autotune._op_module("self_attention").autotune_candidates(
            geom):
        out = pssa_attention(*map(torch.from_numpy, (q, k, v)), thr, 16,
                             bq=blocks["attn_block_q"])
        for jo in jouts:
            np.testing.assert_array_equal(out[1].numpy(), np.asarray(jo[1]))
            np.testing.assert_array_equal(out[2].numpy(), np.asarray(jo[2]))
            np.testing.assert_allclose(out[0].numpy(), np.asarray(jo[0]),
                                       rtol=1e-5, atol=1e-5)


def test_bitmap_and_reuse_match_jax_across_blocks():
    rng = np.random.default_rng(0)
    sas = (rng.random((3, 5, 96, 96)) * 2e-3).astype(np.float32)
    base = j_bitmap(jnp.asarray(sas), 16, 1e-3, br=64, interpret=True)
    for br in (None, 2, 4, 8, 16, 32):
        got = patch_bitmap(torch.from_numpy(sas), 16, 1e-3, br=br)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(base[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(base[1]))

    x = rng.standard_normal((2, 96, 8)).astype(np.float32)
    x_ref = (x + 1e-3 * rng.standard_normal((2, 96, 8))).astype(np.float32)
    d0, a0 = j_delta(jnp.asarray(x), jnp.asarray(x_ref), patch=16,
                     threshold=1e-3, bp=3, interpret=True)
    for bp in (None, 2, 4, 8, 16, 32):
        d, a = patch_delta(torch.from_numpy(x), torch.from_numpy(x_ref),
                           patch=16, threshold=1e-3, bp=bp)
        np.testing.assert_array_equal(a.numpy(), np.asarray(a0))
        np.testing.assert_array_equal(d.numpy(), np.asarray(d0))


HOOK_GEOMS = {"self_attention": (1, 2, 64, 8, 16),
              "cross_attention": (1, 2, 64, 8, 77),
              "bitmap": (64, 64, 16),
              "reuse": (1, 64, 8, 8)}


def test_autotune_probe_hooks_cover_knobs():
    """Each family's knobs are JAX's (its field names; the PSSA key tile
    is fixed in the port), its candidates name exactly those, and each
    probe runs on the CPU."""
    for op in autotune._OPS:
        mod = autotune._op_module(op)
        assert mod.AUTOTUNE_KNOBS == autotune.OP_KNOBS[op]
        jknobs = j_autotune._op_knobs(op)
        assert mod.AUTOTUNE_KNOBS == tuple(
            k for k in jknobs if k != "attn_block_k")
        cands = mod.autotune_candidates(HOOK_GEOMS[op])
        assert cands
        for blocks in cands:
            assert set(blocks) == set(mod.AUTOTUNE_KNOBS)
            for name in blocks:
                assert hasattr(JKP(), name)
        fn, sets = mod.autotune_probe(HOOK_GEOMS[op], cands[0],
                                      device="cpu")
        assert len(sets) == 1
        fn(*sets[0])


# the candidate sets at every DEFAULT_GEOMS shape, and the launch rule's
# own choice there (16 rows a warp; the rules of the CUDA sources)
@pytest.mark.parametrize("op", sorted(HOOK_GEOMS))
def test_every_candidate_is_legal_and_an_illegal_knob_raises(op):
    mod = autotune._op_module(op)
    for geom in autotune.DEFAULT_GEOMS[op]:
        cands = mod.autotune_candidates(geom)
        values = {name: {c[name] for c in cands} for name in cands[0]}
        if op == "self_attention":
            assert values == {"attn_block_q": {16, 32, 64}}
            assert (32 if geom[2] <= 256 else 64) in values["attn_block_q"]
        elif op == "cross_attention":
            assert values["cross_block_q"] == (
                {16} if geom[3] > 80 else {16, 32, 64, 128})
        else:
            assert values[mod.AUTOTUNE_KNOBS[0]] == {2, 4, 8, 16, 32}
    q = torch.zeros((1, 1, 64, 96))
    kv = torch.zeros((1, 1, 8, 96))
    calls = {
        "self_attention": [
            lambda: pssa_attention(q, q, q, 0.1, 16, bq=48),
            lambda: pssa_attention(q, q, q, 0.1, 16, bq=0)],
        "cross_attention": [
            lambda: cross_attention_cas(q, kv, kv, bq=32),
            lambda: cross_attention_cas(q[..., :8], kv[..., :8],
                                        kv[..., :8], bq=256)],
        "bitmap": [lambda: patch_bitmap(torch.zeros((64, 64)), 16, 0.1,
                                        br=64)],
        "reuse": [lambda: patch_delta(torch.zeros((1, 64, 8)),
                                      torch.zeros((1, 64, 8)), 8, 0.1,
                                      bp=3)],
    }[op]
    for call in calls:
        with pytest.raises(ValueError, match="expected None or one of"):
            call()


# ----------------------------------------------------------------------------
# Policy surface: the autotuned preset, parse, describe
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["autotuned", "tuned=true",
                                  "ffn=dbsc,ffn_quant=int8"])
def test_compiled_specs_describe_as_jax(spec):
    jview = {k: v for k, v in JKP.parse(spec).describe().items()
             if k not in ("interpret", "interpret_resolved")}
    assert KernelPolicy.parse(spec).describe("cpu") == jview


def test_autotuned_preset_parse_and_describe():
    pol = KernelPolicy.autotuned()
    assert pol.tuned and pol.self_attention == "fused"
    assert KernelPolicy.parse("autotuned") == pol
    # autotuned differs from fused ONLY by the tuned bit
    assert dataclasses.replace(pol, tuned=False) == KernelPolicy.fused()

    spec = KernelPolicy.parse("ffn=dbsc,ffn_quant=int8,tuned=true")
    assert spec.ffn == "dbsc" and spec.ffn_quant == "int8" and spec.tuned
    desc = spec.describe("cpu")
    assert desc["tuned"] is True and desc["ffn_quant"] == "int8"

    with pytest.raises(ValueError, match="ffn_quant"):
        KernelPolicy(ffn_quant="int4")
    with pytest.raises(ValueError, match="tuned"):
        KernelPolicy.parse("tuned=maybe")


# ----------------------------------------------------------------------------
# The int8 route
# ----------------------------------------------------------------------------
def test_int8_accumulators_bitwise_vs_model():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((96, 40), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 56), dtype=np.float32))
    imp = torch.from_numpy(rng.random(96) < 0.5)
    for important in (None, imp):
        ref = bitslice_matmul(x, w, important=important)
        i8 = bitslice_matmul(x, w, important=important, quant_path="int8")
        assert torch.equal(ref.view(torch.int32), i8.view(torch.int32))
    # the integers against the port's plain version and JAX's int8 route,
    # the worst-case magnitudes and an int32 wrap of the shift included
    hi = rng.integers(0, 64, (40, 64)).astype(np.int32)
    lo = rng.integers(0, 64, (40, 64)).astype(np.int32)
    w8 = rng.integers(-128, 128, (64, 24)).astype(np.int32)
    prec = (rng.random((40, 1)) < 0.5).astype(np.int32)
    hi[0], lo[0], w8[:, 0] = 63, 63, -128
    big_k = np.full((17, 8192), 63, np.int32)
    cases = [(hi, lo, w8, prec),
             (big_k, big_k, np.full((8192, 8), 127, np.int32),
              np.ones((17, 1), np.int32))]
    for a, b, c, p in cases:
        got = bitslice_matmul_int8(*map(torch.from_numpy, (a, b, c, p)))
        want = bitslice_matmul_ref(*map(torch.from_numpy, (a, b, c, p)))
        assert got.dtype == torch.int32
        assert torch.equal(got, want)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_int8(*map(jnp.asarray, (a, b, c, p)))))
    assert (cases[1][0].astype(np.int64) @ cases[1][2])[0, 0] << 6 > 2 ** 31
    with pytest.raises(ValueError, match="quant_path"):
        bitslice_matmul(x, w, quant_path="int4")


def test_int8_operands_are_really_int8(monkeypatch):
    """Both products see int8 operands and give int32 (no widened cast)."""
    seen = []
    real = torch._int_mm

    def spy(a, b):
        seen.append((a.dtype, b.dtype))
        out = real(a, b)
        seen.append(out.dtype)
        return out
    monkeypatch.setattr(torch, "_int_mm", spy)
    hi = torch.full((32, 16), 63, dtype=torch.int32)
    w = torch.full((16, 8), -128, dtype=torch.int32)
    prec = torch.ones((32, 1), dtype=torch.int32)
    out = bitslice_matmul_int8(hi, hi, w, prec)
    assert seen == [(torch.int8, torch.int8), torch.int32] * 2
    assert torch.equal(out, bitslice_matmul_ref(hi, hi, w, prec))


# ----------------------------------------------------------------------------
# Engine level: routing moves nothing but time
# ----------------------------------------------------------------------------
PORT_SPECS = ("fused", "autotuned", "ffn=dbsc", "ffn=dbsc,ffn_quant=int8")
JAX_SPECS = ("autotuned", "ffn=dbsc,ffn_quant=int8")


def _cfg(bk, policy):
    cfg = bk.with_kernel_policy(bk.SMOKE, policy)
    return dataclasses.replace(cfg, ddim=dataclasses.replace(
        cfg.ddim, guidance_scale=7.5))


@pytest.fixture(scope="module")
def engine_outputs():
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 256, (1, 8)).astype(np.int32)
    toks[:, 0] = 0
    un = np.zeros_like(toks)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    je = JEngine(_cfg(j_bk, JKP()), key=jax.random.PRNGKey(0))
    params = convert_params(*jax.device_get(
        (je.text_params, je.unet_params, je.vae_params)))
    outs = {}
    for spec in PORT_SPECS:
        cfg = _cfg(t_bk, KernelPolicy.parse(spec, device="cpu"))
        o = TEngine(cfg, device="cpu", params=params).generate(
            torch.from_numpy(toks), uncond_tokens=torch.from_numpy(un),
            latents=torch.from_numpy(lat))
        outs[("port", spec)] = (o.latents.numpy(), o.images.numpy(),
                                t_report(cfg, o.stats).summary())
    for spec in JAX_SPECS:
        cfg = _cfg(j_bk, JKP.parse(spec))
        out = JEngine(cfg, key=jax.random.PRNGKey(0)).generate(
            jnp.asarray(toks), None, uncond_tokens=jnp.asarray(un),
            latents=jnp.asarray(lat))
        outs[("jax", spec)] = (np.asarray(out.latents),
                               np.asarray(out.images),
                               j_report(cfg, out.stats).summary())
    return outs


def test_engine_bit_identical_across_ffn_quant(engine_outputs):
    _, img_model, rep_model = engine_outputs[("port", "ffn=dbsc")]
    _, img_int8, rep_int8 = engine_outputs[("port",
                                            "ffn=dbsc,ffn_quant=int8")]
    np.testing.assert_array_equal(img_int8, img_model)
    assert rep_int8 == rep_model


def test_engine_bit_identical_across_tuned_blocks(engine_outputs):
    _, img_fused, rep_fused = engine_outputs[("port", "fused")]
    _, img_tuned, rep_tuned = engine_outputs[("port", "autotuned")]
    np.testing.assert_array_equal(img_tuned, img_fused)
    assert rep_tuned == rep_fused


def test_engine_energy_headline_identical_across_all_policies(
        engine_outputs):
    base = engine_outputs[("port", "fused")][2]
    for name, (_, _, rep) in engine_outputs.items():
        assert rep["mj_per_iter_with_ema"] \
            == base["mj_per_iter_with_ema"], name


@pytest.mark.parametrize("spec", JAX_SPECS)
def test_engine_matches_jax_under_the_same_spec(engine_outputs, spec):
    lat_t, img_t, rep_t = engine_outputs[("port", spec)]
    lat_j, img_j, rep_j = engine_outputs[("jax", spec)]
    np.testing.assert_allclose(lat_t, lat_j, rtol=0, atol=2e-2)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=2e-3)
    assert rep_t == rep_j


# ----------------------------------------------------------------------------
# The CLI: both compiled-path specs through serve_diffusion.main
# ----------------------------------------------------------------------------
def _serve_cli(capsys, spec):
    from repro_torch.launch import serve_diffusion
    serve_diffusion.main(["--device", "cpu", "--smoke", "--requests", "2",
                          "--micro-batch", "2", "--steps", "2",
                          "--guidance", "7.5", "--ledger", "--kernels",
                          spec])
    head, _, body = capsys.readouterr().out.partition("\n")
    return head, json.loads(body)


@pytest.mark.parametrize("spec,base", [("autotuned", "fused"),
                                       ("ffn=dbsc,ffn_quant=int8",
                                        "ffn=dbsc")])
def test_serve_diffusion_main_serves_the_compiled_specs_on_the_cpu(
        capsys, monkeypatch, spec, base):
    """``--kernels autotuned`` and ``--kernels ffn=dbsc,ffn_quant=int8``
    serve every request with the JAX package's policy view, the int8
    route's products through ``torch._int_mm``, and the same energy
    headline as the spec they differ from only in how they run."""
    calls = []
    real = torch._int_mm

    def spy(a, b):
        calls.append((a.dtype, b.dtype))
        return real(a, b)
    monkeypatch.setattr(torch, "_int_mm", spy)
    head, m = _serve_cli(capsys, spec)
    n_int8 = len(calls)
    _, m_base = _serve_cli(capsys, base)
    assert f"kernels {spec}" in head and "device cpu" in head
    assert m["requests"] == 2 and m["engine_calls"] == 1
    assert m["kernel_policy"] == {
        k: v for k, v in JKP.parse(spec).describe().items()
        if k not in ("interpret", "interpret_resolved")}
    assert m["energy"] == m_base["energy"]
    # 2 products a DBSC matmul; none on the other routes
    assert len(calls) == n_int8
    assert (n_int8 > 0) == (spec != "autotuned") and n_int8 % 2 == 0
    assert set(calls) <= {(torch.int8, torch.int8)}
