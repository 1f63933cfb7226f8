"""The port's package-level names against the JAX package's, on the CPU.

The default configs (``BK_SDM_TINY``, ``SD_VAE``, ``CLIP_TEXT``,
``DIT_S2``) field for field, the policy fields one by one; the PSSA
output-and-``nnz`` oracle (``nnz`` bit for bit, ``out`` within
PSSA_REF_ATOL); ``DISPATCH_TABLE`` against ``_CHOICES`` and
``support_matrix``; the pipeline's ledger methods against the module
functions; the energy report through ``UNetStats.ledger_fetch`` against a
host copy of the whole stats tree, bit for bit in every headline;
``solvers.ddim_transfer``, ``serve --greedy``, the clamped
``policies_from_args`` and the ``LedgerAccum`` keywords; and the package
exports themselves.
"""
import argparse
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import bk_sdm as t_bk
from repro_torch.diffusion import pipeline as t_pipe
from repro_torch.diffusion.engine import DiffusionEngine as TEngine
from repro_torch.diffusion.stats import LedgerAccum, SlotStats
from repro_torch.kernels import dispatch as t_dispatch

pytestmark = pytest.mark.filterwarnings(
    "ignore:jax.experimental.shard_map is deprecated:DeprecationWarning")

PSSA_REF_ATOL = 1e-6
DDIM_ATOL = 1e-6
# the ledger's three headlines, as chip_smoke.py's HEADLINES
HEADLINES = ("total_ema_reduction", "ema_gb_per_iter_optimized",
             "mj_per_iter_with_ema")
# JAX config fields the port does not carry (tests/test_torch_surface.py
# NOT_PORTED gives each its reason)
JAX_ONLY_FIELDS = {"dtype", "dbsc", "use_dbsc_kernel", "tips_threshold"}
POLICY_FIELDS = ("kernel_policy", "precision", "reuse_policy")
CONSTANTS = [("unet", "BK_SDM_TINY", "UNetConfig"),
             ("vae", "SD_VAE", "VAEConfig"),
             ("text_encoder", "CLIP_TEXT", "TextEncoderConfig"),
             ("dit", "DIT_S2", "DiTConfig")]
DIFFUSION_EXPORTS = {
    "UNetConfig": "unet", "init_unet_params": "unet",
    "unet_forward": "unet", "StableDiffusionPipeline": "pipeline",
    "PipelineConfig": "pipeline", "DiffusionEngine": "engine",
    "EngineOutput": "engine", "SlotState": "engine",
    "LedgerAccum": "stats", "SlotStats": "stats", "UNetStats": "stats",
    "attn_layer_order": "stats"}
KERNEL_EXPORTS = {
    "pssa_attention": {"pssa_attention": "ops", "pssa_attention_ref": "ref"},
    "bitslice_matmul": {"bitslice_matmul": "ops",
                        "bitslice_matmul_ref": "ref"},
    "patch_bitmap": {"patch_bitmap": "ops", "patch_bitmap_ref": "ref"},
    "cross_attention_tips": {"cross_attention_cas": "ops"},
    "ssd_scan": {"ssd_scan_fused": "ops"},
}


def _mods(sub):
    return (importlib.import_module(f"repro.diffusion.{sub}"),
            importlib.import_module(f"repro_torch.diffusion.{sub}"))


def _same_policy(t_pol, j_pol) -> int:
    """Every field of the port's policy equals JAX's field of that name;
    returns how many were compared."""
    names = [f.name for f in dataclasses.fields(t_pol)]
    for name in names:
        assert getattr(t_pol, name) == getattr(j_pol, name), name
    return len(names)


@pytest.mark.parametrize("sub,const,cls", CONSTANTS)
def test_default_config_equals_jax_field_for_field(sub, const, cls):
    jm, tm = _mods(sub)
    t_cfg, j_cfg = getattr(tm, const), getattr(jm, const)
    assert t_cfg == getattr(tm, cls)() and type(t_cfg).__name__ == cls
    t_names = {f.name for f in dataclasses.fields(t_cfg)}
    j_names = {f.name for f in dataclasses.fields(j_cfg)}
    assert t_names <= j_names
    assert j_names - t_names == j_names & JAX_ONLY_FIELDS
    for name in sorted(t_names):
        if name in POLICY_FIELDS:
            assert _same_policy(getattr(t_cfg, name),
                                getattr(j_cfg, name)) >= 4, name
        else:
            assert getattr(t_cfg, name) == getattr(j_cfg, name), name
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(t_cfg, sorted(t_names)[0], None)


def test_default_configs_are_the_pipelines_defaults():
    from repro_torch.diffusion.text_encoder import CLIP_TEXT
    from repro_torch.diffusion.unet import BK_SDM_TINY
    from repro_torch.diffusion.vae import SD_VAE
    cfg = t_pipe.PipelineConfig()
    assert (cfg.unet, cfg.text, cfg.vae) == (BK_SDM_TINY, CLIP_TEXT, SD_VAE)
    assert t_bk.CONFIG.unet == BK_SDM_TINY
    assert t_bk.CONFIG.text == CLIP_TEXT and t_bk.CONFIG.vae == SD_VAE


def test_num_down_attn_layers_matches_jax():
    jm, tm = _mods("unet")
    for j_cfg, t_cfg in [(jm.BK_SDM_TINY, tm.BK_SDM_TINY),
                         (jm.BK_SDM_TINY.smoke(), tm.BK_SDM_TINY.smoke()),
                         (jm.UNetConfig(resnets_per_down=2,
                                        transformer_depth=2),
                          tm.UNetConfig(resnets_per_down=2,
                                        transformer_depth=2))]:
        assert t_cfg.num_down_attn_layers == j_cfg.num_down_attn_layers
    assert tm.BK_SDM_TINY.num_down_attn_layers == 3


@pytest.mark.parametrize("threshold", [0.0, 1.0 / 8192.0, 0.02])
def test_pssa_attention_ref_matches_jax(threshold):
    from repro.kernels.pssa_attention.ref import pssa_attention_ref as j_ref
    from repro_torch.kernels.pssa_attention import pssa_attention_ref
    from repro_torch.kernels.pssa_attention.ref import (
        pssa_attention_stats_ref)
    rng = np.random.default_rng(31)
    q, k, v = (rng.standard_normal((4, 64, 16)).astype(np.float32)
               for _ in range(3))
    out, nnz = pssa_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  threshold)
    j_out, j_nnz = j_ref(*map(jnp.asarray, (q, k, v)), threshold)
    assert nnz.dtype == torch.int32 and tuple(nnz.shape) == (4, 64)
    np.testing.assert_array_equal(nnz.numpy(), np.asarray(j_nnz))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=PSSA_REF_ATOL)
    s_out, s_nnz, _ = pssa_attention_stats_ref(
        *map(torch.from_numpy, (q, k, v)), threshold, 16)
    assert torch.equal(out, s_out) and torch.equal(nnz, s_nnz)
    if threshold == 0.02:
        assert 0 < int(nnz.sum()) < nnz.numel() * 64      # some pruned


def test_dispatch_table_covers_policy_choices():
    """Twin of the JAX package's own test of its table, whose op and
    implementation keys are JAX's ``_CHOICES``, in order."""
    from repro.kernels import dispatch as j_dispatch
    assert t_dispatch._CHOICES == j_dispatch._CHOICES
    for op, impls in t_dispatch.DISPATCH_TABLE.items():
        assert set(impls) == set(t_dispatch._CHOICES[op])
    assert list(t_dispatch.DISPATCH_TABLE) == list(t_dispatch._CHOICES)
    ops = {row["op"] for row in t_dispatch.support_matrix()}
    assert ops == set(t_dispatch.DISPATCH_TABLE)
    for row in t_dispatch.support_matrix():
        assert row["kernel"] == t_dispatch._KERNELS.get(
            (row["op"], row["impl"]))
        assert callable(t_dispatch.DISPATCH_TABLE[row["op"]][row["impl"]])


def test_ffn_dispatch_reads_the_table(monkeypatch):
    seen = []
    monkeypatch.setitem(t_dispatch.DISPATCH_TABLE["ffn"], "dbsc",
                        lambda *a: seen.append(a) or "dbsc")
    pol = t_dispatch.KernelPolicy(ffn="dbsc")
    assert t_dispatch.ffn_geglu(pol, "hn", "p", None) == "dbsc"
    assert seen == [(pol, "hn", "p", None, None)]


@pytest.fixture(scope="module")
def smoke_runs():
    """Two guided calls of the port's engine on the smoke UNet, batch 1
    and batch 2, from seeded tokens and latents."""
    cfg = dataclasses.replace(t_bk.SMOKE, ddim=dataclasses.replace(
        t_bk.SMOKE.ddim, guidance_scale=7.5))
    params = t_pipe.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    eng = TEngine(cfg, device="cpu", params=params)
    rng = np.random.default_rng(5)
    stats = []
    for batch in (1, 2):
        toks = rng.integers(1, 256, (batch, 8)).astype(np.int32)
        toks[:, 0] = 0
        lat = rng.standard_normal((batch, 16, 16, 4)).astype(np.float32)
        out = eng.generate(torch.from_numpy(toks),
                           uncond_tokens=torch.zeros((batch, 8),
                                                     dtype=torch.int32),
                           latents=torch.from_numpy(lat))
        stats.append(out.stats)
    return cfg, params, stats


def test_ledger_fetch_copies_the_ledger_leaves_only(smoke_runs):
    stats = smoke_runs[2][1]
    got = stats.ledger_fetch()
    assert got.layers == stats.layers
    for a, b in zip(got.tips, stats.tips):
        assert a.important is b.important and a.cas is b.cas
        assert torch.equal(a.low_precision_ratio, b.low_precision_ratio)
    for kind in ("pssa", "reuse"):
        for a, b in zip(getattr(got, kind), getattr(stats, kind)):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_energy_report_through_ledger_fetch_is_the_cpu_route(smoke_runs):
    """``energy_report_multi`` (which fetches through ``ledger_fetch``)
    equals the report over host copies of the whole stats trees (the
    route before ``ledger_fetch``), stacked and as per-step lists, in
    every headline bit for bit.  ``tests/test_torch_pipeline.py`` holds
    the report against the JAX package's."""
    cfg, _, t_stats = smoke_runs
    got = t_pipe.energy_report_multi(cfg, t_stats).summary()
    routes = {
        "cpu": [s.cpu() for s in t_stats],
        "per-step": [[st.cpu() for st in s.unstack()] for s in t_stats],
        "fetched twice": [s.ledger_fetch() for s in t_stats],
    }
    for name, stats in routes.items():
        want = t_pipe.energy_report_multi(cfg, stats).summary()
        for key in HEADLINES:
            assert got[key] == want[key], (name, key)
        assert got == want, name
    assert all(np.isfinite(got[key]) for key in HEADLINES)


def test_pipeline_ledger_methods_equal_the_module_functions(smoke_runs):
    tcfg, params, runs = smoke_runs
    pipe = t_pipe.StableDiffusionPipeline(tcfg, device="cpu", params=params)
    stats = runs[0]
    for full in (True, False):
        assert (pipe.energy_report(stats, full_geometry=full).summary()
                == t_pipe.energy_report(tcfg, stats,
                                        full_geometry=full).summary())
    assert pipe.energy_report(stats).summary() == \
        t_pipe.energy_report(tcfg, stats).summary()
    for one in stats.unstack():
        assert pipe.measured_sas_ratios(one) == \
            t_pipe.measured_sas_ratios(one)
        assert pipe.measured_tips_ratio(one) == \
            t_pipe.measured_tips_ratio(one)


def test_pipeline_reexports_match_jax():
    from repro.diffusion import ledger as j_ledger
    from repro.diffusion import pipeline as j_pipeline
    from repro_torch.diffusion import ledger as t_ledger
    assert t_pipe.TIPS_ACTIVE_ITERS == j_pipeline.TIPS_ACTIVE_ITERS == 20
    assert t_ledger.DRAM_PJ_PER_BYTE == j_ledger.DRAM_PJ_PER_BYTE


def test_ddim_transfer_is_a_solvers_name_and_matches_jax():
    from repro.diffusion import solvers as j_solvers
    from repro_torch.diffusion import sampler as t_sampler
    from repro_torch.diffusion import solvers as t_solvers
    rng = np.random.default_rng(2)
    lat, eps = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
                for _ in range(2))
    a_t, a_prev = (rng.uniform(0.05, 0.95, (2, 1, 1, 1)).astype(np.float32)
                   for _ in range(2))
    got = t_solvers.ddim_transfer(*map(torch.from_numpy,
                                       (lat, eps, a_t, a_prev)))
    want = j_solvers.ddim_transfer(*map(jnp.asarray,
                                        (lat, eps, a_t, a_prev)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=DDIM_ATOL)
    acp = t_sampler.alphas_cumprod(t_sampler.DDIMConfig())
    step = t_sampler.ddim_step(torch.from_numpy(lat), torch.from_numpy(eps),
                               960, 920, acp)
    assert torch.equal(step, t_solvers.ddim_transfer(
        torch.from_numpy(lat), torch.from_numpy(eps), acp[960], acp[920]))


def test_serve_takes_greedy(capsys):
    from repro_torch.launch import serve
    argv = ["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
            "--batch", "1", "--prompt-len", "4", "--new-tokens", "2"]
    samples = []
    for extra in ([], ["--greedy"]):
        serve.main(argv + extra)
        samples.append([ln for ln in capsys.readouterr().out.splitlines()
                        if ln.startswith("sample:")])
    assert samples[0] == samples[1] and len(samples[0]) == 1


def test_policies_from_args_clamps_like_jax():
    from repro.launch import cli as j_cli
    from repro_torch.launch import cli as t_cli
    argv = ["--reuse", "edit"]
    tns = t_cli.add_policy_args(argparse.ArgumentParser()).parse_args(argv)
    jns = j_cli.add_policy_args(argparse.ArgumentParser()).parse_args(argv)
    tns.device = "cpu"
    t_reuse = t_cli.policies_from_args(tns).reuse
    j_reuse = j_cli.policies_from_args(jns).reuse
    assert _same_policy(t_reuse, j_reuse) == 4
    assert t_reuse.capacity == 1.0


def test_ledger_accum_takes_the_jax_keywords():
    from repro_torch.core.pssa import PSSARowCounters
    from repro_torch.core.tips import TIPSRowCounters
    acc = LedgerAccum.zeros(num_steps=3, num_layers=1)
    assert tuple(acc.nnz.shape) == (3, 1) and tuple(acc.rows.shape) == (3,)
    row = torch.tensor([2, 5])
    stats = SlotStats.from_layer_list(
        ["l0"], [PSSARowCounters(nnz=row, ones_xor=row + 1)],
        [TIPSRowCounters(important=row)])
    idx, active = torch.tensor([0, 2]), torch.tensor([True, True])
    by_name = acc.scatter(step_idx=idx, active=active, slot_stats=stats)
    by_place = acc.scatter(idx, active, stats)
    for f in dataclasses.fields(LedgerAccum):
        assert torch.equal(getattr(by_name, f.name),
                           getattr(by_place, f.name))
    assert by_name.nnz[:, 0].tolist() == [2, 0, 5]


def test_diffusion_package_exports_the_jax_names():
    import repro.diffusion as j_diffusion
    import repro_torch.diffusion as t_diffusion
    assert set(t_diffusion.__all__) == set(DIFFUSION_EXPORTS)
    for name, sub in DIFFUSION_EXPORTS.items():
        assert hasattr(j_diffusion, name)
        mod = importlib.import_module(f"repro_torch.diffusion.{sub}")
        assert getattr(t_diffusion, name) is getattr(mod, name)
        assert name in dir(t_diffusion)
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        t_diffusion.nope
    from repro_torch.diffusion import DiffusionEngine, PipelineConfig
    assert DiffusionEngine is TEngine
    assert PipelineConfig is t_pipe.PipelineConfig


@pytest.mark.parametrize("pkg", sorted(KERNEL_EXPORTS))
def test_kernel_package_exports_the_jax_names(pkg):
    j_pkg = importlib.import_module(f"repro.kernels.{pkg}")
    t_pkg = importlib.import_module(f"repro_torch.kernels.{pkg}")
    for name, sub in KERNEL_EXPORTS[pkg].items():
        assert hasattr(j_pkg, name)
        mod = importlib.import_module(f"repro_torch.kernels.{pkg}.{sub}")
        assert getattr(t_pkg, name) is getattr(mod, name)
    assert sorted(t_pkg.__all__) == sorted(KERNEL_EXPORTS[pkg])
