"""Port parity: the serving-policy surface and the scheduler's host-side
helpers, against the JAX package.

Covers ``KernelPolicy.parse/describe`` and ``support_matrix``,
``PrecisionPolicy.parse/describe``, ``ServePolicies``, the shared CLI
wiring (``launch.cli``), ``serve_diffusion.micro_batches``, the arrival
traces, ``scheduler._latency_metrics``,
``tips.workload_low_precision_fraction`` and
``pipeline.measured_sas_ratios / measured_tips_ratio``.  No model runs
here.  Tolerances: none; every value is compared for equality (the
policy views key for key on the port's axes, i.e. the JAX ``describe``
less ``interpret`` and ``interpret_resolved``).

The port's ``KernelPolicy.auto`` means what the JAX package's does:
``fused()`` (float FFN) on the card, ``reference()`` on the CPU.
"""
import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tips as j_tips
from repro.core.pssa import PSSAStats as JPSSAStats
from repro.core.tips import TIPSResult as JTIPSResult
from repro.core.policies import ServePolicies as JServe
from repro.core.precision import PrecisionPolicy as JPP
from repro.diffusion import pipeline as j_pipe
from repro.diffusion.solvers import SamplerPolicy as JSampler
from repro.diffusion.stats import LayerKey as JLayerKey
from repro.diffusion.stats import UNetStats as JUNetStats
from repro.kernels.dispatch import KernelPolicy as JKP
from repro.launch import cli as j_cli
from repro.launch import scheduler as j_sched
from repro.launch import serve_diffusion as j_serve
from repro_torch.core import tips as t_tips
from repro_torch.core.policies import ServePolicies
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.pssa import PSSAStats
from repro_torch.core.tips import TIPSResult
from repro_torch.diffusion import pipeline as t_pipe
from repro_torch.diffusion.solvers import SamplerPolicy
from repro_torch.diffusion.stats import LayerKey, UNetStats
from repro_torch.kernels.dispatch import KernelPolicy, support_matrix
from repro_torch.launch import cli as t_cli
from repro_torch.launch import scheduler as t_sched
from repro_torch.launch import serve_diffusion as t_serve

OPS = ("self_attention", "cross_attention", "ffn", "bitmap", "reuse")
JAX_ONLY_KEYS = ("interpret", "interpret_resolved")


def _jax_view(d: dict) -> dict:
    """A JAX kernel-policy view on the port's axes."""
    return {k: v for k, v in d.items() if k not in JAX_ONLY_KEYS}


def _serve_view(d: dict) -> dict:
    return dict(d, kernels=_jax_view(d["kernels"]))


# ---------------------------------------------------------------------------
# KernelPolicy
# ---------------------------------------------------------------------------
KERNEL_SPECS = ["reference", "fused", "auto", "self_attention=fused",
                "self_attention=fused,ffn=dbsc",
                "self_attention=fused,cross_attention=fused,ffn=dbsc",
                "bitmap=kernel,reuse=kernel", " fused ",
                "ffn=dbsc,ffn_quant=model"]
# the compiled-path policy: the autotuned preset, tuned= and the int8 route
COMPILED_SPECS = ["autotuned", "tuned=true",
                  "self_attention=fused,tuned=false",
                  "ffn=dbsc,ffn_quant=int8",
                  "ffn=dbsc,ffn_quant=int8,tuned=true"]


@pytest.mark.parametrize("spec", KERNEL_SPECS)
def test_kernel_policy_parse_matches_jax(spec):
    j, t = JKP.parse(spec), KernelPolicy.parse(spec, device="cpu")
    assert {op: getattr(t, op) for op in OPS} == \
        {op: getattr(j, op) for op in OPS}
    assert t.describe("cpu") == _jax_view(j.describe())


@pytest.mark.parametrize("spec", COMPILED_SPECS)
def test_kernel_policy_compiled_specs_match_jax(spec):
    """``autotuned``, ``tuned=`` and ``ffn_quant=int8`` parse as the JAX
    package parses them."""
    j, t = JKP.parse(spec), KernelPolicy.parse(spec, device="cpu")
    assert {op: getattr(t, op) for op in (*OPS, "tuned", "ffn_quant")} == \
        {op: getattr(j, op) for op in (*OPS, "tuned", "ffn_quant")}
    assert t.describe("cpu") == _jax_view(j.describe())


@pytest.mark.parametrize("spec,match", [
    ("self_attention=nope", "self_attention"), ("warp_drive=fused", "op"),
    ("fused,ffn=dbsc", "preset")])
def test_kernel_policy_bad_specs_raise_in_both(spec, match):
    with pytest.raises(ValueError):
        JKP.parse(spec)
    with pytest.raises(ValueError, match=match):
        KernelPolicy.parse(spec, device="cpu")


@pytest.mark.parametrize("spec,match", [
    ("fused,tuned=false", "preset"),
    ("interpret=true", "interpreter"), ("interpret=auto", "interpreter")])
def test_kernel_policy_refuses_what_the_port_lacks(spec, match):
    """A preset with overrides raises as in the JAX package, and
    ``interpret=`` (the kernels are CUDA and have no interpreter) raises;
    no spec maps silently onto another preset."""
    with pytest.raises(ValueError, match=match):
        KernelPolicy.parse(spec, device="cpu")


def test_kernel_policy_auto_is_the_jax_meaning(monkeypatch):
    """On the card ``auto`` is ``fused()`` with the float FFN (DBSC is an
    explicit ``ffn=dbsc``); on the CPU it is the reference."""
    assert KernelPolicy.auto("cpu") == KernelPolicy.reference()
    assert JKP.parse("auto") == JKP.reference()
    assert KernelPolicy.parse("auto", device="cpu").describe("cpu") == \
        _jax_view(JKP.parse("auto").describe())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for pol in (KernelPolicy.auto(), KernelPolicy.auto("cuda"),
                KernelPolicy.parse("auto"),
                ServePolicies.parse().kernels):
        assert pol == KernelPolicy.fused()
        assert pol.ffn == "reference"
    assert {op: getattr(KernelPolicy.auto(), op) for op in OPS} == \
        {op: getattr(JKP.fused(), op) for op in OPS}
    assert KernelPolicy.fused().describe()["backend"] == "cuda"


def test_kernel_policy_auto_on_a_host_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelPolicy.parse("auto")


def test_support_matrix_rows():
    rows = support_matrix()
    impls = {"self_attention": "fused", "cross_attention": "fused",
             "ffn": "dbsc", "bitmap": "kernel", "reuse": "kernel"}
    assert [(r["op"], r["impl"]) for r in rows] == [
        (op, impl) for op in OPS for impl in ("reference", impls[op])]
    kernels = {r["kernel"] for r in rows} - {None}
    assert kernels == {"pssa_attention", "cross_attention_tips",
                       "bitslice_matmul", "patch_bitmap", "patch_delta"}
    for r in rows:
        if r["impl"] == "reference":
            assert r["kernel"] is None and r["cuda"] == r["cpu"] == "native"
        else:
            assert r["cuda"] == f"sm_90a kernel (csrc/{r['kernel']}.cu)"
            assert r["cpu"] == "plain PyTorch version"


# ---------------------------------------------------------------------------
# PrecisionPolicy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    "fixed", "adaptive", "", "adaptive,target=0.5,mid=true",
    "threshold=0.02", "cls=1", "spotting=adaptive,target=0.3",
    "fixed,mid=false,threshold=0.1"])
def test_precision_policy_parse_matches_jax(spec):
    t, j = PrecisionPolicy.parse(spec), JPP.parse(spec)
    assert t.describe() == j.describe()
    assert t == PrecisionPolicy(**j.describe())


@pytest.mark.parametrize("spec", ["warp=9", "bogus", "mid=maybe",
                                  "spotting=never", "target=1.5"])
def test_precision_policy_bad_specs_raise_in_both(spec):
    with pytest.raises(ValueError):
        JPP.parse(spec)
    with pytest.raises(ValueError):
        PrecisionPolicy.parse(spec)


# ---------------------------------------------------------------------------
# ServePolicies
# ---------------------------------------------------------------------------
SERVE_SPECS = [
    {},
    dict(kernels="fused", tips="adaptive,target=0.5",
         reuse="temporal,threshold=0.1", tiers=["draft", "balanced"]),
    dict(kernels="self_attention=fused,ffn=dbsc", tips="fixed,mid=true",
         solver="dpm2m,steps=10,phases=detail_guard"),
    dict(kernels="reference", reuse="edit,window=4:4:8:8",
         tiers=["draft", "ddim,steps=6", "quality"]),
    dict(solver="balanced", reuse="temporal"),
]


@pytest.mark.parametrize("specs", SERVE_SPECS)
def test_serve_policies_parse_describe_matches_jax(specs):
    t = ServePolicies.parse(**specs, device="cpu")
    j = JServe.parse(**specs)
    assert t.describe("cpu") == _serve_view(j.describe())
    again = ServePolicies.parse(**specs, device="cpu")
    assert again == t and hash(again) == hash(t) and again.key() == t.key()


def test_serve_policies_bundle_semantics():
    assert ServePolicies.parse(device="cpu") == ServePolicies()
    assert ServePolicies().key() == (KernelPolicy(), PrecisionPolicy(),
                                     ServePolicies().reuse, None, None)
    with pytest.raises(ValueError, match="exclusive"):
        ServePolicies.parse(solver="draft", tiers=["draft", "quality"],
                            device="cpu")
    with pytest.raises(ValueError, match="not an entry"):
        ServePolicies(sampler=SamplerPolicy.parse("draft"),
                      bank=(SamplerPolicy.parse("quality"),))
    pol = ServePolicies.parse(kernels="fused", tips="adaptive",
                              device="cpu")
    bank = (SamplerPolicy.parse("draft"), SamplerPolicy.parse("quality"))
    swapped = pol.with_sampling(sampler=bank[0], bank=list(bank))
    assert swapped.kernels == pol.kernels
    assert swapped.precision == pol.precision and swapped.bank == bank
    cfg = pol.apply(t_pipe.PipelineConfig.smoke())
    assert cfg.unet.kernel_policy == KernelPolicy.fused()
    assert cfg.unet.precision.spotting == "adaptive"
    assert ServePolicies.from_config(cfg.unet) == pol


# ---------------------------------------------------------------------------
# The shared CLI wiring
# ---------------------------------------------------------------------------
def _namespace(mod, argv, device):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--guidance", type=float, default=1.0)
    if device:
        ap.add_argument("--device", default=None)
    mod.add_policy_args(ap)
    return ap.parse_args(argv + (["--device", "cpu"] if device else []))


def _shared_fields(t, j, skip=()) -> int:
    """Every field of the port's config that the JAX config also has is
    equal; returns how many were compared."""
    n = 0
    for f in dataclasses.fields(t):
        if f.name in skip or not hasattr(j, f.name):
            continue
        assert getattr(t, f.name) == getattr(j, f.name), f.name
        n += 1
    return n


def _same_config(t_cfg, j_cfg):
    assert dataclasses.asdict(t_cfg.ddim) == dataclasses.asdict(j_cfg.ddim)
    assert _shared_fields(t_cfg.text, j_cfg.text) >= 6
    assert _shared_fields(t_cfg.vae, j_cfg.vae) >= 3
    assert type(t_cfg.unet).__name__ == type(j_cfg.unet).__name__
    assert _shared_fields(t_cfg.unet, j_cfg.unet, skip=(
        "kernel_policy", "precision", "reuse_policy")) >= 10
    assert t_cfg.unet.kernel_policy.describe("cpu") == _jax_view(
        j_cfg.unet.kernel_policy.describe())
    assert t_cfg.unet.precision.describe() == j_cfg.unet.precision.describe()
    assert t_cfg.unet.reuse_policy.describe() == \
        j_cfg.unet.reuse_policy.describe()


@pytest.mark.parametrize("argv", [
    [], ["--smoke"], ["--model", "dit"], ["--model", "dit", "--smoke"],
    ["--smoke", "--steps", "25", "--guidance", "7.5"],
    ["--smoke", "--steps", "1"],
    ["--smoke", "--kernels", "fused", "--tips", "adaptive", "--reuse",
     "temporal", "--tiers", "draft", "balanced"],
    ["--kernels", "self_attention=fused,cross_attention=fused,ffn=dbsc",
     "--solver", "dpm2m,steps=12"],
    ["--smoke", "--reuse", "edit,threshold=0.2"]])
def test_cli_wiring_matches_jax(argv):
    tns, jns = _namespace(t_cli, argv, True), _namespace(j_cli, argv, False)
    tpol, jpol = t_cli.policies_from_args(tns), j_cli.policies_from_args(jns)
    assert tpol.describe("cpu") == _serve_view(jpol.describe())
    _same_config(t_cli.config_from_args(tns), j_cli.config_from_args(jns))
    _same_config(t_serve.make_config(tns), j_serve.make_config(jns))


def test_cli_wiring_clamps_serving_reuse_capacity():
    tns = _namespace(t_cli, ["--reuse", "edit"], True)
    jns = _namespace(j_cli, ["--reuse", "edit"], False)
    pol = t_cli.policies_from_args(tns)
    assert pol.reuse.enabled and pol.reuse.capacity == 1.0
    raw = ServePolicies.parse(reuse="edit", device="cpu")
    assert raw.reuse.capacity < 1.0
    assert raw.reuse.describe() == j_cli.policies_from_args(
        jns, clamp_reuse_capacity=False).reuse.describe()


# ---------------------------------------------------------------------------
# micro_batches, traces, latency metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,batch", [(1, 1), (1, 4), (3, 2), (4, 2),
                                     (5, 4), (7, 3), (8, 8), (0, 4)])
def test_micro_batches_match_jax(n, batch):
    reqs = np.arange(n * 5, dtype=np.int32).reshape(n, 5)
    t = t_serve.micro_batches(torch.from_numpy(reqs), batch)
    j = j_serve.micro_batches(jnp.asarray(reqs), batch)
    assert [v for _, v in t] == [v for _, v in j]
    for (tc, _), (jc, _) in zip(t, j):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("n,burst,gap,start", [
    (6, 2, 0.5, 0.0), (7, 3, 0.1, 1.25), (5, 1, 0.0, 0.0), (4, 0, 0.3, 0.0),
    (9, 4, 0.3333, 0.5)])
def test_bursty_trace_matches_jax(n, burst, gap, start):
    assert t_sched.bursty_trace(n, burst, gap, start) == \
        j_sched.bursty_trace(n, burst, gap, start)


@pytest.mark.parametrize("n,rate,seed", [(5, 4.0, 3), (16, 0.75, 0),
                                         (8, 1e-12, 1)])
def test_poisson_trace_matches_jax(n, rate, seed):
    t = t_sched.poisson_trace(n, rate, seed=seed)
    j = j_sched.poisson_trace(n, rate, seed=seed)
    assert np.array_equal(np.asarray(t), np.asarray(j))
    assert t != t_sched.poisson_trace(n, rate, seed=seed + 1)


def test_apply_trace_and_poll_arrivals_match_jax():
    arrivals = [0.0, 0.0, 0.5, 0.25, 1.0]
    out = {}
    for mod in (t_sched, j_sched):
        reqs = mod.apply_trace([mod.Request(rid=i, tokens=None,
                                            arrival_s=-1.0)
                                for i in range(5)], arrivals)
        pending = sorted(reqs, key=lambda r: (r.arrival_s, r.rid))
        ready = []
        mod.poll_arrivals(pending, ready, 0.3)
        out[mod] = ([r.rid for r in ready], [r.rid for r in pending])
    assert out[t_sched] == out[j_sched] == ([0, 1, 3], [2, 4])


def _timed(mod, rows, bank):
    reqs = []
    for i, (arr, adm, fin, tier, deg) in enumerate(rows):
        reqs.append(mod.Request(
            rid=i, tokens=None, arrival_s=arr, admitted_s=adm,
            finished_s=fin, policy_index=i % len(bank) if bank else 0,
            tier=tier, degraded_from=deg))
    return reqs


@pytest.mark.parametrize("case", ["plain", "single", "tiers", "degraded"])
def test_latency_metrics_match_jax(case):
    rng = np.random.default_rng(5)
    n = 1 if case == "single" else 7
    arr = np.sort(rng.uniform(0, 2, n))
    adm = arr + rng.uniform(0, 0.5, n)
    fin = adm + rng.uniform(0.1, 1.0, n)
    tiers = ["", ""] if case in ("plain", "single") else ["draft", "quality"]
    deg = ["", "quality"] if case == "degraded" else ["", ""]
    rows = [(float(arr[i]), float(adm[i]), float(fin[i]), tiers[i % 2],
             deg[i % 2]) for i in range(n)]
    tbank = jbank = None
    if case != "plain":
        tbank = (SamplerPolicy.parse("draft"), SamplerPolicy.parse("quality"))
        jbank = (JSampler.parse("draft"), JSampler.parse("quality"))
    t = t_sched._latency_metrics(_timed(t_sched, rows, tbank), 3.5,
                                 bank=tbank, default_steps=5)
    j = j_sched._latency_metrics(_timed(j_sched, rows, jbank), 3.5,
                                 bank=jbank, default_steps=5)
    assert t == j
    assert ("per_tier" in t) == (case in ("tiers", "degraded"))
    assert ("degraded_requests" in t) == (case == "degraded")


# ---------------------------------------------------------------------------
# TIPS workload fraction and the measured ratios
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _DDIM:
    tips_active_iters: int
    num_inference_steps: int


@pytest.mark.parametrize("n,kw", [
    (25, {}), (5, dict(ddim=_DDIM(4, 5))), (25, dict(active_iters=20,
                                                       total_iters=25)),
    (3, dict(ddim=_DDIM(1, 3), total_iters=4)), (12, dict(active_iters=7))])
def test_workload_low_precision_fraction_matches_jax(n, kw):
    ratios = np.random.default_rng(n).uniform(0, 1, n).astype(np.float32)
    t = t_tips.workload_low_precision_fraction(
        [float(r) for r in ratios], **kw)
    j = j_tips.workload_low_precision_fraction(jnp.asarray(ratios), **kw)
    assert t.dtype == torch.float32
    assert float(t) == float(j)


def _stats(layer, pssa, tips_cls, stats_cls, arr, seed):
    rng = np.random.default_rng(seed)
    layers, ps, ts = [], [], []
    for i, (tag, res, rows) in enumerate([("down0.0", 16, 2),
                                          ("down1.0", 8, 2),
                                          ("up1.0", 8, 4), ("up2.1", 16, 1)]):
        layers.append(layer(tag, res))
        vals = rng.uniform(1, 1e6, 10).astype(np.float32)
        ps.append(pssa(*(arr(v) for v in vals)))
        imp = rng.uniform(size=(rows, res * res) if rows > 1
                          else (res * res,)) < 0.4
        ts.append(tips_cls(arr(imp), arr(np.zeros(imp.shape, np.float32)),
                           arr(np.float32(1.0 - imp.mean()))))
    return stats_cls.from_layer_list(layers, ps, ts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_measured_ratios_match_jax(seed):
    t = _stats(LayerKey, PSSAStats, TIPSResult, UNetStats,
               lambda x: torch.as_tensor(np.asarray(x)), seed)
    j = _stats(JLayerKey, JPSSAStats, JTIPSResult, JUNetStats,
               jnp.asarray, seed)
    t_sas, j_sas = t_pipe.measured_sas_ratios(t), \
        j_pipe.measured_sas_ratios(j)
    assert t_sas == j_sas and sorted(t_sas) == [8, 16]
    assert t_pipe.measured_tips_ratio(t) == j_pipe.measured_tips_ratio(j)


# ---------------------------------------------------------------------------
# The engine takes the bundle
# ---------------------------------------------------------------------------
def test_engine_takes_the_bundle():
    from repro_torch.configs import bk_sdm
    from repro_torch.diffusion.engine import DiffusionEngine

    pol = ServePolicies.parse(kernels="fused", tips="adaptive",
                              reuse="temporal", solver="dpm2m,steps=2",
                              device="cpu")
    eng = DiffusionEngine(bk_sdm.SMOKE, device="cpu", policies=pol)
    assert eng.cfg.unet.kernel_policy == KernelPolicy.fused()
    assert eng.cfg.unet.reuse_policy.enabled
    assert eng.policies == pol
    toks = torch.zeros((1, eng.cfg.text.max_len), dtype=torch.int32)
    out = eng.generate(toks, torch.Generator().manual_seed(0))
    assert out.stats.num_steps == 2          # the bundle's sampler
    eng.set_precision(PrecisionPolicy.fixed(0.1))
    assert eng.policies.precision == PrecisionPolicy.fixed(0.1)
    assert eng.denoiser.cfg.precision == PrecisionPolicy.fixed(0.1)
    tiered = ServePolicies.parse(tiers=["ddim,steps=2", "dpm2m,steps=3"],
                                 device="cpu")
    eng = DiffusionEngine(bk_sdm.SMOKE, device="cpu", policies=tiered)
    assert eng.init_slots(2).bank == tiered.bank
    assert t_sched.ContinuousScheduler(eng, 2).bank == tiered.bank
    # the capacity < 1 refusal applies to the bundle's reuse policy
    with pytest.raises(ValueError, match="capacity"):
        DiffusionEngine(bk_sdm.SMOKE, device="cpu", policies=ServePolicies(
            reuse=ServePolicies.parse(reuse="edit", device="cpu").reuse))


# ---------------------------------------------------------------------------
# The config presets and layer_channels against the JAX package's
# ---------------------------------------------------------------------------
PRESETS = ("CONFIG", "SMOKE", "FUSED", "SMOKE_FUSED", "ADAPTIVE",
           "PAPER_PRECISION")


@pytest.mark.parametrize("family", ("bk_sdm", "dit_s"))
def test_config_presets_match_jax(family):
    """Each preset's policy fields (kernel routing, precision) and
    geometry equal the JAX package's preset of the same name."""
    import importlib
    t_mod = importlib.import_module(f"repro_torch.configs.{family}")
    j_mod = importlib.import_module(f"repro.configs.{family}")
    for name in PRESETS:
        t_unet, j_unet = getattr(t_mod, name).unet, getattr(j_mod, name).unet
        t_kp, j_kp = t_unet.kernel_policy, j_unet.kernel_policy
        fields = (*OPS, "tuned", "ffn_quant")
        assert {f: getattr(t_kp, f) for f in fields} == \
            {f: getattr(j_kp, f) for f in fields}, name
        assert t_kp.describe("cpu") == _jax_view(j_kp.describe()), name
        assert t_unet.precision.describe() == \
            j_unet.precision.describe(), name
        assert t_unet.latent_size == j_unet.latent_size, name


@pytest.mark.parametrize("family", ("bk_sdm", "dit_s"))
def test_layer_channels_matches_jax(family):
    import importlib

    from repro.core.reuse import layer_channels as j_layer_channels
    from repro_torch.core.reuse import layer_channels
    for name in ("CONFIG", "SMOKE"):
        t_unet = getattr(importlib.import_module(
            f"repro_torch.configs.{family}"), name).unet
        j_unet = getattr(importlib.import_module(
            f"repro.configs.{family}"), name).unet
        assert t_unet.attn_resolutions() == j_unet.attn_resolutions()
        for res in t_unet.attn_resolutions():
            assert layer_channels(t_unet, res) == \
                j_layer_channels(j_unet, res) > 0, (name, res)

    class Plain:            # the UNet rule, no channels_at hook
        latent_size = 64
        block_channels = (320, 640, 1280, 1280)
    assert [layer_channels(Plain, r) for r in (64, 32, 16, 8)] == \
        [j_layer_channels(Plain, r) for r in (64, 32, 16, 8)] == \
        [320, 640, 1280, 1280]
