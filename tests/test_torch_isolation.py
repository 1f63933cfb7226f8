"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
nothing of JAX or of the JAX package, and the port never runs on the CPU
unless asked to."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = ("quickstart", "tips_visualization", "generate_image",
            "serve_lm", "train_lm")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import repro_torch.diffusion.engine
import torch
from repro_torch.core import pssa, quant, tips
x = torch.rand(2, 4, 32, 32).softmax(-1)
pssa.ema_reduction(pssa.compress_stats(x, 8))
pssa.compress_decompress(x, 8)
r = tips.spot(x, 0.05)
tips.adaptive_threshold(r.cas, 0.448)
tips.tips_schedule(3)
quant.dequantize(quant.quantize_act(x))
quant.fake_quant_act(x)
quant.fake_quant_weight(x)
quant.bitslice_merge(*quant.bitslice_split(quant.quantize_act(x).values))
quant.quantized_matmul_reference(x[0, 0], x[0, 1])
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro"
             or n.startswith("repro."))
print("MODULES", len([n for n in sys.modules if n.startswith("repro_torch")]))
print("NEW", sorted(n for n in sys.modules
                    if n.startswith(("repro_torch.core.reuse",
                                     "repro_torch.core.policies",
                                     "repro_torch.kernels.patch_",
                                     "repro_torch.configs.",
                                     "repro_torch.models.",
                                     "repro_torch.kernels.ssd_scan.",
                                     "repro_torch.launch.",
                                     "repro_torch.diffusion.denoiser",
                                     "repro_torch.diffusion.dit",
                                     "repro_torch.configs.dit_s",
                                     "repro_torch.kernels.autotune",
                                     "repro_torch.tree",
                                     "repro_torch.optim.",
                                     "repro_torch.data.",
                                     "repro_torch.checkpoint.",
                                     "repro_torch.train.",
                                     "repro_torch.examples."))))
print("BAD", bad)
import torch.distributed as dist
print("PG", dist.is_available() and dist.is_initialized())
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["MODULES"]) > 20
    assert lines["BAD"] == "[]", lines["BAD"]
    # importing the dry-run starts no (fake) process group
    assert lines["PG"] == "False"
    new = ast.literal_eval(lines["NEW"])
    assert "repro_torch.core.reuse" in new
    for kern in ("patch_reuse", "patch_bitmap", "ssd_scan"):
        for mod in ("kernel", "ops", "ref"):
            assert f"repro_torch.kernels.{kern}.{mod}" in new
    for mod in ("configs.base", "configs.mamba2_130m", "models.layers",
                "models.ssm", "models.transformer", "models.moe",
                "configs.chatglm3_6b", "configs.hymba_1_5b",
                "configs.internvl2_26b", "configs.llama3_8b",
                "configs.llama4_scout_17b_a16e", "configs.musicgen_large",
                "configs.qwen2_moe_a2_7b", "configs.yi_34b",
                "configs.yi_9b", "launch.serve",
                "diffusion.denoiser", "diffusion.dit", "configs.dit_s",
                "core.policies", "launch.cli", "launch.scheduler",
                "launch.serve_diffusion", "launch.router", "launch.mesh",
                "models.parallel", "kernels.autotune", "tree", "optim.adamw",
                "optim.schedules", "optim.compression", "data.pipeline",
                "checkpoint.store", "launch.model_flops", "train.trainer",
                "launch.train", "launch.dryrun", "launch.flops",
                *(f"examples.{name}" for name in EXAMPLES)):
        assert f"repro_torch.{mod}" in new


@pytest.mark.parametrize("root", [
    "repro_torch.core.policies", "repro_torch.diffusion",
    "repro_torch.configs.bk_sdm", "repro_torch.kernels.dispatch",
    "repro_torch.launch.cli"])
def test_each_root_imports_first_in_a_fresh_interpreter(root):
    """No import cycle: each of these loads first, with nothing of the
    port imported before it, and loads neither JAX nor the JAX package
    (``policies`` -> ``diffusion.solvers`` runs the ``diffusion`` package
    first, whose exports load on use)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys, {root}\n"
            "from repro_torch.diffusion import DiffusionEngine\n"
            "from repro_torch.kernels.pssa_attention import "
            "pssa_attention_ref\n"
            "print(sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_repro_import_statements(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_autotune_reads_its_own_table_only():
    """The port's autotuner reads and writes its own table beside it,
    never the JAX package's (whose entries are the Pallas interpreter's),
    and the tuned dispatch path leaves no JAX module loaded."""
    from repro_torch.kernels import autotune
    table = pathlib.Path(autotune.DEFAULT_TABLE_PATH).resolve()
    assert table.parent == PORT / "kernels"
    assert table.name == "autotune_table.json"
    tree = ast.parse((PORT / "kernels" / "autotune.py").read_text())
    doc = ast.get_docstring(tree, clean=False)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value != doc:
            assert not node.value.startswith("repro."), node.value
            assert "repro/" not in node.value, node.value
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys\n"
            "from repro_torch.kernels import autotune, dispatch\n"
            "autotune.load_table()\n"
            "dispatch._blocks(dispatch.KernelPolicy.autotuned(), "
            "'self_attention', (2, 8, 4096, 40, 64), 'cuda')\n"
            "print(sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.configs.bk_sdm import SMOKE
    from repro_torch.diffusion.engine import DiffusionEngine
    from repro_torch.diffusion.pipeline import StableDiffusionPipeline
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionEngine(SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StableDiffusionPipeline(SMOKE)
    assert DiffusionEngine(SMOKE, device="cpu").device.type == "cpu"


def test_serve_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-130m", "--smoke"])


def test_train_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.launch import train
    for extra in ([], ["--sharded"], ["--sharded", "--mesh", "2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "mamba2-130m", "--smoke", "--steps", "1",
                        "--ckpt-dir", str(tmp_path), *extra])


def test_serve_diffusion_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.launch import serve_diffusion
    for argv in (["--smoke"], ["--smoke", "--continuous"],
                 ["--smoke", "--kernels", "reference"],
                 ["--smoke", "--replicas", "2"],
                 ["--smoke", "--mesh", "2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_diffusion.main(argv)


def test_router_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.launch import router
    for argv in ([], ["--check-identity"], ["--kernels", "reference"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            router._main(argv)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_twins_run_on_the_card_unless_asked_for_the_cpu(name,
                                                                tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    argv = {"generate_image": ["--smoke", "--out",
                               str(tmp_path / "image.npy")],
            "train_lm": ["--smoke", "--steps", "1",
                         "--ckpt-dir", str(tmp_path)]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert not any(tmp_path.iterdir())


def test_chip_smoke_fails_without_card_or_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"],
                           capture_output=True, text=True, timeout=300,
                           cwd=tmp_path)
    for run in (here, alone):
        assert run.returncode != 0
        assert '"ok": true' not in run.stdout


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    import repro_torch.kernels.build as build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "kernels")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()
    assert len(build.source_hash()) == 16
    assert [p.name for p in build.sources()] == [
        "bitslice_matmul.cu", "cross_attention_tips.cu",
        "patch_bitmap.cu", "patch_delta.cu", "pssa_attention.cu",
        "ssd_scan.cu"]
    assert set(build._SIGNATURES) == {
        f"launch_{p.stem}" for p in build.sources()}
