"""The five example twins (``repro_torch.examples``) on the CPU.

Each twin's ``main()`` runs in process with ``--device cpu`` at smoke
width, and its printed lines are checked.  The quickstart twin is also
held against the JAX package's ``examples/quickstart.py``: the twin's
``run`` takes the JAX example's own inputs (drawn by the JAX example's
recipe), and every line both print with a number in it must be equal (the
DBSC header names the route: Pallas there, the plain version here).  The
JAX example is imported inside a fixture (ROADMAP Queue 3 item 6).
"""
import contextlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.examples import (generate_image, quickstart, serve_lm,
                                  tips_visualization, train_lm)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-width tensors gain nothing from intra-op threads, and the
    suite's workers share the cores: one thread a worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def test_quickstart_on_the_cpu():
    res, lines = _run(quickstart.main, ["--device", "cpu"])
    assert lines[0] == "== PSSA: self-attention score compression =="
    assert "  round-trip lossless: OK" in lines
    assert ("== DBSC: bit-slice mixed-precision matmul (plain version, "
            "CPU) ==") in lines
    assert "  kernel vs oracle max diff: 0.00e+00" in lines
    assert lines[-1] == "done."
    assert torch.equal(res["acc"].to(torch.int64), res["oracle"])
    assert 0 < res["ema_reduction"] < 1
    assert 0 < res["low_precision_ratio"] < 1
    assert 0 < res["datapath_rel_err"] < 0.1


@pytest.fixture(scope="module")
def jax_quickstart():
    """The JAX example module and its inputs, by its own recipe."""
    import jax
    spec = importlib.util.spec_from_file_location(
        "jax_examples_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    key = jax.random.PRNGKey(0)

    def normal(i, shape):
        return jax.random.normal(jax.random.fold_in(key, i), shape)
    inputs = {
        "scores": jax.nn.softmax(jax.random.normal(key, (8, 256, 256))
                                 * 3.0, axis=-1),
        "q": normal(1, (1, 8, 64, 32)), "kt": normal(2, (1, 8, 16, 32)),
        "x": jax.nn.relu(normal(3, (1, 64, 32))),
        "xm": jax.nn.relu(normal(4, (64, 128))), "w": normal(5, (128, 64))}
    return mod, {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}


def test_quickstart_matches_the_jax_example(jax_quickstart):
    mod, inputs = jax_quickstart
    _, want = _run(mod.main)
    res, got = _run(quickstart.run, inputs)
    assert len(got) == len(want)
    numeric = [i for i, line in enumerate(want)
               if any(c.isdigit() for c in line) and "DBSC" not in line]
    assert len(numeric) == 6
    for i in numeric:
        assert got[i] == want[i]
    assert torch.equal(res["acc"].to(torch.int64), res["oracle"])


def test_tips_visualization_on_the_cpu():
    res, lines = _run(tips_visualization.main, ["--device", "cpu"])
    assert lines[0].startswith("important-pixel ratio: ")
    assert lines[1].startswith("spatial coherence: horizontal ")
    assert lines[3] == ("TIPS importance map (64x64, # = important = "
                        "INT12):")
    rows = lines[4:]
    assert len(rows) == 32 and all(len(r) == 64 for r in rows)
    assert set("".join(rows)) == {"#", "."}
    assert abs(res["important_ratio"] + res["low_precision_ratio"] - 1) < 1e-6
    assert 0.3 < res["low_precision_ratio"] < 0.8
    assert min(res["agree_h"], res["agree_v"]) > 0.85


def test_generate_image_engine_and_python_loop_agree(tmp_path):
    """Smoke geometry, two steps: the engine and the per-step pipeline print
    the same ledger (the stats-parity contract), and the image is saved."""
    outs = {}
    for mode in ([], ["--python-loop"]):
        out = tmp_path / f"image{len(mode)}.npy"
        res, lines = _run(generate_image.main, [
            "--device", "cpu", "--smoke", "--steps", "2", "--out",
            str(out), *mode])
        assert lines[0].startswith("pipeline: model unet, latent 16^2, "
                                   "sampler ddim x2, guidance 1.0, ")
        assert lines[2] == f"saved {out}"
        assert lines[4] == ("full-geometry (BK-SDM-Tiny, family=unet) "
                            "energy ledger:")
        assert lines[5].split() == ["ema_gb_per_iter_baseline",
                                    f"{res['summary']['ema_gb_per_iter_baseline']:.4f}"]
        img = np.load(out)
        assert img.dtype == np.uint8 and img.shape == (128, 128, 3)
        assert res["finite"]
        outs[bool(mode)] = (res["summary"], lines[5:])
    assert outs[False] == outs[True]


def test_serve_lm_on_the_cpu():
    res, lines = _run(serve_lm.main, ["--device", "cpu", "--new-tokens",
                                      "4", "--prompt-len", "8"])
    assert lines[0] == ("serving llama3-8b-smoke (smoke geometry), batch=4, "
                        "prompt=8, decode=4")
    assert lines[1].startswith("prefill: ")
    assert lines[2].startswith("decoded 4 tokens x 4 seqs in ")
    assert lines[3] == f"sample token ids: {res['tokens'][0].tolist()}"
    assert lines[4] == "DBSC bit-slice FFN tile: (4, 128), finite=True"
    assert res["tokens"].shape == (4, 4)


def test_train_lm_on_the_cpu_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path)]
    res, lines = _run(train_lm.main, argv)
    assert lines[0] == "arch llama3-100m-smoke: 0.1 M params"
    first = res["history"][0][1]
    assert np.isfinite(first)
    assert lines[-1] == (f"loss {first:.3f} -> {res['history'][-1][1]:.3f} "
                         f"(NOT improved)")
    assert (tmp_path / "step_00000002").is_dir()
    res, lines = _run(train_lm.main, argv)
    assert res["history"] == []
    assert lines[-1].startswith("nothing to train: ")


def test_train_lm_config_is_the_jax_examples():
    cfg = train_lm.make_100m_config()
    assert (cfg.name, cfg.num_layers, cfg.d_model, cfg.vocab_size,
            cfg.tips, cfg.pssa) == ("llama3-100m", 12, 512, 50304, False,
                                    False)
    from repro_torch.launch.model_flops import param_count
    assert 95e6 < param_count(cfg) < 105e6
