"""The port's fault-tolerant ``Trainer`` and ``launch/train.py`` on the CPU,
at smoke widths (mirroring ``tests/test_train_infra.py``'s trainer tests):
a run killed mid-way and resumed by a fresh ``Trainer`` ends bit for bit
where an uninterrupted run ends, the loss falls, and the CLI trains every
family in process."""
import shutil

import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint import latest_step, load_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW
from repro_torch.train import TrainConfig, Trainer


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-width tensors gain nothing from intra-op threads, and the
    suite's workers share the cores: one thread a worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def smoke_cfg():
    return get_arch("llama3-8b").smoke().scaled(vocab_size=128)


def _dataset(cfg, **kw):
    return SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                              global_batch=4, seed=7, **kw)


@pytest.mark.parametrize("compression", [False, True])
def test_trainer_resume_bit_exact(tmp_path, smoke_cfg, compression):
    """Kill at step 7, resume from the step-6 checkpoint in a fresh
    Trainer: the final state (params, moments, step, residual) equals an
    uninterrupted run's bit for bit."""
    def tc():
        return TrainConfig(steps=10, checkpoint_every=3, log_every=100,
                           checkpoint_dir=str(tmp_path / "ckpt"),
                           grad_compression=compression)
    ds = _dataset(smoke_cfg)
    opt = AdamW(lr=1e-3)

    class Boom(RuntimeError):
        pass

    def killer(step):
        if step == 7:
            raise Boom()

    t1 = Trainer(smoke_cfg, ds, opt, tc(), failure_hook=killer, device="cpu")
    with pytest.raises(Boom):
        t1.run()
    assert latest_step(str(tmp_path / "ckpt")) == 6
    _, meta = load_checkpoint(str(tmp_path / "ckpt"), 6,
                              t1._fresh_state(torch.Generator()))
    assert meta == {"data_seed": 7, "data_step": 6, "arch": smoke_cfg.name}
    state_resumed, hist = Trainer(smoke_cfg, ds, opt, tc(),
                                  device="cpu").run()
    assert hist[0][0] == 7                     # resumed at step 7

    shutil.rmtree(tmp_path / "ckpt")
    state_clean, _ = Trainer(smoke_cfg, ds, opt, tc(), device="cpu").run()
    assert int(state_clean[1].step) == 10
    for a, b in zip(tree_util.leaves(state_resumed),
                    tree_util.leaves(state_clean)):
        assert torch.equal(a, b)


def test_trainer_loss_decreases(smoke_cfg, tmp_path):
    ds = _dataset(smoke_cfg)
    tc = TrainConfig(steps=30, checkpoint_every=1000, log_every=5,
                     checkpoint_dir=str(tmp_path / "c2"))
    _, history = Trainer(smoke_cfg, ds, AdamW(lr=3e-3), tc,
                         device="cpu").run(resume=False)
    assert [s for s, _ in history] == [1, 5, 10, 15, 20, 25, 30]
    assert history[-1][1] < history[0][1]


def test_trainer_aux_coef_weights_the_moe_aux_loss(tmp_path):
    """``TrainConfig.aux_coef`` reaches ``loss_fn``: the first step's loss
    is nll + aux_coef * aux of the initial parameters."""
    cfg = get_arch("qwen2-moe-a2.7b").smoke().scaled(vocab_size=128)
    ds = _dataset(cfg)
    losses = {}
    for coef in (0.0, 1.0):
        tc = TrainConfig(steps=1, checkpoint_every=1000, log_every=1,
                         checkpoint_dir=str(tmp_path / f"c{coef}"),
                         aux_coef=coef)
        t = Trainer(cfg, ds, AdamW(lr=1e-3), tc, device="cpu")
        losses[coef] = t.run(resume=False)[1][0][1]
    params = t._fresh_state(torch.Generator(device="cpu").manual_seed(0))[0]
    with torch.no_grad():
        _, m = T.loss_fn(params, ds.batch_at(0, device="cpu"), cfg)
    assert float(m["aux"]) > 0.1
    assert losses[0.0] == pytest.approx(float(m["nll"]), rel=1e-6)
    assert losses[1.0] == pytest.approx(float(m["nll"] + m["aux"]),
                                        rel=1e-6)


def test_trainer_trains_an_embedding_input_model(tmp_path):
    """musicgen (embeddings in, bf16 batches): the embedding table gets a
    zero gradient, as under ``jax.grad``, and the rest trains."""
    cfg = get_arch("musicgen-large").smoke()
    ds = _dataset(cfg, embedding_input=True, d_model=cfg.d_model)
    tc = TrainConfig(steps=2, checkpoint_every=1000, log_every=1,
                     checkpoint_dir=str(tmp_path / "c3"))
    t = Trainer(cfg, ds, AdamW(lr=1e-3, weight_decay=0.0), tc, device="cpu")
    start = t._fresh_state(torch.Generator(device="cpu").manual_seed(0))
    (params, opt_state, _), history = t.run(resume=False)
    assert len(history) == 2
    assert not opt_state.m["embed"].any()
    assert torch.equal(params["embed"], start[0]["embed"])
    assert not torch.equal(params["unembed"], start[0]["unembed"])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b"])
def test_train_cli_smoke_on_the_cpu(arch, tmp_path, capsys):
    history = train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--steps", "2", "--batch", "2", "--seq", "16",
                              "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(history) == 2
    assert "device cpu" in out and "M params" in out
    assert f"loss {history[0][1]:.4f} -> {history[1][1]:.4f}" in out
    assert latest_step(str(tmp_path)) == 2


def test_train_cli_grad_compression_resumes(tmp_path, capsys):
    argv = ["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--grad-compression",
            "--ckpt-dir", str(tmp_path)]
    train_cli.main(argv + ["--steps", "2"])
    history = train_cli.main(argv + ["--steps", "3"])
    assert [s for s, _ in history] == [3]
    assert latest_step(str(tmp_path)) == 3


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu():
    """(The CLI's default: ``tests/test_torch_isolation.py``.)"""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = get_arch("llama3-8b").smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, _dataset(cfg), AdamW(), TrainConfig())
