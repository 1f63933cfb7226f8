"""The plain reference agrees with ``repro_torch`` at the SMOKE
geometries on the CPU, through a whole run of each cell's path: one slot
(so the DBSC scale covers the same rows as the reference's request
alone), the served images within a few float32 rounding steps of the
reference's and the ledger counters equal."""
import pytest
import torch

import harness
import smoke

CELLS = [("bksdm-small.backlog8", "bksdm-small", "backlog8"),
         ("dit-s2.backlog32", "dit-s2", "backlog32"),
         ("bksdm-small.tiers8", "bksdm-small", "tiers8")]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload,config,traffic", CELLS)
def test_reference_agrees_at_smoke_size(workload, config, traffic):
    model = smoke.model(config)
    model["check"]["requests"] = 3
    # oneDNN convolves a batch of one on another path than the
    # reference's batch of two: a few float32 ulps, grown by the steps
    model["check"]["limits"] = {"image_rel_rms": 2e-3,
                                "counter_rel_gap": 0.0}
    out = harness.run(workload, 20261018, 1.5, False, device="cpu",
                      model=model, mix=smoke.mix(traffic, 1))
    assert out["correct"], out


def test_dbsc_matches_the_port_integer_path():
    from reference.layers import dbsc_matmul
    from repro_torch.kernels.bitslice_matmul.ops import bitslice_matmul
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 96, generator=g)
    w = torch.randn(96, 40, generator=g) / 10
    imp = torch.rand(64, generator=g) < 0.5
    assert torch.equal(dbsc_matmul(x, w, imp), bitslice_matmul(x, w, imp))
    assert torch.equal(dbsc_matmul(x, w), bitslice_matmul(x, w))
