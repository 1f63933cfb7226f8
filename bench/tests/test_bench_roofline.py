"""A kernel's roofline bound is one no implementation can beat: at the
main path's shapes its time is at most the time of the same work at any
dtype the op could run in, at that dtype's peak rate and element size."""
import numpy as np
import pytest

import harness
import peaks

BW = peaks.HBM_BYTES_PER_S
# (peak FLOP/s, bytes an element) of each type a float attention could use
FLOAT_TYPES = {"float32": (67e12, 4), "tf32": (495e12, 4),
               "bfloat16": (989e12, 2), "float16": (989e12, 2)}


class _Rec:
    def __init__(self, counters):
        self.prof_rounds = (0, counters.shape[0])
        self._c = counters

    def misaligned(self):
        return None


def _run(config, slots, keep=0.6, important=0.95):
    model = harness.load_json(harness.BENCH / "configs" / f"{config}.json")
    from reference import sampling
    layers = sampling.family(model["family"]).attention_layers(model["unet"])
    heads = model["unet"]["num_heads"]
    c = np.zeros((2, slots, len(layers), 3), np.int64)
    for i, (res, _) in enumerate(layers):
        t = res * res
        c[:, :, i, 0] = int(keep * heads * t * t)
        c[:, :, i, 2] = int(important * t)
    run = harness.Run(model=model, slots=slots, rec=_Rec(c))
    run.profiled_counters = lambda: c
    return run, layers, heads


def _bound(ops, nbytes, rate):
    return max(ops / rate, nbytes / BW)


@pytest.mark.parametrize("config,slots", [("bksdm-small", 8), ("dit-s2", 32)])
def test_pssa_bound_below_every_float_type(config, slots):
    run, layers, heads = _run(config, slots)
    ops, nbytes, rate = harness.work("pssa_attention").work(run)
    ours = _bound(ops, nbytes, rate)
    steps = 2
    for name, (peak, size) in FLOAT_TYPES.items():
        # the least any kernel in this type needs: the same products, each
        # operand and output moved once at this element size
        o = b = 0.0
        for i, (res, ch) in enumerate(layers):
            t, d = res * res, ch // heads
            rows = slots if i == 0 else 2 * slots
            o += 2.0 * steps * rows * heads * t * t * d * 1.6
            # q, k, v and the output at this size, and the two per-query
            # counters (at most 4096: 2 bytes)
            b += steps * rows * heads * t * (4 * d * size + 4)
        assert ours <= _bound(o, b, peak) * (1 + 1e-9), name


@pytest.mark.parametrize("config,slots", [("bksdm-small", 8), ("dit-s2", 32)])
def test_bitslice_bound_below_int8(config, slots):
    run, layers, _ = _run(config, slots)
    ops, nbytes, rate = harness.work("bitslice_matmul").work(run)
    ours = _bound(ops, nbytes, rate)
    mult = run.model["unet"]["ffn_mult"]
    counters = run.profiled_counters()
    o = b = 0.0
    for i, (res, c) in enumerate(layers):
        m = 2 * 2 * slots * res * res
        imp = 2.0 * counters[:, :, i, 2].sum()
        for k, n, lo in ((c, 2 * mult * c, imp), (mult * c, c, m)):
            # int8 products: the high plane of every row, the low plane of
            # the INT12 rows; two int8 planes read (2 bytes), weights 1,
            # int32 results 4, the precision flags a bit
            o += 2.0 * k * n * (m + lo)
            b += m * k * 2 + k * n + 4 * m * n + m / 8
    assert ours <= _bound(o, b, peaks.INT8_OPS) * (1 + 1e-9)
    assert rate == peaks.INT8_OPS


def test_roofline_share_is_the_bound_over_the_time():
    class _Red:
        def kernel_time(self, kernel):
            return 2e-3 if kernel == "pssa_attention" else 0.0
    run, _, _ = _run("bksdm-small", 8)
    run.reduced = _Red()
    ops, nbytes, rate = harness.work("pssa_attention").work(run)
    share = run.kernel_roofline("pssa_attention")
    assert share == pytest.approx(100 * _bound(ops, nbytes, rate) / 2e-3)
    assert run.kernel_roofline("bitslice_matmul") is None
