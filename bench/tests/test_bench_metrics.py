"""The arithmetic of the end-to-end readers on made-up runs."""
import math
import types

import numpy as np

import harness


def _run(**kw):
    return harness.Run(**kw)


def test_images_per_s_counts_after_the_first_completion_round():
    # completion rounds every 0.5 s with 2 images, staggered rows; the
    # window opens on the round at t = 10 and closes at 20
    completions = {r: [10.0 + 0.5 * (r - 100), 2] for r in range(100, 130)}
    completions[99] = [9.5, 2]            # before the window: not counted
    run = _run(window=(10.0, 20.0), completions=completions)
    # rounds at 10.0 ... 20.0: 21 rounds, the first one opens the window
    assert math.isclose(harness.reader("images_per_s").read(run),
                        20 * 2 / 10.0)


def test_images_per_s_uneven_rounds():
    completions = {1: [5.0, 1], 2: [6.0, 3], 3: [8.5, 1], 4: [30.0, 5]}
    run = _run(window=(5.0, 25.0), completions=completions)
    assert math.isclose(harness.reader("images_per_s").read(run),
                        4 / 3.5)


def test_images_per_s_needs_two_rounds():
    run = _run(window=(0.0, 1.0), completions={1: [0.5, 3]})
    assert harness.reader("images_per_s").read(run) is None


def _req(arrival, finished=None, admitted=None):
    return {"arrival_s": arrival, "finished_s": finished,
            "admitted_s": admitted}


def test_latency_p95_every_request_misses_count():
    done = [_req(float(i), float(i) + 1.0 + 0.01 * i) for i in range(95)]
    missing = [_req(95.0 + i) for i in range(5)]
    run = _run(window=(0.0, 100.0), requests=done + missing,
               counted=done + missing)
    got = harness.reader("latency_p95_s").read(run)
    lats = [r["finished_s"] - r["arrival_s"] for r in done]
    stop = max(r["finished_s"] for r in done)
    lats += [max(stop, 100.0) - r["arrival_s"] for r in missing]
    assert math.isclose(got, float(np.percentile(lats, 95)))


def test_latency_p95_all_drained():
    reqs = [_req(0.1 * i, 0.1 * i + 2.0) for i in range(200)]
    run = _run(window=(0.0, 20.0), requests=reqs, counted=reqs)
    assert math.isclose(harness.reader("latency_p95_s").read(run), 2.0)


def test_queue_wait_p95():
    reqs = [_req(float(i), admitted=float(i) + (0.5 if i % 10 == 0 else 0.1))
            for i in range(100)]
    run = _run(window=(0.0, 100.0), requests=reqs, counted=reqs, t0=0.0,
               rec=types.SimpleNamespace(prof_span=None))
    got = harness.reader("router.queue_wait_p95_s").read(run)
    assert math.isclose(got, float(np.percentile(
        [r["admitted_s"] - r["arrival_s"] for r in reqs], 95)))


def test_queue_wait_p95_leaves_out_the_profiled_rounds():
    reqs = [_req(float(i), admitted=float(i) + (5.0 if i >= 90 else 0.1))
            for i in range(100)]
    run = _run(window=(0.0, 100.0), requests=reqs, counted=reqs, t0=10.0,
               rec=types.SimpleNamespace(prof_span=[100.5, 105.0],
                                         prof_armed_at=100.0))
    got = harness.reader("router.queue_wait_p95_s").read(run)
    assert math.isclose(got, 0.1)


def _ev(name, start, end, device):
    return types.SimpleNamespace(
        name=name, device_type="DeviceType.CUDA" if device else "CPU",
        time_range=types.SimpleNamespace(start=start, end=end))


def test_trace_reduction():
    import trace
    events = [
        _ev("bench.slot_step", 0, 100, False),
        _ev("bench.slot_step", 0, 90, True),          # an annotation
        _ev("aten::mm", 10, 20, False),
        _ev("cudaStreamSynchronize", 85, 95, False),
        _ev("gemm_kernel", 5, 30, True),
        _ev("pssa_attention_kernel<5>", 20, 50, True),  # overlaps
        _ev("pssa_attention_kernel<8>", 60, 70, True),
        _ev("copy_kernel", 100, 104, True),
        _ev("bench.decode_slots", 110, 140, False),
        _ev("aten::conv2d", 112, 118, False),
        _ev("conv_kernel", 130, 140, True),
        _ev("add_kernel", 141, 150, True),
    ]
    r = trace.Reduced(events, span_s=150e-6)
    assert math.isclose(r.busy_s, (45 + 10 + 4 + 10 + 9) * 1e-6)
    assert math.isclose(r.kernel_time("pssa_attention"), 40e-6)
    assert r.syncs == 1
    gaps = dict(r.idle_gaps())
    assert math.isclose(gaps["bench.slot_step"], 10e-6)          # 50-60
    assert math.isclose(gaps["bench.slot_step/cudaStreamSynchronize"],
                        30e-6)                                   # 70-100
    assert math.isclose(gaps["bench.decode_slots/aten::conv2d"], 26e-6)
    assert math.isclose(gaps["router"], 1e-6)                    # 140-141
    assert [n for n, _ in r.device_ops()][0] == "pssa_attention_kernel<5>"
