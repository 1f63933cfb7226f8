"""Reduction of a ``torch.profiler`` trace to the numbers the per-layer
readers take: device time by kernel, device busy time as the union of
the device intervals (nested or overlapping events count once), host
synchronisations, and the breakdown of device time and idle gaps.

The union of intervals is a copy of the port's ``chip_smoke``
``profile_breakdown`` arithmetic.  Host synchronisations are the runtime
calls that block the host until the device has caught up.
"""
from __future__ import annotations

import bisect
import math

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# host spans the harness records around its calls into the engine
SPAN_PREFIX = "bench."


def union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


class Reduced:
    """What the readers need of one profiled stretch of rounds."""

    def __init__(self, events, span_s: float):
        dev, cpu = [], []
        for e in events:
            tr = e.time_range
            if tr.end < tr.start:
                continue
            if not _is_device(e):
                cpu.append((tr.start, tr.end, e.name))
            elif not e.name.startswith(SPAN_PREFIX):
                # the harness's spans also appear on the device timeline,
                # as annotations over the work they launched: not work
                dev.append((tr.start, tr.end, e.name))
        self.span_s = span_s
        self.kernel_s: dict = {}
        for s, t, name in dev:
            self.kernel_s[name] = self.kernel_s.get(name, 0.0) + (t - s) / 1e6
        self.busy_s = union_us([(s, t) for s, t, _ in dev]) / 1e6
        self.syncs = sum(1 for _, _, name in cpu if name in SYNC_CALLS)
        self._dev = sorted((s, t) for s, t, _ in dev)
        self._cpu = sorted(cpu)

    def kernel_time(self, kernel: str) -> float:
        """Seconds on the device of every launch of a hand-written kernel
        (the port names its CUDA functions ``<kernel>_kernel...``)."""
        return sum(v for k, v in self.kernel_s.items()
                   if kernel + "_kernel" in k)

    def device_ops(self, top: int = 10) -> list:
        rows = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], secs] for name, secs in rows]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time grouped by what the host was in: the harness
        span around the engine call and the innermost host op."""
        gaps = []
        reach = self._dev[0][0] if self._dev else 0.0
        for s, t in self._dev:
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, t)
        spans = [c for c in self._cpu if c[2].startswith(SPAN_PREFIX)]
        ops = [c for c in self._cpu if not c[2].startswith(SPAN_PREFIX)]
        starts = [c[0] for c in ops]
        by: dict = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            span = next((name for s, t, name in spans if s <= mid <= t),
                        "router")
            inner, inner_start = None, -math.inf
            i = bisect.bisect_right(starts, mid)
            for s, t, name in reversed(ops[max(0, i - 400):i]):
                if t >= mid and s > inner_start:
                    inner, inner_start = name, s
            key = span if inner is None else f"{span}/{inner}"
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], secs] for name, secs in rows]
