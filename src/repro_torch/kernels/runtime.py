"""Shared runtime helpers for the port's op wrappers.

* **device resolution** — every entry point takes ``device=None``, which
  means the card (``"cuda"``).  A host without CUDA raises instead of
  quietly running on the CPU; callers that want the CPU (the tests) ask
  for it by name.
* **float32 precision** — set here, once, for the whole package: plain
  float32 matrix products and cuDNN convolutions on the card run in full
  float32, never TF32.  Without this cuDNN convolutions default to TF32
  and the plain route on the card stops matching the CPU.
* **launch counters** — one integer per hand-written kernel, bumped by the
  wrapper where it launches the kernel and nowhere else, so a run can show
  which kernels its main path went through.
* **CUDA-event timing** — ``cuda_ms`` times a callable on the card;
  ``min_ms`` takes the best of several rounds, the inputs rotated past the
  L2 cache (the autotuner's clock).
"""
from __future__ import annotations

import math

import torch

L2_BYTES = 50 * 2 ** 20       # the H100's L2 cache

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; a host without CUDA raises (no CPU carry-on)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the card by default, but torch finds no "
            "CUDA device on this host; pass device='cpu' to run the plain "
            "PyTorch route on the CPU")
    return dev


class LaunchCounter:
    """Launches of one hand-written kernel in this process."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def bump(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


_COUNTERS: dict = {}


def launch_counter(name: str) -> LaunchCounter:
    """The process-wide counter for kernel ``name`` (created on first use)."""
    return _COUNTERS.setdefault(name, LaunchCounter(name))


def launch_counts() -> dict:
    return {name: c.count for name, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.reset()


def cuda_ms(fn, *args, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn(*args)`` on the card, by CUDA events.

    ``warmup`` calls run first; then ``reps`` calls sit between two events
    on the current stream, and the elapsed time is divided by ``reps``.
    """
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def min_over(reps: int, sample) -> float:
    """Min of ``reps`` calls to ``sample()`` (a thunk returning a time)."""
    return min(sample() for _ in range(max(1, reps)))


def rotation(set_bytes: int, device) -> int:
    """Input sets of ``set_bytes`` each to rotate through so that together
    they cover twice the L2 cache: every call then reads its inputs from
    device memory, as the main path does.  One set off the card."""
    if torch.device(device).type != "cuda":
        return 1
    return min(512, max(2, math.ceil(2 * L2_BYTES / max(1, set_bytes))))


def min_ms(fn, sets, reps: int = 3, calls: int = 20,
           warmup: int = 3) -> float:
    """Milliseconds of ``fn(*args)`` on the card, the best of ``reps``
    rounds (``min_over``).

    In a round ``calls`` calls cycle through ``sets`` of inputs (see
    ``rotation``) between two CUDA events; a 20 ms ``torch.cuda._sleep``
    holds the stream first while the host queues every call, so a kernel
    shorter than its launch is timed back to back on the card and not at
    the host's launch rate.  A round's time is its elapsed time over
    ``calls``.
    """
    for i in range(warmup):
        fn(*sets[i % len(sets)])

    def one_round() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e-2 * 1.98e9))   # ~20 ms at the boost clock
        start.record()
        for i in range(calls):
            fn(*sets[i % len(sets)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / calls
    return min_over(reps, one_round)
