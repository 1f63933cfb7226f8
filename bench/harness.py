"""One run of one cell: set-up, the measured window over the served path,
the metrics of the cell, and the comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix, metric or
kernel lives in a file found by its name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (``read(run) -> float | None``) and
``work/<kernel>.py`` (a kernel's operations and bytes).

The window drives ``ClusterRouter.stream`` over one ``DiffusionEngine``
and stops consuming it when the window closes (a bursty mix drains the
requests that arrived in it first).  The harness wraps the engine's
methods on the instance, without changing what they do: it counts slot
steps, admissions, retirements and decoded rows, keeps each step's
per-row integer counters as the step's one ``_unet_apply`` call returns
them (a window in which they do not line up one to a step is not
judged), and, under
``--trace 1``, names its spans and runs the profiler over a fixed number
of rounds that end the window.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import pathlib
import sys
import time

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the longest a mix may take to open its window, and to drain after it
RAMP_LIMIT_S = 150.0
DRAIN_LIMIT_S = 60.0
# what starting the profiler takes, which its first round pays
PROFILE_START_S = 0.5


def load_json(path):
    with open(path) as f:
        return json.load(f)


def _load_file(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    return _load_file(BENCH / "metrics" / f"{name}.py")


def work(kernel: str):
    return _load_file(BENCH / "work" / f"{kernel}.py")


def cell_of(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def load_cell(bench: dict, workload: str):
    """(cell, configuration, traffic mix) of a workload, found by name."""
    cell = cell_of(bench, workload)
    return (cell, load_json(BENCH / "configs" / f"{cell['config']}.json"),
            load_json(BENCH / "traffic" / f"{cell['traffic']}.json"))


def metrics_of(bench: dict, cell: dict, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` False) or its per-layer
    metrics (``trace`` True)."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name])
            and m["moves"] in reported]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ----------------------------------------------------------------------------
# What the harness records around the engine
# ----------------------------------------------------------------------------
class Stalled(RuntimeError):
    """The stream stepped past the harness's deadline without an event
    that ends the wait (a window that never opens, a drain that never
    ends)."""


class Recorder:
    """Instance wrappers on the engine; each calls the engine's own
    method unchanged."""

    def __init__(self, engine, torch, trace_rounds: int, trace: bool):
        self.torch = torch
        self.cuda = engine.device.type == "cuda"
        self.trace, self.trace_rounds = trace, trace_rounds
        self.calls = 0
        self.occupancy = 0
        self.rounds = []          # per slot_step: (start, end, wall, rows)
        self.stats = []           # per slot_step: the rows' counters
        self.off_steps = 0        # slot_steps not one _unet_apply call
        self.no_apply = False     # the engine has no _unet_apply
        self.admits: dict = {}    # slot_step index that follows -> count
        self.decoded: dict = {}   # slot_step index before -> rows
        self.prof = None
        self.prof_start = None    # slot_step index the profile starts at
        self.prof_span = None     # (host start, host end) of the profile
        self.prof_rounds = None   # (first, end) slot_step indices
        self.deadline = math.inf  # perf_counter time the stream must not pass
        self.prof_at = math.inf   # perf_counter time the profile may start
        self._wrap(engine)

    def _span(self, name):
        import contextlib
        if self.prof is None:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function("bench." + name)

    def _profile_edge(self) -> None:
        i = self.calls
        if (self.trace and self.prof_start is None
                and time.perf_counter() >= self.prof_at):
            self.prof_start = i
        if self.prof_start is None:
            return
        if i == self.prof_start and self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof_armed_at = time.perf_counter()
            self.prof.start()
            self.prof_span = [time.perf_counter(), None]
        elif (i == self.prof_start + self.trace_rounds
              and self.prof_span[1] is None):
            self.stop_profile()

    def stop_profile(self) -> None:
        if self.prof is not None and self.prof_span[1] is None:
            if self.cuda:
                self.torch.cuda.synchronize()
            self.prof_span[1] = time.perf_counter()
            self.prof_rounds = (self.prof_start, self.calls)
            t = time.perf_counter()
            self.prof.stop()
            self.prof_stop_s = time.perf_counter() - t
            self.prof_keep = self.prof
            self.prof = None

    def _wrap(self, eng) -> None:
        step, apply_ = eng.slot_step, getattr(eng, "_unet_apply", None)
        self.no_apply = apply_ is None
        admit, retire = eng.admit, eng.retire
        decode, finished = eng.decode_slots, eng.finished_slots

        def slot_step(state):
            if time.perf_counter() > self.deadline:
                raise Stalled("the stream ran past the harness's deadline")
            self._profile_edge()
            rows, n = self.occupancy, len(self.stats)
            with self._span("slot_step"):
                t = time.perf_counter()
                out = step(state)
                t2 = time.perf_counter()
            if len(self.stats) != n + 1:
                self.off_steps += 1
                del self.stats[n:]
                self.stats.append(None)
            self.rounds.append((t, t2, eng.last_wall_s, rows))
            self.calls += 1
            return out

        def unet_apply(*a, **kw):
            out = apply_(*a, **kw)
            self.stats.append(out[1])
            return out

        def admit_(*a, **kw):
            self.occupancy += 1
            self.admits[self.calls] = self.admits.get(self.calls, 0) + 1
            with self._span("admit"):
                return admit(*a, **kw)

        def retire_(state, slots):
            self.occupancy -= len(list(slots))
            with self._span("retire"):
                return retire(state, slots)

        def decode_(state, slots=None):
            n = state.num_slots if slots is None else len(list(slots))
            key = self.calls - 1
            self.decoded[key] = self.decoded.get(key, 0) + n
            with self._span("decode_slots"):
                return decode(state, slots)

        def finished_(state):
            with self._span("finished_slots"):
                return finished(state)

        eng.slot_step = slot_step
        if apply_ is not None:
            eng._unet_apply = unet_apply
        eng.admit, eng.retire = admit_, retire_
        eng.decode_slots, eng.finished_slots = decode_, finished_

    def misaligned(self) -> str | None:
        """Why the captured counters cannot be read step by step, or
        None."""
        if self.no_apply:
            return "the engine has no _unet_apply: no counters to compare"
        if self.off_steps:
            return (f"{self.off_steps} of {self.calls} slot steps did not "
                    f"call _unet_apply exactly once")
        return None

    def counters(self, calls) -> np.ndarray:
        """(len(calls), S, L, 3) int64: each step's (nnz, ones_xor,
        important) per row and layer, as the program returned them."""
        torch = self.torch
        mats = []
        for i in calls:
            nnz, xor, imp = self.stats[i].counter_matrices()
            mats.append(torch.stack([nnz, xor, imp], dim=-1))
        return torch.stack(mats).cpu().numpy()


# ----------------------------------------------------------------------------
# The run as the readers see it
# ----------------------------------------------------------------------------
class Run:
    """Everything a metric reader takes.  Times are seconds from the
    stream's start unless named otherwise."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def units(self) -> dict:
        import flops
        return flops.units(self.model)

    def round_work(self, i: int) -> float:
        """Dense FLOPs of router round ``i``: its step over the occupied
        rows, the decodes queued after it and the admissions before it."""
        u = self.units
        rows = self.rec.rounds[i][3]
        return (rows * u["request_step"]
                + 2 * self.rec.admits.get(i, 0) * u["prompt"]
                + self.rec.decoded.get(i, 0) * u["image"])

    def window_rounds(self) -> list:
        """slot_step indices inside the window and after the profile."""
        lo, hi = self.window
        skip = (set(range(*self.rec.prof_rounds))
                if self.rec.prof_rounds else set())
        if self.rec.prof_rounds:
            skip.add(self.rec.prof_rounds[1])     # the stop's own round
        return [i for i, r in enumerate(self.rec.rounds)
                if lo <= r[0] - self.t0 and r[1] - self.t0 <= hi
                and i not in skip]

    def kernel_roofline(self, kernel: str):
        """Share (%) of the roofline bound of a kernel's device time over
        the profiled rounds; None where it did not run."""
        if self.reduced is None or self.rec.misaligned():
            return None
        secs = self.reduced.kernel_time(kernel)
        if secs <= 0:
            return None
        import peaks
        ops, nbytes, rate = work(kernel).work(self)
        bound = max(ops / rate, nbytes / peaks.HBM_BYTES_PER_S)
        return 100.0 * bound / secs

    def profiled_counters(self) -> np.ndarray:
        return self.rec.counters(range(*self.rec.prof_rounds))


# ----------------------------------------------------------------------------
# The run
# ----------------------------------------------------------------------------
def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", model: dict | None = None,
        mix: dict | None = None, fault=None, t_process: float | None = None,
        bench: dict | None = None, ramp_limit_s: float = RAMP_LIMIT_S
        ) -> dict:
    """One run; returns the result line's object (``correct`` False with
    a ``why`` where the run could not be judged)."""
    t_process = time.time() if t_process is None else t_process
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell, file_model, file_mix = load_cell(bench, workload)
    model, mix = model or file_model, mix or file_mix
    selected = metrics_of(bench, cell, trace)

    import torch
    import program
    import traffic
    import weights as weights_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    params = weights_mod.make(model, seed, dev)
    engine, router = program.build(model, mix, params, dev)
    router.warmup()
    if trace and cuda:
        # the profiler's first start initialises its tracing on the card,
        # which takes seconds: pay it here, outside the window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            sync()
    # one router round's time at this batch (it spaces the first rows)
    probe = engine.init_slots(mix["slots"], bank=router.bank)
    round_s = math.inf
    for _ in range(2):
        probe = engine.slot_step(probe)
        round_s = min(round_s, engine.last_wall_s)
    del probe
    plan = traffic.plan(model, mix, seconds, round_s)
    inputs = [traffic.request_inputs(model, seed, i)
              for i in range(len(plan["arrivals"]))]
    bank_tiers = None if mix["tiers"] == ["config"] else list(mix["tiers"])
    reqs = program.make_requests(plan, inputs, bank_tiers, dev)
    info = [{"rid": i, "arrival_s": a, "tier": t, "slot": None,
             "admit_round": None, "admitted_s": None, "finish_round": None,
             "finished_s": None}
            for i, (a, t) in enumerate(zip(plan["arrivals"], plan["tiers"]))]
    if fault is not None:             # the tests' broken timed path
        fault(engine)
    rec = Recorder(engine, torch, model["trace_rounds"], trace)
    sync()
    if cuda:
        # what set-up left on the heap is never garbage in the window:
        # keep the collector's full passes from scanning it there
        gc.collect()
        gc.freeze()

    backlog = mix["arrivals"] == "backlog"
    window = plan["window"]
    completions: dict = {}       # finish round -> [time, images]
    first_done: set = set()
    setup_s = why = None
    gen = router.stream(reqs)
    rec.deadline = time.perf_counter() + ramp_limit_s
    try:
        for ev in gen:
            now = time.perf_counter() - router._t0
            r = info[ev["rid"]]
            if ev["event"] == "admitted":
                r.update(slot=ev["slot"], admit_round=ev["round"],
                         admitted_s=ev["t_s"])
            elif ev["event"] == "finished":
                r.update(finish_round=ev["round"], finished_s=ev["t_s"])
                comp = completions.setdefault(ev["round"], [ev["t_s"], 0])
                comp[1] += 1
                if backlog and window is None:
                    first_done.add(r["slot"])
                    if len(first_done) == mix["slots"]:
                        window = (comp[0], comp[0] + seconds)
            if window is not None and setup_s is None and now >= window[0]:
                setup_s = time.time() - t_process - (now - window[0])
                rec.deadline = router._t0 + window[1] + DRAIN_LIMIT_S
                # the profiled rounds end the window: stopping the
                # profiler takes seconds, which fall after the window
                recent = [r[0] for r in rec.rounds[-20:]]
                per_round = ((recent[-1] - recent[0]) / (len(recent) - 1)
                             if len(recent) > 1 else round_s)
                rec.prof_at = router._t0 + window[1] - (
                    model["trace_rounds"] + 2) * per_round - PROFILE_START_S
            if window is None and now > ramp_limit_s:
                break
            if (window is not None and backlog and now >= window[1]
                    and rec.prof is None):
                break
    except Stalled:
        pass
    if setup_s is None:
        why = "the window never opened: too few requests finished"
    gen.close()
    rec.stop_profile()
    sync()
    if cuda:
        gc.unfreeze()
    t0 = router._t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    forbidden = forbidden_modules()

    reduced = None
    if trace and getattr(rec, "prof_keep", None) is not None:
        import trace as trace_mod
        t = time.perf_counter()
        reduced = trace_mod.Reduced(rec.prof_keep.events(),
                                    rec.prof_span[1] - rec.prof_span[0])
        print(f"profile: {rec.prof_rounds[1] - rec.prof_rounds[0]} rounds, "
              f"start {rec.prof_span[0] - rec.prof_armed_at:.1f} s, "
              f"stop {rec.prof_stop_s:.1f} s, "
              f"read {time.perf_counter() - t:.1f} s", file=sys.stderr)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": (torch.cuda.get_device_name(dev) if cuda
                                  else dev.type),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if why:
        import check
        result["why"] = why
        result["checks"] = check.compare(model, seed, params, [], reqs,
                                         inputs, rec, dev, mix["slots"])[0]
        return result

    # what the window counts
    if backlog:
        counted = [r for r in info if r["finished_s"] is not None
                   and window[0] < completions[r["finish_round"]][0]
                   <= window[1]]
        attempted, failed = len(counted), 0
    else:
        counted = [r for r in info if window[0] <= r["arrival_s"] < window[1]]
        attempted = len(counted)
        failed = sum(r["finished_s"] is None for r in counted)
    run_view = Run(model=model, window=window, t0=t0, requests=info,
                   counted=counted, completions=completions, rec=rec,
                   reduced=reduced, setup_s=setup_s, peak_bytes=peak,
                   slots=mix["slots"])
    for m in selected:
        value = reader(m["name"]).read(run_view)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    if reduced is not None:
        result["device"].update(busy_s=reduced.busy_s,
                                window_s=reduced.span_s)
        result["breakdown"] = {"device_ops": reduced.device_ops(),
                               "idle_gaps": reduced.idle_gaps()}
    result["attempted"], result["failed"] = attempted, failed

    # free the program's serving state before the reference runs
    del gen
    if cuda:
        torch.cuda.empty_cache()
    import check
    finished = [r for r in counted if r["finished_s"] is not None]
    checks, notes, result["reference_s"] = check.compare(
        model, seed, params, finished, reqs, inputs, rec, dev, mix["slots"])
    if forbidden:
        notes.append(f"modules loaded: {', '.join(forbidden)}")
    result["correct"] = bool(finished) and not notes and all(
        c["value"] <= c["limit"] for c in checks.values())
    if notes:
        result["why"] = "; ".join(notes)
    result["checks"] = checks
    return result
