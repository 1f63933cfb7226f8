"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake ranks
(port of ``repro.launch.dryrun``).

The JAX package lowers and compiles each cell's step for 256 or 512 fake
host devices and reads XLA's analyses.  A torch rank runs its own program,
so here the default process group is torch's fake backend
(``launch.mesh.fake_process_group``: this process is rank 0 of 256 or 512,
every collective returns at once), the mesh is ``make_production_mesh``,
and rank 0's real step (``make_train_step(ctx=, zero1=True)``, or
``zero3=True`` under ``--fsdp``; ``prefill``
or ``decode_step`` under a ``ShardCtx``) runs once under ``FakeTensorMode``
on this rank's shard shapes: nothing is computed and no device memory is
taken, at full published width.  Each cell records:

* ``flops``: this rank's matmul / conv FLOPs (``launch.flops``), and
  ``flops_global`` from the unsharded step at the global batch
  (``flops_cell``; a rank's count times the world size would overcount
  wherever a block runs replicated, as llama3-8b's 8 KV heads do at tp 16);
* ``bytes_accessed``: the summed input and output bytes of the dispatched
  ops.  The step runs eagerly, op by op, so this is an unfused count, not
  XLA's post-fusion figure;
* ``collective_bytes``: what the rank's program issued, by the JAX
  package's kinds (``models.parallel.collective_bytes``; the port has no
  HLO to parse), and ``collective_axes``, the same calls counted by mesh
  axis (``collective_counts``);
* ``memory_analysis``: argument, output and alias bytes (the donated train
  state or decode cache) and ``temp_size_in_bytes``, the peak of the live
  storage bytes over the call less the arguments (``_Meter``).  Eager
  torch allocates the outputs while the arguments live, so the temp
  includes them; argument + temp is the predicted peak of the step.

The train cell always shards AdamW's moments over the data axes (ZeRO-1,
the JAX cell's ``zero_spec``); ``--fsdp`` (ZeRO-3, the fit-memory variant)
shards the parameters the same way, each layer gathered where it is used
and its gradient reduce-scattered (``parallel.gather_over_dp``).  Prefill
and decode cells ignore it, as the JAX package's do.  A config with
``use_ssd_kernel=True`` is refused: a ctypes kernel cannot run on fake
tensors.

Usage (the card by default; ``--device cpu`` makes CPU fakes):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --device cpu --out /tmp/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --fsdp --variant fsdp
Records are written under ``--out`` only (``dryrun_torch_results/`` at the
repository root by default), never under ``benchmarks/``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as tree_util
from repro_torch.configs import (ARCH_NAMES, SHAPES, get_arch,
                                 shape_applicable)
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data import make_batch_specs
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.flops import FlopCounter
from repro_torch.models import transformer as T
from repro_torch.models.layers import ShardCtx
from repro_torch.models.parallel import (COLLECTIVES, P, collective_bytes,
                                         collective_counts, mesh_shape,
                                         reset_collective_counts)
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import AdamWState, zero_slice
from repro_torch.train.trainer import make_train_step, zero3_plan, zero_plan

RESULTS_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "dryrun_torch_results"))


def choose_tp_fold(cfg: ArchConfig, shape: ShapeConfig,
                   devices: int = 256) -> bool:
    """TP-fold policy: fold the model axis into data parallelism for a
    small non-MoE model in training (its per-layer TP collectives buy
    nothing), when the global batch still divides the device count."""
    if shape.kind != "train" or cfg.family == "moe":
        return False
    if shape.global_batch % devices:
        return False
    from repro_torch.launch.model_flops import param_count
    return param_count(cfg) * 2 < 1e9        # < 1 GB of bf16 params


def _strip_model(tree):
    """The "model" axis replaced with None in every spec of ``tree``."""
    if isinstance(tree, dict):
        return {k: _strip_model(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_strip_model(v) for v in tree]
    return P(*(None if a == "model" else a for a in tree))


def _zip_specs(fn, specs, leaves_like):
    """``fn(spec, tensor)`` over a spec tree and a tensor tree of its
    structure."""
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, specs[k], leaves_like[k]) for k in specs}
    if isinstance(specs, list):
        return [_zip_specs(fn, s, t) for s, t in zip(specs, leaves_like)]
    return fn(specs, leaves_like)


def zero_spec(spec: P, shape: tuple, dp_total: int, dps) -> P:
    """ZeRO-1 on a parameter's spec: the data axes ``dps`` on its first
    dimension that the spec leaves whole and ``dp_total`` divides."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p_, dim) in enumerate(zip(parts, shape)):
        if p_ is None and dim % dp_total == 0 and dim >= dp_total:
            parts[i] = dps
            break
    return P(*parts)


def _ctx(mesh, tp_fold: bool) -> ShardCtx:
    """The cell's ``ShardCtx``, built on the mesh's real rank tensor (out
    of any fake mode)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    dp = mesh_mod.dp_axes_of(mesh) + (("model",) if tp_fold else ())
    with unset_fake_temporarily():
        return ShardCtx(mesh=mesh, dp_axes=dp,
                        tp_axis=None if tp_fold else "model")


def _mesh_size(mesh) -> int:
    return int(mesh.size())


def _empty(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _like(tree, device):
    """Uninitialised tensors of ``tree``'s shapes and dtypes (meta
    leaves) on ``device``: fakes under ``FakeTensorMode``."""
    return tree_util.tree_map(lambda a: _empty(a.shape, a.dtype, device),
                              tree)


def _fake_mode_active() -> bool:
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                tp_fold: bool | None = None, device="cpu",
                fsdp: bool = False):
    """-> (args, specs) for the cell's step on this rank: ``args`` are
    fakes of this rank's shard shapes (the parameters by the executed
    layout, ZeRO-1 moments, its batch rows or its cache), ``specs`` the
    JAX package's PartitionSpec trees for the same arguments (the global
    layout, which the port's executed layout follows where a block splits;
    ``models/ssm.py`` says where it does not).  Call it under
    ``FakeTensorMode``: it allocates.

    The train state's layout between steps: ZeRO-1 by default, the
    parameters whole on each data rank (their model shard) and the
    moments sliced over the data axes; ``fsdp`` (ZeRO-3), the parameters
    sliced as the moments are (``zero3_plan``), their specs the moments'
    (JAX: ``psh = mv_sh``).  Prefill and decode ignore ``fsdp``."""
    if not _fake_mode_active():
        raise RuntimeError("input_specs allocates full-size arguments: "
                           "call it under FakeTensorMode")
    if tp_fold is None:
        tp_fold = choose_tp_fold(cfg, shape, _mesh_size(mesh))
    ctx = _ctx(mesh, tp_fold)
    dp = ctx.dp_axes
    dps = ctx.dp
    tp = 1 if tp_fold else mesh_shape(mesh)["model"]
    pspecs = T.param_specs(cfg, tp)
    if tp_fold:
        pspecs = _strip_model(pspecs)
    full = T.abstract_params(cfg)
    params = _like(T.shard_params(full, cfg, ctx), device)

    if shape.kind == "train":
        bspecs = make_batch_specs(cfg, shape, dp)
        batch = {k: _empty((v[0].shape[0] // ctx.dp_size,) + v[0].shape[1:],
                           v[0].dtype, device) for k, v in bspecs.items()}
        dp_total = _mesh_size(mesh) // tp
        mv = _zip_specs(lambda s, a: zero_spec(s, a.shape, dp_total, dps),
                        pspecs, full)
        if fsdp:
            plan = zero3_plan(cfg, ctx)
            params = tree_util.unflatten(params, (
                _empty(zero_slice(a, d, plan).shape, a.dtype, device)
                for a, d in zip(tree_util.leaves(params), plan.dims)))
            pspecs = mv
        else:
            plan = zero_plan(params, cfg, ctx)
        state = (params, AdamW().init(params, plan),
                 _empty((), torch.float32, device))
        return ((state, batch),
                ((pspecs, AdamWState(step=P(), m=mv, v=mv), P()),
                 {k: v[1] for k, v in bspecs.items()}))

    if shape.kind == "prefill":
        bspecs = make_batch_specs(cfg, shape, dp)
        spec, pspec = bspecs["embeds" if cfg.embedding_input else "tokens"]
        x = _empty((spec.shape[0] // ctx.dp_size,) + spec.shape[1:],
                   spec.dtype, device)
        return (params, x), (pspecs, pspec)

    b = shape.global_batch
    split = b >= _mesh_size(mesh) // tp
    rows = b // ctx.dp_size if split else b
    cache = T.init_cache(cfg, rows, shape.seq_len, device, ctx)
    tok = _empty((rows, 1), torch.int32, device)
    return ((params, cache, tok, shape.seq_len - 1),
            (pspecs, T.cache_specs(cfg, b, dp, tp),
             P(dps, None) if split else P(None, None), P()))


def pick_microbatches(global_batch: int, dp_size: int, seq: int,
                      target_tokens: int = 8192) -> int:
    """Gradient-accumulation factor: bound live activations to ~target
    tokens per device per microbatch (must divide the global batch)."""
    b_local = max(1, global_batch // dp_size)
    want = max(1, (b_local * seq) // target_tokens)
    m = min(want, b_local)
    while global_batch % m or (global_batch // m) % dp_size:
        m -= 1
    return max(m, 1)


def _refuse_kernel(cfg: ArchConfig) -> None:
    if cfg.use_ssd_kernel:
        raise ValueError(f"{cfg.name}: use_ssd_kernel=True routes the SSD "
                         "scan to a ctypes CUDA kernel, which cannot run on "
                         "fake tensors; dry-run the plain scan "
                         "(use_ssd_kernel=False)")


def step_callable(cfg: ArchConfig, shape: ShapeConfig, mesh,
                  force_m1: bool = False, tp_fold: bool | None = None,
                  force_m: int | None = None, fsdp: bool = False):
    """The cell's step on this rank: the ZeRO-1 train step (ZeRO-3 with
    ``fsdp``), prefill or decode_step under the cell's ``ShardCtx``."""
    _refuse_kernel(cfg)
    if tp_fold is None:
        tp_fold = choose_tp_fold(cfg, shape, _mesh_size(mesh))
    ctx = _ctx(mesh, tp_fold)
    if shape.kind == "train":
        if force_m1:
            m = 1
        elif force_m:
            m = force_m
        else:
            m = pick_microbatches(shape.global_batch, ctx.dp_size,
                                  shape.seq_len)
        return make_train_step(cfg, AdamW(), num_microbatches=m, ctx=ctx,
                               zero1=not fsdp, zero3=fsdp)
    if shape.kind == "prefill":
        def prefill_fn(params, x):
            with torch.no_grad():
                if cfg.embedding_input:
                    return T.prefill(params, cfg, embeds=x, ctx=ctx)
                return T.prefill(params, cfg, tokens=x, ctx=ctx)
        return prefill_fn

    def decode_fn(params, cache, tok, pos):
        with torch.no_grad():
            return T.decode_step(params, cache, tok, pos, cfg, ctx=ctx)
    return decode_fn


# ---------------------------------------------------------------------------
# Tracing a cell
# ---------------------------------------------------------------------------
_EMPTY = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}


def _tensors(tree) -> list:
    return [t for t in tree_util.leaves(tree) if isinstance(t, torch.Tensor)]


def _flat_tensors(xs, out: list) -> list:
    """The tensors among ``xs`` and the lists and tuples in it (an op's
    arguments or outputs)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _flat_tensors(x, out)
    return out


def _tree_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class _Meter(FlopCounter):
    """A ``FlopCounter`` that also keeps the live storage bytes while it
    is active, with their peak, and the bytes each dispatched op reads and
    writes (views and allocations move nothing).  A storage is counted
    from the op that first returns it until it is freed
    (``weakref.finalize``)."""

    def __init__(self):
        super().__init__()
        self.live: dict = {}
        self.now = self.peak = self.accessed = 0
        self._moves: dict = {}

    def hold(self, tree) -> None:
        """Count the storages of ``tree`` (already live) from now on."""
        for t in _tensors(tree):
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = self.live[key] = st.nbytes()
        self.now += n
        if self.now > self.peak:
            self.peak = self.now
        weakref.finalize(st, self._drop, key)

    def _drop(self, key) -> None:
        self.now -= self.live.pop(key, 0)

    def _moves_bytes(self, func) -> bool:
        moves = self._moves.get(func)
        if moves is None:
            moves = self._moves[func] = func not in _EMPTY and not any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in func._schema.returns)
        return moves

    def seen(self, func, args, kwargs, out) -> None:
        outs = _flat_tensors(out if isinstance(out, (list, tuple))
                             else (out,), [])
        for t in outs:
            self._add(t)
        if self._moves_bytes(func):
            ins = _flat_tensors(kwargs.values(), _flat_tensors(args, []))
            self.accessed += sum(t.numel() * t.element_size()
                                 for t in ins + outs)


def _trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
                force_m1: bool = False, force_m: int | None = None,
                device="cpu", tp_fold: bool | None = None,
                fsdp: bool = False) -> dict:
    """Run this rank's step once on fakes; return its numbers (the JAX
    package's ``_compile_cell``).  ``tp_fold``: ``choose_tp_fold``'s
    policy when None; ``fsdp``: the ZeRO-3 train step."""
    t0 = time.perf_counter()
    step = step_callable(cfg, shape, mesh, force_m1=force_m1,
                         force_m=force_m, tp_fold=tp_fold, fsdp=fsdp)
    with FakeTensorMode():
        args, _ = input_specs(cfg, shape, mesh, tp_fold, device=device,
                              fsdp=fsdp)
        meter = _Meter()
        meter.hold(args)
        arg_bytes = meter.now
        reset_collective_counts()
        with meter:
            out = step(*args)
        coll = collective_bytes()
        axes = {k: v for k, v in collective_counts().items()
                if k != "host_s"}
        donated = {"train": 0, "decode": 1}.get(shape.kind)
        mem = {"argument_size_in_bytes": arg_bytes,
               "output_size_in_bytes": _tree_bytes(out),
               "alias_size_in_bytes": (0 if donated is None
                                       else _tree_bytes(args[donated])),
               "temp_size_in_bytes": meter.peak - arg_bytes}
        del out, args
    return {"trace_s": round(time.perf_counter() - t0, 2),
            "flops": float(meter.total),
            "bytes_accessed": float(meter.accessed),
            "collective_bytes": coll, "collective_axes": axes,
            "memory_analysis": _mem_dict(mem)}


def flops_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, device="cpu",
               force_m: int | None = None) -> float:
    """Global FLOPs of the cell's step: the unsharded step (``ctx=None``)
    at the global batch, on fakes, with the sharded step's microbatches
    (``force_m`` if given; the count does not depend on them).  The JAX
    package's ``jaxpr_flops_cell``."""
    _refuse_kernel(cfg)
    b, t = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        params = _like(T.abstract_params(cfg), device)
        if shape.kind == "train":
            dp_size = _ctx(mesh, choose_tp_fold(
                cfg, shape, _mesh_size(mesh))).dp_size
            opt = AdamW()
            fn = make_train_step(cfg, opt, num_microbatches=force_m or
                                 pick_microbatches(b, dp_size, t))
            batch = {k: _empty(v[0].shape, v[0].dtype, device)
                     for k, v in make_batch_specs(cfg, shape,
                                                  ("data",)).items()}
            args = ((params, opt.init(params),
                     _empty((), torch.float32, device)), batch)
        elif shape.kind == "prefill":
            key = "embeds" if cfg.embedding_input else "tokens"
            spec = make_batch_specs(cfg, shape, ("data",))[key][0]

            def fn(p, x):
                with torch.no_grad():
                    return T.prefill(p, cfg, **{key: x})
            args = (params, _empty(spec.shape, spec.dtype, device))
        else:
            def fn(p, c, tok):
                with torch.no_grad():
                    return T.decode_step(p, c, tok, t - 1, cfg)
            args = (params, T.init_cache(cfg, b, t, device),
                    _empty((b, 1), torch.int32, device))
        with FlopCounter() as fc:
            fn(*args)
        del args
    return float(fc.total)


def _extrapolate(r1: dict, r2: dict, L: int) -> dict:
    """T(L) = T(1) + (L-1) * (T(2) - T(1)) for flops, bytes and collective
    bytes, clamped to the larger single trace where the slope is negative
    (the JAX package's rule for its loop-body counts).  The port's eager
    trace counts every layer, so for a layer-uniform stack this equals the
    full-depth trace."""
    def lin(a, b):
        v = a + (L - 1) * (b - a)
        return v if v >= max(a, b) else max(a, b)

    out = {}
    for k in ("flops", "bytes_accessed"):
        out[k] = lin(r1[k], r2[k])
    c1, c2 = r1["collective_bytes"], r2["collective_bytes"]
    out["collective_bytes"] = {k: lin(c1[k], c2[k]) for k in
                               list(COLLECTIVES) + ["total", "weighted"]}
    return out


def _mesh_tag(multi_pod: bool, tp_size: int) -> str:
    dp = 256 // tp_size
    return f"2x{dp}x{tp_size}" if multi_pod else f"{dp}x{tp_size}"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, tp_size: int = 16,
             save_coll: bool = False, force_m: int | None = None,
             variant: str = "", kv_int8: bool = False,
             cfg: ArchConfig | None = None, device="cuda",
             fsdp: bool = False) -> dict:
    """One cell's record, traced on a fake group of 256 (512 with
    ``multi_pod``) ranks that this call starts and ends (no other group
    may be active).  ``cfg`` replaces ``get_arch(arch)`` (a smoke config,
    say); ``device`` is where the fakes claim to live (the card by
    default); ``fsdp``: ZeRO-3 (train cells; the record's name follows
    ``variant`` alone, as the JAX package's does).  ``flops_global`` is
    the unsharded count either way."""
    resolve_device(device)
    cfg = get_arch(arch) if cfg is None else cfg
    if save_coll:
        cfg = cfg.scaled(remat_save_collectives=True)
    if kv_int8:
        cfg = cfg.scaled(kv_cache_dtype="int8")
    _refuse_kernel(cfg)
    shape = SHAPES[shape_name]
    devices = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape_name,
           "mesh": _mesh_tag(multi_pod, tp_size), "variant": variant,
           "devices": devices}
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = ("full-attention arch at 524k decode "
                         "(needs sub-quadratic attention; DESIGN.md §6)")
        return rec

    with mesh_mod.fake_process_group(devices):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             tp_size=tp_size)
        try:
            full = _trace_cell(cfg, shape, mesh, force_m=force_m,
                               device=device, fsdp=fsdp)
            rec.update(full)
            rec["status"] = "ok"
            rec["flops_global"] = flops_cell(cfg, shape, mesh, device,
                                             force_m)
            if not (cfg.family == "hybrid" and shape.kind == "decode"):
                r1, r2 = (_trace_cell(cfg.scaled(num_layers=n), shape, mesh,
                                      force_m1=True, device=device,
                                      fsdp=fsdp)
                          for n in (1, 2))
                rec["extrapolated"] = _extrapolate(r1, r2, cfg.num_layers)
            else:
                rec["extrapolated"] = {k: full[k] for k in (
                    "flops", "bytes_accessed", "collective_bytes")}
            if verbose:
                e = rec["extrapolated"]
                print(f"[ok] {arch} x {shape_name} x {rec['mesh']}  "
                      f"flops={e['flops']:.3e} "
                      f"bytes={e['bytes_accessed']:.3e} "
                      f"coll={e['collective_bytes']['weighted']:.3e}  "
                      f"(trace {full['trace_s']:.1f}s)")
                print("   memory:", rec["memory_analysis"])
        except Exception as e:          # a failing cell is a bug; record it
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
            if verbose:
                print(f"[ERROR] {arch} x {shape_name} x {rec['mesh']}: "
                      f"{rec['error']}")
    return rec


def _mem_dict(mem):
    """The record's ``memory_analysis``: integer bytes by field."""
    if mem is None:
        return None
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes")
    if isinstance(mem, dict):
        return {k: int(mem[k]) for k in fields if k in mem}
    return {k: int(getattr(mem, k)) for k in fields if hasattr(mem, k)}


def _record_name(rec: dict) -> str:
    suffix = f"__{rec['variant']}" if rec.get("variant") else ""
    return (f"dryrun_{rec['mesh'].replace('x', '_')}_{rec['arch']}_"
            f"{rec['shape']}{suffix}.json")


def save_record(rec: dict, out_dir: str = RESULTS_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _record_name(rec))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main(argv=None) -> list:
    """The CLI; returns the records it wrote."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tp", type=int, default=16,
                    help="TP degree (256/tp becomes DP)")
    ap.add_argument("--save-coll", action="store_true",
                    help="remat policy: save post-psum activations")
    ap.add_argument("--force-m", type=int, default=None,
                    help="override gradient-accumulation factor")
    ap.add_argument("--variant", default="",
                    help="tag for the results file (perf experiments)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (decode shapes)")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: shard the parameters over the data axes "
                         "(the fit-memory variant; train shapes)")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory of the records (created)")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda or cpu)")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    if args.all:
        cells = [(a, s, mp) for a in ARCH_NAMES for s in SHAPES
                 for mp in meshes[args.mesh]]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, mp) for mp in meshes[args.mesh]]

    recs = []
    for a, s, mp in cells:
        if args.skip_existing:
            p = os.path.join(args.out, _record_name({
                "arch": a, "shape": s, "mesh": _mesh_tag(mp, args.tp),
                "variant": args.variant}))
            if os.path.exists(p):
                with open(p) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        continue
        rec = run_cell(a, s, mp, tp_size=args.tp, save_coll=args.save_coll,
                       force_m=args.force_m, variant=args.variant,
                       kv_int8=args.kv_int8, device=args.device,
                       fsdp=args.fsdp)
        save_record(rec, args.out)
        recs.append(rec)
    failures = sum(r["status"] == "error" for r in recs)
    print(f"done; {failures} failing cells")
    return recs


if __name__ == "__main__":
    raise SystemExit(1 if any(r["status"] == "error" for r in main())
                     else 0)
