"""Device meshes on ``torch.distributed`` (port of ``repro.launch.mesh``).

One JAX device is one rank here: one process a card (NCCL), or a CPU
worker (gloo) where the JAX package fakes host devices.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the JAX package's axis names ``("data", "model")``.
The constructors need that group: ``process_group`` starts one in this
process, ``spawn`` starts N processes, one a rank.  Both rendezvous
through a ``FileStore`` in a temporary directory (no network) and take a
timeout, so a stuck rank fails in seconds instead of hanging.
``fake_process_group`` makes this process rank 0 of N ranks that do not
exist (the dry-run's production meshes, ``make_production_mesh``).

Under GSPMD a JAX program on a mesh is ONE program, and every reduction
over the batch is global.  A torch rank runs its own rows, so each such
reduction is made explicit: ``use_mesh`` activates a mesh for the length
of a call, and the batch-coupled sites inside a step ask ``data_max`` /
``data_sum`` for the data group's value (the DBSC activation amax, the
PSSA counters).  Off a mesh both return their input: nothing changes.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import math
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.models.parallel import mesh_shape

AXES = ("data", "model")
DP_AXES = ("pod", "data")
DEFAULT_TIMEOUT_S = 120.0

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                         default=None)


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def process_group(world_size: int = 1, rank: int = 0, device="cuda",
                  path: str | None = None,
                  timeout: float = DEFAULT_TIMEOUT_S):
    """The default process group for the length of the block: rank
    ``rank`` of ``world_size``, NCCL on card ``rank`` or gloo on the CPU,
    rendezvous through a ``FileStore`` at ``path`` (a fresh temporary
    directory when None: a one-rank group).  Destroyed on exit."""
    with contextlib.ExitStack() as stack:
        if path is None:
            if world_size != 1:
                raise ValueError("process_group: ranks of a group of "
                                 f"{world_size} must share a store path")
            path = os.path.join(stack.enter_context(
                tempfile.TemporaryDirectory(prefix="repro_torch_pg_")),
                "store")
        device = torch.device(device)
        kw = {}
        if device.type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
            kw["device_id"] = device
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.FileStore(path, world_size),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout), **kw)
        try:
            yield
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """The default process group for the length of the block on torch's
    ``"fake"`` backend: this process is rank 0 of ``world_size`` ranks
    that do not exist, and every collective returns at once, moving
    nothing (the counterpart of the JAX package's fake host devices,
    ``dryrun.force_fake_devices``).  With ``FakeTensorMode`` it traces
    what one rank of a large mesh would run and issue, on no device
    memory.  Destroyed on exit; never entered at import.

    ``FakeStore`` and the backend come from
    ``torch.testing._internal.distributed.fake_pg``, a private module of
    torch: imported here, and only here."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank, world_size, tmp, device, timeout, fn, args):
    """One spawned rank: join the group, run ``fn``, leave its return
    value in ``tmp`` for the parent."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    with process_group(world_size, rank, device,
                       os.path.join(tmp, "store"), timeout):
        out = fn(*args)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, nprocs: int, args: tuple = (), device="cuda",
          timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``nprocs`` new processes, one rank each of a
    new default group (gloo on the CPU with one intra-op thread a rank,
    NCCL with rank r on card r); return the ranks' return values in rank
    order.  ``fn`` must be importable by name (spawned processes import
    it).  A rank that raises, or a group that is not done within
    ``timeout`` seconds, ends every rank and raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(nprocs, tmp, str(device), timeout, fn, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"spawn: {nprocs} ranks not done in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------
def _need(dp: int, have: int) -> None:
    if have < dp:
        raise ValueError(f"--mesh {dp} needs {dp} devices, have {have}")


def require_devices(dp: int, device) -> None:
    """Raise ``make_data_mesh``'s message when this host cannot give
    ``dp`` ranks on ``device``: each rank needs a card of its own (NCCL
    takes one rank a device); CPU ranks are processes."""
    if torch.device(device).type == "cuda":
        _need(dp, torch.cuda.device_count())


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one with "
                           "launch.mesh.process_group or launch.mesh.spawn")
    return dist.get_world_size()


def group_device() -> str:
    """The device type of the default group's ranks: ``cuda`` (NCCL) or
    ``cpu`` (gloo, and the fake backend, which moves nothing)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, axes=AXES):
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(group_device(), ranks, mesh_dim_names=tuple(axes))


def make_data_mesh(dp: int):
    """(dp, 1) pure data-parallel mesh over the first ``dp`` ranks (the
    rest stay free for other work, as the JAX package leaves devices)."""
    _need(dp, _world())
    return _mesh((dp, 1))


def elastic_shape(n: int, tp_size: int = 16) -> tuple:
    """The (data, model) shape ``make_elastic_mesh`` takes on ``n`` ranks:
    the model axis ``min(tp_size, n)``, lowered until it divides n."""
    tp = min(tp_size, n)
    while n % tp:
        tp -= 1
    return (n // tp, tp)


def make_elastic_mesh(tp_size: int = 16):
    """The largest (data, model) mesh over every live rank: after losing
    hosts a relaunch gets a smaller valid mesh, the data axis absorbing
    the loss."""
    return _mesh(elastic_shape(_world(), tp_size))


def make_production_mesh(*, multi_pod: bool = False, tp_size: int = 16):
    """(256/tp, tp) over axes ("data", "model"), or (2, 256/tp, tp) over
    ("pod", "data", "model") with ``multi_pod``: 256 or 512 ranks, the
    JAX package's single- and multi-pod meshes.  Needs that many ranks in
    the default group (``fake_process_group`` for a dry-run)."""
    per_pod = 256
    if per_pod % tp_size:
        raise ValueError(f"tp {tp_size} does not divide {per_pod}")
    dp = per_pod // tp_size
    shape = (2, dp, tp_size) if multi_pod else (dp, tp_size)
    _need(math.prod(shape), _world())
    return _mesh(shape, (("pod",) if multi_pod else ()) + AXES)


def make_smoke_mesh():
    """(1, 1) mesh on rank 0."""
    _world()
    return _mesh((1, 1))


def mesh_signature(mesh) -> tuple | None:
    """Hashable identity of a mesh: axis names, sizes and ranks (JAX: its
    device ids)."""
    if mesh is None:
        return None
    return (tuple(mesh.mesh_dim_names), tuple(mesh_shape(mesh).values()),
            tuple(int(r) for r in mesh.mesh.flatten().tolist()))


def dp_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in DP_AXES)


def dp_size_of(mesh) -> int:
    """Total data-parallel degree (product of the pod/data axis sizes)."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in dp_axes_of(mesh))


def data_index(mesh) -> int:
    """This rank's index along the data axis; raises off the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh "
                         f"{mesh_shape(mesh)}")
    return int(coord[mesh.mesh_dim_names.index("data")])


def data_group(mesh):
    """The process group of this rank's data axis."""
    return mesh.get_group("data")


# ---------------------------------------------------------------------------
# The active mesh and the batch-coupled reductions
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh for the block (None: none), so the
    batch-coupled reductions below span its data group; the previous one
    is back on exit."""
    token = _ACTIVE.set(None if mesh is None else (mesh, data_group(mesh)))
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    active = _ACTIVE.get()
    return None if active is None else active[0]


def data_max(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a scalar) maxed over the active mesh's data group; ``x``
    itself off a mesh."""
    active = _ACTIVE.get()
    if active is None:
        return x
    out = x.reshape(1).clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=active[1])
    return out.reshape(x.shape)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """Integer ``x`` summed over the active mesh's data group (int64,
    exact); ``x`` itself off a mesh."""
    active = _ACTIVE.get()
    if active is None:
        return x
    if x.dtype != torch.int64:
        raise TypeError(f"data_sum sums int64 counters, got {x.dtype}")
    out = x.reshape(-1).clone()
    dist.all_reduce(out, group=active[1])
    return out.reshape(x.shape)


def all_gather_rows(mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The data group's ``x`` concatenated along ``dim`` in data order
    (every rank's ``x`` has the same shape)."""
    if x.dtype == torch.bool:
        return all_gather_rows(mesh, x.view(torch.uint8), dim).view(
            torch.bool)
    group = data_group(mesh)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def broadcast_(mesh, tensors) -> None:
    """Overwrite ``tensors`` in place with the data group's first rank's."""
    group = data_group(mesh)
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        if t.is_contiguous():
            dist.broadcast(t, src=src, group=group)
        else:
            c = t.contiguous()
            dist.broadcast(c, src=src, group=group)
            t.copy_(c)
