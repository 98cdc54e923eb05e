"""Meshes of ranks, pin-aware: the production mesh, the serving mesh
(:class:`ServeMesh`), the axis -> link map and the process-group
bootstrap.

Port of ``repro/launch/mesh.py``.  The JAX package's mesh is one
controller's grid of devices, partitioned by GSPMD.  PyTorch's idiom for
tensor parallelism is one process a device under ``torch.distributed``,
so here a *device* is a rank of the default process group and
``device_ids`` are ranks.  Every rank runs the same program; only tensor
work is split (``repro_torch/serve/engine.py``).

**The mesh** is PyTorch's own ``torch.distributed.device_mesh.DeviceMesh``
with dims ``("data", "model")``.  It takes a world with ranks outside the
mesh (hot spares, a rank whose death is simulated): such a rank builds the
same ``DeviceMesh``, because creating its groups is collective over the
whole world, and gets no coordinate in it (``get_coordinate()`` is None).
So every rank builds every mesh, in the same order.  Checked on torch 2.13
(CPU, gloo) and on the card's torch (``chip_smoke.py`` phase 24).

**The bootstrap** (:func:`init_process`): the rank, the world size and the
store come from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``) or from an explicit ``init_method``
(``file://`` store); with neither, the process is a world of one over an
in-memory store.  The backend is ``nccl`` when each rank has its own card
(``cuda:<local rank>``) and ``gloo`` on the CPU; ranks that share one card
pass ``backend="gloo"`` (NCCL refuses two ranks on one device).  Gloo runs
its collectives on host tensors here: every op on a CUDA tensor is staged
through an explicit host copy (:func:`_wire`), as gloo's CUDA paths differ
between builds.

**Axes.**  A rank's line along one axis is a :class:`MeshAxis` (its
group, size and index; :func:`axis_of`): :class:`ModelAxis` for
``model``, whose collectives the tensor-parallel model code calls and
which carry gradients in Megatron's pattern under autograd, and
:class:`DataAxis` for the batch axes (``pod``, ``data``), over which a
training step sums its loss's token counts and its gradients.

**Orders.**  :func:`make_serve_mesh` synthesizes the reference's torus for
the world's size (``repro/launch/mesh.py:113-116``), orders the ranks with
the pin strategy, uses the first ``prod(shape)`` and returns the rest as
``spares`` (the skip mask first, then the pin-ordered surplus);
:func:`serve_order` is that order as a pure function.
:func:`make_production_mesh` needs a world of 256 (or 512) ranks; its
order is :func:`production_order`.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import events
from repro_torch.core import pin as pin_mod
from repro_torch.core import topology as topo_mod

__all__ = ["make_production_mesh", "production_order", "mesh_axes",
           "production_topology", "ServeMesh", "make_serve_mesh",
           "serve_order", "axis_ici_map", "init_process",
           "leave_process_group", "rank_device",
           "build_mesh", "mesh_layout", "mesh_ranks", "mesh_coordinate",
           "MeshAxis", "ModelAxis", "DataAxis", "BATCH_AXES", "axis_of",
           "model_axis", "data_axis", "broadcast", "send", "recv",
           "spawn"]

#: this rank's device, set by :func:`init_process`
_RANK_DEVICE: Dict[str, torch.device] = {}


# ---------------------------------------------------------------------------
# bootstrap
# ---------------------------------------------------------------------------

def init_process(device: Any = None, *, backend: Optional[str] = None,
                 init_method: Optional[str] = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 timeout_s: float = 600.0) -> torch.device:
    """Join (or form) the default process group; returns this rank's
    device.

    ``device``: ``"cuda"`` (the default) gives each rank
    ``cuda:<LOCAL_RANK>`` (else ``rank % device_count``); an explicit
    ``"cuda:0"`` puts every rank on that card (then pass
    ``backend="gloo"``); ``"cpu"`` runs on the host.  A rank that cannot
    join raises: it never serves alone."""
    dev = torch.device("cuda" if device is None else device)
    if not dist.is_initialized():
        env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
        if init_method is None and not env:
            if (rank or 0) != 0 or (world_size or 1) != 1:
                raise ValueError(
                    "a world of more than one rank needs the torchrun "
                    "environment (RANK, WORLD_SIZE, MASTER_ADDR, "
                    "MASTER_PORT) or an init_method such as file://PATH")
        if env:
            rank = int(os.environ["RANK"])
            world_size = int(os.environ["WORLD_SIZE"])
        rank, world_size = int(rank or 0), int(world_size or 1)
        shared = dev.type == "cuda" and dev.index is not None
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if backend == "nccl" and shared and world_size > 1:
            raise ValueError(
                f"NCCL needs one card a rank; {world_size} ranks on {dev} "
                f"need backend='gloo'")
        if dev.type == "cuda":
            if dev.index is None:
                local = int(os.environ.get(
                    "LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
                dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
        timeout = datetime.timedelta(seconds=timeout_s)
        if init_method is None and not env:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1, timeout=timeout)
        else:
            dist.init_process_group(
                backend, init_method=init_method or "env://", rank=rank,
                world_size=world_size, timeout=timeout)
    elif dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _RANK_DEVICE["device"] = dev
    return dev


def leave_process_group() -> None:
    """Leave the default process group, if this process is in one, and
    forget the rank's device: a later :func:`init_process` forms a new
    group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE.clear()


def _spawned(rank: int, nprocs: int, init_method: str, target: Callable,
             args: tuple, results: Any) -> None:
    try:
        out = target(rank, nprocs, init_method, *args)
        results.put((rank, True, out))
    except BaseException:                   # report, never hang the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        leave_process_group()


def spawn(target: Callable, nprocs: int, args: tuple = (),
          timeout_s: float = 300.0) -> List[Any]:
    """Run ``target(rank, nprocs, init_method, *args)`` in ``nprocs``
    fresh processes over one ``file://`` store (no network) and return
    their results in rank order.  ``target`` is a module-level function
    that calls :func:`init_process` with ``init_method``.  A rank that
    raises, or a run past ``timeout_s``, raises here, and every process
    started is stopped."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro-mesh-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_spawned, args=(
            r, nprocs, init, target, tuple(args), results), daemon=True)
            for r in range(nprocs)]
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout_s)
        try:
            while len(got) < nprocs:
                left = (deadline - datetime.datetime.now()).total_seconds()
                try:
                    rank, ok, out = results.get(timeout=max(left, 0.1))
                except queue_mod.Empty:
                    raise TimeoutError(
                        f"{nprocs - len(got)} of {nprocs} ranks gave no "
                        f"result within {timeout_s:.0f} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
        finally:
            for p in procs:
                p.join(timeout=10 if len(got) == nprocs else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
    return [got[r] for r in range(nprocs)]


def rank_device() -> torch.device:
    """This rank's device (:func:`init_process`; the CPU before it)."""
    return _RANK_DEVICE.get("device", torch.device("cpu"))


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the default backend takes it: host memory for gloo, the
    rank's card for NCCL (a copy only where the two differ)."""
    if dist.get_backend() == "gloo":
        return t.cpu() if t.is_cuda else t
    return t if t.is_cuda else t.to(rank_device())


def _back(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if w is not t:
        t.copy_(w)
    return t


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of the world, in
    place."""
    if dist.get_world_size() == 1:
        return t
    w = _wire(t.contiguous())
    dist.broadcast(w, src)
    return _back(t, w)


def send(t: torch.Tensor, dst: int) -> None:
    dist.send(_wire(t.contiguous()), dst)


def recv(t: torch.Tensor, src: int) -> torch.Tensor:
    """Receive into ``t`` (in place) from global rank ``src``."""
    w = _wire(t)
    if w is t and not t.is_contiguous():
        w = t.contiguous()
    dist.recv(w, src)
    return _back(t, w)


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _ReduceOut(torch.autograd.Function):
    """Out of a split region: the forward sums the ranks' partial values,
    the backward passes the gradient through (every rank's downstream is
    the same, so each partial value's gradient is the whole one)."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis._reduce(x, "sum", fresh=True)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    """Into a split region: the forward is the tensor itself, the backward
    sums the ranks' partial gradients (each rank's region sees only its
    share of the tensor's uses)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._reduce(g, "sum", fresh=True), None


class _GatherOut(torch.autograd.Function):
    """Out of a split region by concatenation: the backward keeps this
    rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis._gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        n = g.shape[dim] // axis.size
        return g.narrow(dim, axis.index * n, n).contiguous(), None, None


class _GatherSeq(torch.autograd.Function):
    """Into a column-parallel region under sequence parallelism: the
    forward gathers the ranks' slices of the sequence, the backward
    reduce-scatters the region's partial gradients (each rank's region
    sees only its heads' or columns' share of the whole sequence)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis._gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._reduce_scatter(g, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    """Out of a row-parallel region under sequence parallelism: the
    forward sums the ranks' partial values and keeps this rank's slice of
    the sequence, the backward gathers the slices' gradients (every
    rank's partial value feeds every slice)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis._reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._gather(g, ctx.dim), None, None


class _SplitSeq(torch.autograd.Function):
    """A tensor every rank holds whole, cut to this rank's slice of the
    sequence: no collective forward, the backward gathers the slices'
    gradients (the whole tensor's gradient, on every rank)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._gather(g, ctx.dim), None, None


class MeshAxis:
    """This rank's line of the mesh along one axis: its process group,
    its size and this rank's index on it.  Over one rank every op is the
    tensor itself.  Each collective over more than one rank declares its
    wire bytes (:func:`repro_torch.core.events.record_collective`).

    With no gradient to carry each op is the plain collective (the
    serving forward's cost).  Under autograd (grad mode on and an input
    that needs a gradient) they follow Megatron's pattern:
    :meth:`all_reduce` leaves a split region (forward sum, backward
    identity), :meth:`copy_in` enters one (forward identity, backward
    sum) and :meth:`all_gather` leaves one by concatenation (backward:
    this rank's slice).  A replicated tensor that feeds a split region
    must enter it through :meth:`copy_in`, else its gradient, and every
    gradient upstream of it, is this rank's share only.

    Sequence parallelism adds two pairs along a sequence dim:
    :meth:`gather_seq` into a column-parallel region (forward all-gather,
    backward reduce-scatter) and :meth:`reduce_scatter` out of a
    row-parallel one (forward reduce-scatter, backward all-gather), and
    :meth:`split`, a whole tensor cut to this rank's slice (backward
    all-gather).  Gloo has no reduce-scatter: there it is an all-reduce
    and a slice, declared as a reduce-scatter with its own wire bytes."""

    def __init__(self, group: Any, size: int, index: int):
        self.group, self.size, self.index = group, int(size), int(index)

    def _reduce(self, x: torch.Tensor, op: str,
                fresh: bool = False) -> torch.Tensor:
        """The collective, in place on ``x`` where ``x`` is already on the
        wire (the serving forward's fresh partial sums), on a copy with
        ``fresh`` (an autograd input or gradient)."""
        events.record_collective("all-reduce", x.numel() * x.element_size(),
                                 self.size)
        w = _wire(x.contiguous())
        if fresh and w is x:
            w = w.clone()
        dist.all_reduce(w, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        return w.to(x.device) if w.device != x.device else w

    def _gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        events.record_collective(
            "all-gather", x.numel() * x.element_size() * self.size,
            self.size)
        w = _wire(x.contiguous())
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return torch.cat(parts, dim=dim).to(x.device)

    def _reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the axis of ``x``, this rank's block of ``dim``."""
        n = x.shape[dim] // self.size
        events.record_collective(
            "reduce-scatter", x.numel() * x.element_size() // self.size,
            self.size)
        w = _wire(x.movedim(dim, 0).contiguous())
        if dist.get_backend(self.group) == "gloo":
            if w is x or w.data_ptr() == x.data_ptr():
                w = w.clone()
            dist.all_reduce(w, group=self.group)
            out = w.narrow(0, self.index * n, n)
        else:
            out = w.new_empty((n,) + tuple(w.shape[1:]))
            dist.reduce_scatter_tensor(out, w, group=self.group)
        return out.movedim(0, dim).contiguous().to(x.device)

    def gather_seq(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' slices of ``dim`` gathered into a column-parallel
        region (see the class note)."""
        if self.size == 1:
            return x
        if _needs_grad(x):
            return _GatherSeq.apply(x, self, dim)
        return self._gather(x, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' partial values summed, this rank's slice of ``dim``
        (see the class note)."""
        if self.size == 1:
            return x
        if _needs_grad(x):
            return _ScatterSeq.apply(x, self, dim)
        return self._reduce_scatter(x, dim)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``dim`` of a tensor every rank holds whole
        (see the class note)."""
        if self.size == 1:
            return x
        if _needs_grad(x):
            return _SplitSeq.apply(x, self, dim)
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or ``op="max"``, never differentiated) over the
        axis."""
        if self.size == 1:
            return x
        if op == "sum" and _needs_grad(x):
            return _ReduceOut.apply(x, self)
        return self._reduce(x.detach() if op == "max" else x, op)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` entering a split region (see the class note)."""
        if self.size == 1 or not _needs_grad(x):
            return x
        return _CopyIn.apply(x, self)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' blocks concatenated along ``dim`` in index order."""
        if self.size == 1:
            return x
        if _needs_grad(x):
            return _GatherOut.apply(x, self, dim)
        return self._gather(x, dim)

    def gather_to_first(self, x: torch.Tensor, dim: int
                        ) -> Optional[torch.Tensor]:
        """The ranks' blocks concatenated along ``dim`` on the rank of
        index 0 (None on the others, which only send): a gather, never
        differentiated."""
        if self.size == 1:
            return x
        w = _wire(x.detach().contiguous())
        first = self.index == 0
        parts = [torch.empty_like(w) for _ in range(self.size)] if first \
            else None
        dist.gather(w, parts, dst=dist.get_global_rank(self.group, 0),
                    group=self.group)
        return torch.cat(parts, dim=dim).to(x.device) if first else None

    def __repr__(self) -> str:
        return f"{type(self).__name__}(size={self.size}, index={self.index})"


class ModelAxis(MeshAxis):
    """The ``model`` axis: the tensor-parallel forward
    (:mod:`repro_torch.models.layers`) reduces and gathers through it."""


class DataAxis:
    """The batch axes of a mesh (``data``, and ``pod`` before it on the
    multi-pod mesh), major to minor, as one axis: the train loss sums its
    token counts and the step its gradients over it.  ``index`` is this
    rank's position in batch order (the reference's ``batch -> (pod,
    data)`` rule lays rows out major to minor)."""

    def __init__(self, parts: Sequence[MeshAxis] = ()):
        self.parts = tuple(p for p in parts if p.size > 1)
        self.size = int(np.prod([p.size for p in self.parts] or [1]))
        idx = 0
        for p in self.parts:
            idx = idx * p.size + p.index
        self.index = idx

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        for p in self.parts:
            x = p.all_reduce(x, op)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        for p in reversed(self.parts):        # minor first
            x = p.all_gather(x, dim)
        return x

    def __repr__(self) -> str:
        return f"DataAxis(size={self.size}, index={self.index})"


#: the axes a batch splits over, major to minor (``batch -> (pod, data)``)
BATCH_AXES = ("pod", "data")


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def mesh_layout(mesh: Any) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, axis sizes) of a ``DeviceMesh``, a :class:`ServeMesh`
    or a duck-typed mesh (``axis_names`` plus ``devices`` or a ``shape``
    mapping)."""
    mesh = mesh.mesh if isinstance(mesh, ServeMesh) else mesh
    names =getattr(mesh, "mesh_dim_names", None) or tuple(mesh.axis_names)
    if isinstance(getattr(mesh, "mesh", None), torch.Tensor):
        sizes = tuple(mesh.mesh.shape)
    elif hasattr(mesh, "devices"):
        sizes = tuple(np.shape(mesh.devices))
    else:
        sizes = tuple(int(mesh.shape[a]) for a in names)
    return tuple(names), tuple(int(s) for s in sizes)


def mesh_ranks(mesh: Any) -> np.ndarray:
    """The mesh's grid of global ranks."""
    mesh = mesh.mesh if isinstance(mesh, ServeMesh) else mesh
    grid = getattr(mesh, "mesh", None)
    if isinstance(grid, torch.Tensor):
        return grid.cpu().numpy().astype(np.int64)
    return np.asarray(mesh.devices, dtype=np.int64)


def build_mesh(ranks: Sequence[int], shape: Sequence[int],
               axes: Sequence[str]) -> Any:
    """A ``DeviceMesh`` over ``ranks`` laid out row-major in ``shape``.
    Collective: every rank of the world calls it, in the same order."""
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.tensor([int(r) for r in ranks],
                        dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(rank_device().type, grid,
                      mesh_dim_names=tuple(axes))


def mesh_coordinate(mesh: Any) -> Optional[Tuple[int, ...]]:
    """This rank's coordinate in ``mesh`` (None when it is not in it)."""
    hit = np.argwhere(mesh_ranks(mesh) == (
        dist.get_rank() if dist.is_initialized() else 0))
    return tuple(int(c) for c in hit[0]) if len(hit) else None


def axis_of(mesh: Any, name: str) -> Optional[MeshAxis]:
    """This rank's :class:`MeshAxis` along ``name`` (a
    :class:`ModelAxis` for ``model``; size 1 when the mesh has no such
    axis), or None when the rank is not in the mesh.  A duck mesh with an
    ``axis_of`` method (the dry run's counting mesh) gives its own."""
    mesh = mesh.mesh if isinstance(mesh, ServeMesh) else mesh
    if callable(getattr(mesh, "axis_of", None)):
        return mesh.axis_of(name)          # a duck mesh with its own axes
    names, sizes = mesh_layout(mesh)
    coord = mesh_coordinate(mesh)
    if coord is None:
        return None
    cls = ModelAxis if name == "model" else MeshAxis
    if name not in names:
        return cls(None, 1, 0)
    k = names.index(name)
    group = mesh.get_group(name) if sizes[k] > 1 else None
    return cls(group, sizes[k], coord[k])


def model_axis(mesh: Any) -> Optional[ModelAxis]:
    """This rank's :class:`ModelAxis` in ``mesh``, or None when the rank
    is not in it."""
    return axis_of(mesh, "model")


def data_axis(mesh: Any) -> Optional[DataAxis]:
    """This rank's :class:`DataAxis` (the mesh's :data:`BATCH_AXES`), or
    None when the rank is not in the mesh."""
    parts = [axis_of(mesh, a) for a in BATCH_AXES]
    return None if parts[0] is None else DataAxis(parts)


def mesh_axes(multi_pod: bool = False) -> Tuple[Tuple[int, ...],
                                                Tuple[str, ...]]:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def production_topology(multi_pod: bool = False) -> topo_mod.NodeTopology:
    spec = (topo_mod.PRODUCTION_MULTI_POD if multi_pod
            else topo_mod.PRODUCTION_SINGLE_POD)
    return topo_mod.synthesize(spec)


def production_order(*, multi_pod: bool = False,
                     pin_strategy: Optional[str] = None,
                     skip: Sequence[int] = ()) -> List[int]:
    """The production mesh's ranks in mesh order: the default order with
    neither a strategy nor a skip mask, else the pin strategy (compact
    by default) over :func:`production_topology` minus ``skip``."""
    shape, _ = mesh_axes(multi_pod)
    need = int(np.prod(shape))
    if pin_strategy is None and not skip:
        return list(range(need))
    topo = production_topology(multi_pod)
    result = pin_mod.get_strategy(pin_strategy or "compact")(topo, skip=skip)
    if len(result.device_ids) < need:
        raise ValueError(
            f"pin[{pin_strategy}] leaves {len(result.device_ids)} devices; "
            f"mesh needs {need} (skip={list(skip)})")
    return list(result.device_ids[:need])


def make_production_mesh(*, multi_pod: bool = False,
                         pin_strategy: Optional[str] = None,
                         skip: Sequence[int] = ()):
    """The production mesh ((16, 16) or (2, 16, 16)) over a world of 256
    (or 512) ranks, in :func:`production_order`."""
    shape, axes = mesh_axes(multi_pod)
    need = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the production mesh {shape} needs a world of {need} ranks; "
            f"this one has {world}")
    order = production_order(multi_pod=multi_pod, pin_strategy=pin_strategy,
                             skip=skip)
    return build_mesh(order, shape, axes)


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """A serving mesh plus the provenance the ft/ path needs to rebuild it.

    ``Engine`` accepts either a bare ``DeviceMesh`` (sharding only) or one
    of these; the extra fields (the synthesized topology, the axis
    structure, the pin ordering and the hot-spare ranks) are what
    :func:`repro_torch.ft.elastic.plan_remesh` needs when a rank dies
    mid-run."""

    mesh: Any                         # torch DeviceMesh
    topo: topo_mod.NodeTopology
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    pin: pin_mod.PinResult
    spares: Tuple[int, ...]           # hot-spare ranks (skip mask +
                                      # pin-ordered surplus), failover order

    @property
    def device_ids(self) -> Tuple[int, ...]:
        return tuple(int(r) for r in mesh_ranks(self.mesh).flat)


def serve_order(world: int, shape: Sequence[int], *,
                pin_strategy: str = "compact", skip: Sequence[int] = (),
                chips_per_host: int = 1
                ) -> Tuple[topo_mod.NodeTopology, pin_mod.PinResult,
                           Tuple[int, ...], Tuple[int, ...]]:
    """(topology, pin result, mesh ranks, spares) for a world of ``world``
    ranks: the reference's torus for that count, ``chips_per_host=1``
    making each rank its own failure unit."""
    spec = topo_mod.TopoSpec(
        num_pods=1, pod_grid=topo_mod._grid_for_count(world),
        chips_per_host=max(1, min(chips_per_host, world)))
    topo = topo_mod.synthesize(spec)
    result = pin_mod.get_strategy(pin_strategy or "compact")(topo, skip=skip)
    need = int(np.prod(shape))
    if len(result.device_ids) < need:
        raise ValueError(
            f"pin[{pin_strategy}] leaves {len(result.device_ids)} devices; "
            f"mesh needs {need} (shape={tuple(shape)}, skip={list(skip)})")
    used = tuple(result.device_ids[:need])
    spares = tuple(result.skipped) + tuple(result.device_ids[need:])
    return topo, result, used, spares


def make_serve_mesh(shape: Sequence[int],
                    axes: Sequence[str] = ("data", "model"), *,
                    pin_strategy: str = "compact",
                    skip: Sequence[int] = (),
                    chips_per_host: int = 1) -> ServeMesh:
    """The serving engine's mesh over the world's ranks
    (:func:`serve_order`); the ranks it leaves out are ``spares``, the
    failover pool :func:`repro_torch.ft.elastic.plan_remesh` draws from.
    Collective: every rank calls it (:func:`init_process` first)."""
    if not dist.is_initialized():
        raise RuntimeError("make_serve_mesh needs the process group: call "
                           "repro_torch.launch.mesh.init_process(device) "
                           "first")
    topo, result, used, spares = serve_order(
        dist.get_world_size(), shape, pin_strategy=pin_strategy, skip=skip,
        chips_per_host=chips_per_host)
    mesh = build_mesh(used, shape, axes)
    return ServeMesh(mesh=mesh, topo=topo, axis_names=tuple(axes),
                     axis_sizes=tuple(int(s) for s in shape), pin=result,
                     spares=spares)


def axis_ici_map(topo: topo_mod.NodeTopology, device_ids: Sequence[int],
                 shape: Sequence[int], axes: Sequence[str]
                 ) -> List[Dict[str, Any]]:
    """Mesh-axis -> link mapping for a pinned device order.

    For each mesh axis: walk every line of the device grid along that
    axis and report the hop distance between consecutive devices in the
    topology's torus model (plus the wrap-around hop that would close the
    ring).  ``ring=True`` means every step along the axis, closure
    included, is a single hop, i.e. the pin strategy laid the axis onto a
    physical ring; ``dcn_crossings`` counts steps that leave the pod."""
    grid = np.asarray(list(device_ids), dtype=np.int64).reshape(tuple(shape))
    out: List[Dict[str, Any]] = []
    for k, name in enumerate(axes):
        lines = np.moveaxis(grid, k, -1).reshape(-1, grid.shape[k])
        hops: List[int] = []
        wrap_hops: List[int] = []
        dcn = 0
        for line in lines:
            for a, b in zip(line[:-1], line[1:]):
                h = topo.ici_hops(int(a), int(b))
                if h < 0:
                    dcn += 1
                else:
                    hops.append(h)
            if len(line) > 1:
                h = topo.ici_hops(int(line[-1]), int(line[0]))
                if h < 0:
                    dcn += 1
                else:
                    wrap_hops.append(h)
        n_steps = max(len(lines) * (grid.shape[k] - 1), 1)
        ring = (dcn == 0 and len(hops) + len(wrap_hops) > 0
                and all(h == 1 for h in hops + wrap_hops))
        out.append({
            "axis": str(name),
            "size": int(grid.shape[k]),
            "mean_hops": float(np.mean(hops)) if hops else 0.0,
            "max_hops": int(max(hops)) if hops else 0,
            "wrap_hops": int(max(wrap_hops)) if wrap_hops else 0,
            "dcn_crossings": int(dcn),
            "steps": int(n_steps),
            "ring": bool(ring),
        })
    return out
