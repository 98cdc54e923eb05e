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

from repro_torch.core import pin as pin_mod
from repro_torch.core import topology as topo_mod

__all__ = ["make_production_mesh", "production_order", "mesh_axes",
           "production_topology", "ServeMesh", "make_serve_mesh",
           "serve_order", "axis_ici_map", "init_process",
           "leave_process_group", "rank_device",
           "build_mesh", "mesh_layout", "mesh_ranks", "ModelAxis",
           "model_axis", "broadcast", "send", "recv", "spawn"]

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


class ModelAxis:
    """This rank's line of the mesh along ``model``: its process group,
    its size and this rank's index on it.  The tensor-parallel forward
    (:mod:`repro_torch.models.layers`) reduces and gathers through it;
    over one rank both are the tensor itself."""

    def __init__(self, group: Any, size: int, index: int):
        self.group, self.size, self.index = group, int(size), int(index)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if self.size == 1:
            return x
        w = _wire(x.contiguous())
        dist.all_reduce(w, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        return w.to(x.device) if w.device != x.device else w

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        if self.size == 1:
            return x
        w = _wire(x.contiguous())
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return torch.cat(parts, dim=dim).to(x.device)

    def __repr__(self) -> str:
        return f"ModelAxis(size={self.size}, index={self.index})"


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


def model_axis(mesh: Any) -> Optional[ModelAxis]:
    """This rank's :class:`ModelAxis` in ``mesh``, or None when the rank
    is not in it."""
    mesh = mesh.mesh if isinstance(mesh, ServeMesh) else mesh
    names, sizes = mesh_layout(mesh)
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    k = names.index("model")
    return ModelAxis(mesh.get_group("model"), sizes[k], coord[k])


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
