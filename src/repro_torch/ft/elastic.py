"""Elastic re-mesh after device/host failure (fault-tolerance substrate).

Port of ``repro/ft/elastic.py``.  The recovery path when heartbeats
declare hosts dead:

1. :func:`plan_remesh` — from the topology and the failed device set,
   choose the largest mesh of the same axis *structure* that fits the
   survivors, using :mod:`repro_torch.core.pin` skip masks to hold out the
   dead devices (LIKWID's skip-mask concept doing FT duty: the paper skips
   shepherd threads, we skip dead ranks).  Data-axis shrink first: model
   parallelism degree is preserved so param shardings stay valid.
2. :func:`build_mesh_from_plan` — the plan as the port's mesh (a
   ``DeviceMesh`` over the plan's ranks; collective over the world).
3. :func:`reshard_tree` — each rank takes its slice of a full host tensor
   under the new layout (the reference ``device_put``s each leaf with its
   ``NamedSharding``).

:class:`RemeshGovernor`, :class:`RemeshPlan` and :func:`plan_remesh` are
copied (numpy and Python over the port's ``core/pin.py`` and
``core/topology.py``).  The serving engine uses all four
(``Engine.apply_remesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.pin import get_strategy
from repro_torch.core.topology import NodeTopology

__all__ = ["RemeshPlan", "RemeshGovernor", "plan_remesh",
           "build_mesh_from_plan", "reshard_tree", "local_slice",
           "gather_slice"]


class RemeshGovernor:
    """Flap suppression between detection and the (expensive) re-mesh.

    Heartbeat gaps and slow steps are noisy: a GC pause or one slow
    segment can make a healthy device look dead for an observation or two,
    and a re-mesh costs rebuilding every process group and moving the
    live KV.  The governor sits between the detectors and
    :func:`plan_remesh`: a device must stay *missing* for
    ``confirm_missing`` consecutive observations (or *slow* for
    ``confirm_slow``) before :meth:`observe` confirms it; any tick
    where it looks healthy resets its counter, so a straggler that
    recovers before confirmation never triggers a re-mesh.  Confirmed
    devices stay confirmed (death is sticky) but are reported exactly
    once — the caller accumulates them into its failed set.
    """

    def __init__(self, confirm_missing: int = 2, confirm_slow: int = 3):
        if confirm_missing < 1 or confirm_slow < 1:
            raise ValueError("confirmation thresholds must be >= 1")
        self.confirm_missing = confirm_missing
        self.confirm_slow = confirm_slow
        self._missing: dict = {}
        self._slow: dict = {}
        self.confirmed: set = set()

    def observe(self, missing: Sequence[int] = (),
                slow: Sequence[int] = ()) -> set:
        """Feed one observation; returns devices *newly* confirmed dead."""
        for table, seen, need in (
                (self._missing, set(missing), self.confirm_missing),
                (self._slow, set(slow), self.confirm_slow)):
            for dev in [d for d in table if d not in seen]:
                del table[dev]               # looked healthy: flap, reset
            for dev in seen:
                table[dev] = table.get(dev, 0) + 1
        fresh = set()
        for table, need in ((self._missing, self.confirm_missing),
                            (self._slow, self.confirm_slow)):
            fresh |= {dev for dev, n in table.items()
                      if n >= need and dev not in self.confirmed}
        self.confirmed |= fresh
        return fresh


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device_ids: Tuple[int, ...]       # ordered survivors filling the mesh
    dropped: Tuple[int, ...]          # failed + surplus devices (skip mask)

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))


def plan_remesh(topo: NodeTopology, failed: Sequence[int],
                axis_names: Sequence[str], axis_sizes: Sequence[int],
                shrink_axis: str = "data",
                strategy: str = "compact") -> RemeshPlan:
    """Shrink ``shrink_axis`` until the mesh fits the surviving devices.

    Model-parallel axes keep their size (param shardings stay valid); the
    shrink axis steps down, surplus survivors join the skip mask as hot
    spares for the *next* failure.
    """
    axis_names = tuple(axis_names)
    axis_sizes = list(axis_sizes)
    if shrink_axis not in axis_names:
        raise ValueError(f"{shrink_axis!r} not in {axis_names}")
    idx = axis_names.index(shrink_axis)

    # drain WHOLE hosts: a dead chip takes its host process (and that
    # host's other chips) out of the job — the realistic failure unit
    failed_hosts = {topo.chip_by_id(i).host for i in failed}
    drained = tuple(sorted(c.device_id for c in topo.chips
                           if c.host in failed_hosts))

    order = get_strategy(strategy)(topo, skip=drained).device_ids
    avail = len(order)
    if avail == 0:
        raise ValueError(
            f"no surviving devices: {len(failed)} failures drained every "
            f"host")
    while int(np.prod(axis_sizes)) > avail:
        if axis_sizes[idx] <= 1:
            raise ValueError(
                f"cannot shrink {shrink_axis} below 1 (survivors={avail}, "
                f"other axes={axis_sizes})")
        axis_sizes[idx] -= 1
        # keep divisibility-friendly sizes (powers of two preferred)
        while axis_sizes[idx] > 1 and avail < int(np.prod(axis_sizes)):
            axis_sizes[idx] -= 1
    need = int(np.prod(axis_sizes))
    used = order[:need]
    spares = tuple(order[need:])
    return RemeshPlan(axis_names=axis_names, axis_sizes=tuple(axis_sizes),
                      device_ids=tuple(used),
                      dropped=drained + spares)


def build_mesh_from_plan(plan: RemeshPlan) -> Any:
    """The plan as the port's mesh: a ``DeviceMesh`` over its ranks, in
    plan order.  Collective: every rank of the world calls it."""
    from repro_torch.launch.mesh import build_mesh
    return build_mesh(plan.device_ids, plan.axis_sizes, plan.axis_names)


Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def local_slice(x: torch.Tensor, spec: Spec, axis_names: Sequence[str],
                axis_sizes: Sequence[int], coord: Sequence[int]
                ) -> torch.Tensor:
    """The block of ``x`` that the rank at mesh coordinate ``coord`` holds
    under ``spec``: a dim sharded over several axes splits major to minor
    in the order the spec lists them, as a ``NamedSharding`` lays it."""
    pos = dict(zip(axis_names, coord))
    size = dict(zip(axis_names, axis_sizes))
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            idx = idx * size[a] + pos[a]
            n *= size[a]
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split "
                             f"over {axes} ({n} ranks)")
        chunk = x.shape[d] // n
        x = x.narrow(d, idx * chunk, chunk)
    return x


def gather_slice(x: torch.Tensor, spec: Spec, axes: Mapping[str, Any],
                 skip: Sequence[str] = (), first: bool = False
                 ) -> Optional[torch.Tensor]:
    """The inverse of :func:`local_slice` over the axes of ``spec`` not in
    ``skip``: each dim split over them is gathered along those axes
    (``axes`` maps a name to this rank's
    :class:`repro_torch.launch.mesh.MeshAxis`), minor first, so the blocks
    land in the order :func:`local_slice` cut them.  Collective over each
    gathered axis.  With ``first`` the blocks gather onto the rank at
    index 0 of every axis only (a gather, not an all-gather): the others
    send their block and get None."""
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        keep = [a for a in names if a not in skip]
        if len(keep) != len(names) and keep:
            raise ValueError(f"dim {d} splits over {names}: gathering only "
                             f"{keep} of them would interleave blocks")
        for a in reversed(keep):
            x = (axes[a].gather_to_first(x, d) if first
                 else axes[a].all_gather(x, d))
            if x is None:
                return None
    return x


def reshard_tree(tree: Mapping[str, Any], pspecs: Mapping[str, Any],
                 mesh: Any, device: Optional[torch.device] = None
                 ) -> Optional[dict]:
    """This rank's slices of a tree of full host tensors under ``pspecs``
    on ``mesh`` (nested mappings, the same keys in both), contiguous on
    ``device``; None when the rank is not in the mesh."""
    from repro_torch.launch.mesh import mesh_layout, mesh_ranks
    names, sizes = mesh_layout(mesh)
    rank = dist.get_rank() if dist.is_initialized() else 0
    hit = np.argwhere(mesh_ranks(mesh) == rank)
    if not len(hit):
        return None
    coord = tuple(int(c) for c in hit[0])

    def walk(t, s):
        if isinstance(t, Mapping):
            return {k: walk(v, s[k]) for k, v in t.items()}
        out = local_slice(t, s, names, sizes, coord)
        return out.to(device or out.device).contiguous()

    return walk(tree, pspecs)
