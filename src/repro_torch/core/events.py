"""Declared events: what each kernel launch says it does (the perfctr layer).

The JAX package reads its events from compiled XLA artifacts (HLO text,
``cost_analysis``, ``memory_analysis``) without running the program.
PyTorch has no such artifact, so the port turns the source around: every
kernel wrapper declares, at each call, the FLOPs and the HBM bytes its
kernel's model gives for the call's shapes (each input read once, each
output written once, halos counted), and :func:`record_launch` adds them
to every collection open on the calling thread.  The plain PyTorch work
of a model step (GEMMs, weights, the dense engine's masked decode)
declares its share through :func:`record_ops`, which counts no launch.
:mod:`repro_torch.core.perfctr` opens those collections around executed
code and times it with CUDA events.

Where a launch's work depends on the data (the live pages of each row,
a ragged ``kv_valid``), :func:`record_launch_from` takes the small
tensor that decides it: on the card an asynchronous copy to pinned host
memory, no sync, and the wrapper's model turns the host values into
counts when the collection closes (which waits for that copy).  Nothing
is copied while no collection is open.

Events (uppercase, LIKWID style, same names as the JAX package's where
the meaning carries):

==================  ======================================================
FLOPS_TOTAL         floating-point operations the calls' models declare
FLOPS_F32           the part of FLOPS_TOTAL that runs on fp32 CUDA cores
                    (rates divide it by the fp32 peak, the rest by bf16)
BYTES_ACCESSED      HBM bytes declared: HBM_ARG_BYTES + HBM_OUT_BYTES
HBM_ARG_BYTES       input bytes read
HBM_OUT_BYTES       output bytes written
LAUNCHES            wrapper calls: kernel launches on the card, plain-
                    version calls on the CPU (a plain impl the kernel
                    registry picks declares its work as ops, no launch)
HBM_PEAK_BYTES      ``torch.cuda.max_memory_allocated`` over a measured
                    call (0 on the CPU)

ICI_*_BYTES         a collective's wire bytes by kind (``AG`` all-gather,
                    ``AR`` all-reduce, ``RS``, ``A2A``, ``CP`` point to
                    point), the reference's ring model
                    (:func:`wire_bytes`), and ICI_TOTAL_BYTES their sum
ICI_*_COUNT         collectives by kind
==================  ======================================================

The collectives declare themselves (:func:`record_collective`, called by
:class:`repro_torch.launch.mesh.MeshAxis` on every collective over more
than one rank, and by the dry run's counting axes); the ``ICI`` names
are the reference's, the link here is NVLink.  The other events of the
JAX catalogue (fusion counts, remat duplicates) have no source here and
read 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

__all__ = ["EventCounts", "DECLARED_EVENTS", "collect", "active",
           "record_launch", "record_ops", "record_launch_from",
           "record_ops_from", "record_collective", "wire_bytes",
           "COLLECTIVE_KINDS"]

#: (flops, arg_bytes, out_bytes) of one call, from host values
Model = Callable[..., Tuple[float, float, float]]

DECLARED_EVENTS = ("FLOPS_TOTAL", "FLOPS_F32", "BYTES_ACCESSED",
                   "HBM_ARG_BYTES", "HBM_OUT_BYTES", "LAUNCHES",
                   "HBM_PEAK_BYTES")


@dataclasses.dataclass
class EventCounts:
    """A bag of event counts for one measured region."""

    counts: Dict[str, float]
    # data-dependent launches whose counts wait for their host copies:
    # (ready event or None, host tensor, model, f32)
    pending: List[tuple] = dataclasses.field(default_factory=list,
                                             repr=False, compare=False)

    def __getitem__(self, k: str) -> float:
        return self.counts.get(k, 0.0)

    def get(self, k: str, default: float = 0.0) -> float:
        return self.counts.get(k, default)

    def to_dict(self) -> Dict:
        """JSON-serializable form."""
        return {"counts": dict(self.counts)}

    @classmethod
    def from_dict(cls, d: Dict) -> "EventCounts":
        return cls(counts={str(k): float(v)
                           for k, v in d.get("counts", {}).items()})

    def table(self, events: Optional[List[str]] = None) -> str:
        """Paper-style raw-event listing; the last line says where the
        counts come from."""
        events = events or sorted(self.counts)
        w = max((len(e) for e in events), default=10) + 2
        lines = [f"| {'Event':<{w}} | {'count':>14} |",
                 f"|{'-'*(w+2)}|{'-'*16}|"]
        for e in events:
            v = self.counts.get(e, 0.0)
            vs = f"{v:.6g}" if v < 1e6 else f"{v:.5e}"
            lines.append(f"| {e:<{w}} | {vs:>14} |")
        lines.append("(declared by the kernels' FLOP and byte models, not "
                     "read from hardware counters)")
        return "\n".join(lines)


# Collections nest per THREAD, like the marker regions of perfctr: a launch
# counts in every collection its own thread has open.
_TLS = threading.local()


def _open() -> List[EventCounts]:
    stack = getattr(_TLS, "open", None)
    if stack is None:
        stack = _TLS.open = []
    return stack


@contextlib.contextmanager
def collect() -> Iterator[EventCounts]:
    """Collect the declared events of every launch on this thread until
    the block exits."""
    ev = EventCounts(counts={e: 0.0 for e in DECLARED_EVENTS})
    stack = _open()
    stack.append(ev)
    try:
        yield ev
    finally:
        stack.pop()
        _settle(ev)


def active() -> bool:
    """Whether a collection is open on this thread."""
    return bool(_open())


def _add(c: Dict[str, float], flops: float, arg_bytes: float,
         out_bytes: float, f32: bool) -> None:
    c["FLOPS_TOTAL"] += flops
    if f32:
        c["FLOPS_F32"] += flops
    c["HBM_ARG_BYTES"] += arg_bytes
    c["HBM_OUT_BYTES"] += out_bytes
    c["BYTES_ACCESSED"] += arg_bytes + out_bytes


def record_launch(*, flops: float, arg_bytes: float, out_bytes: float,
                  f32: bool = True) -> None:
    """Declare one wrapper call; a no-op when no collection is open.  With
    ``f32`` (the default) the call does its math in fp32 on CUDA cores and
    its FLOPs count in FLOPS_F32 too; a tensor-core call passes False."""
    for ev in _open():
        _add(ev.counts, flops, arg_bytes, out_bytes, f32)
        ev.counts["LAUNCHES"] += 1


def record_ops(*, flops: float, arg_bytes: float, out_bytes: float,
               f32: bool = True) -> None:
    """Declare plain PyTorch work (no kernel of the port's): its FLOPs and
    bytes count, it adds no launch."""
    for ev in _open():
        _add(ev.counts, flops, arg_bytes, out_bytes, f32)


#: collective kind -> the short name of its ICI events
COLLECTIVE_KINDS = {"all-gather": "AG", "all-reduce": "AR",
                    "reduce-scatter": "RS", "all-to-all": "A2A",
                    "collective-permute": "CP"}


def wire_bytes(kind: str, result_bytes: int, group_size: int) -> int:
    """Bytes one rank sends for one collective, the reference's ring model
    (``repro/core/events.py``'s ``CollectiveOp.wire_bytes``): an
    all-gather's (g-1)/g of its gathered result, an all-reduce's
    2 (g-1)/g of its buffer, a reduce-scatter's (g-1) results, an
    all-to-all's (g-1)/g, a point-to-point copy its whole buffer."""
    g, b = max(int(group_size), 1), int(result_bytes)
    if kind == "all-gather":
        return b * (g - 1) // g
    if kind == "all-reduce":
        return 2 * b * (g - 1) // g
    if kind == "reduce-scatter":
        return b * (g - 1)
    if kind == "all-to-all":
        return b * (g - 1) // g
    return b


def record_collective(kind: str, result_bytes: int, group_size: int
                      ) -> None:
    """Declare one collective over ``group_size`` ranks whose result
    buffer holds ``result_bytes``; a no-op when no collection is open."""
    short = COLLECTIVE_KINDS[kind]
    wire = wire_bytes(kind, result_bytes, group_size)
    for ev in _open():
        c = ev.counts
        for k, v in ((f"ICI_{short}_BYTES", wire), (f"ICI_{short}_COUNT", 1),
                     ("ICI_TOTAL_BYTES", wire)):
            c[k] = c.get(k, 0.0) + v


def record_launch_from(t: torch.Tensor, model: Model,
                       f32: bool = True) -> None:
    """Declare one wrapper call whose counts depend on the values of the
    small tensor ``t``: ``model(host_array)`` gives (flops, arg_bytes,
    out_bytes).  A no-op when no collection is open.  A CUDA ``t`` is
    copied to pinned host memory on the current stream without a sync (a
    later in-place write to ``t`` does not reach the copy); the model runs
    when each collection closes."""
    _record_from(t, model, f32, launch=True)


def record_ops_from(t: torch.Tensor, model: Model, f32: bool = True) -> None:
    """:func:`record_launch_from` for plain PyTorch work: the same
    data-dependent counts, no launch."""
    _record_from(t, model, f32, launch=False)


def _record_from(t: torch.Tensor, model: Model, f32: bool,
                 launch: bool) -> None:
    stack = _open()
    if not stack:
        return
    record = record_launch if launch else record_ops
    if t.device.type != "cuda":
        flops, arg_bytes, out_bytes = model(t.detach().cpu().numpy())
        record(flops=flops, arg_bytes=arg_bytes, out_bytes=out_bytes,
               f32=f32)
        return
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t.detach(), non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    for ev in stack:
        if launch:
            ev.counts["LAUNCHES"] += 1
        ev.pending.append((ready, host, model, f32))


def _settle(ev: EventCounts) -> None:
    """Count the data-dependent launches of a closing collection."""
    for ready, host, model, f32 in ev.pending:
        ready.synchronize()
        _add(ev.counts, *model(host.numpy()), f32)
    ev.pending.clear()
