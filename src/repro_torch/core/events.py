"""Declared events: what each kernel launch says it does (the perfctr layer).

The JAX package reads its events from compiled XLA artifacts (HLO text,
``cost_analysis``, ``memory_analysis``) without running the program.
PyTorch has no such artifact, so the port turns the source around: every
kernel wrapper of the tool layer's case studies declares, at each call,
the FLOPs and the HBM bytes its kernel's model gives for the call's
shapes (each input read once, each output written once, halos counted),
and :func:`record_launch` adds them to every collection open on the
calling thread.  :mod:`repro_torch.core.perfctr` opens those collections
around executed code and times it with CUDA events.

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
                    version calls on the CPU
HBM_PEAK_BYTES      ``torch.cuda.max_memory_allocated`` over a measured
                    call (0 on the CPU)
==================  ======================================================

Every other event of the JAX catalogue (collectives, fusion counts,
remat duplicates) has no source here and reads 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, List, Optional

__all__ = ["EventCounts", "DECLARED_EVENTS", "collect", "record_launch"]

DECLARED_EVENTS = ("FLOPS_TOTAL", "FLOPS_F32", "BYTES_ACCESSED",
                   "HBM_ARG_BYTES", "HBM_OUT_BYTES", "LAUNCHES",
                   "HBM_PEAK_BYTES")


@dataclasses.dataclass
class EventCounts:
    """A bag of event counts for one measured region."""

    counts: Dict[str, float]

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


def record_launch(*, flops: float, arg_bytes: float, out_bytes: float,
                  f32: bool = True) -> None:
    """Declare one wrapper call; a no-op when no collection is open.  With
    ``f32`` (the default) the call does its math in fp32 on CUDA cores and
    its FLOPs count in FLOPS_F32 too; a tensor-core call passes False."""
    for ev in _open():
        c = ev.counts
        c["FLOPS_TOTAL"] += flops
        if f32:
            c["FLOPS_F32"] += flops
        c["HBM_ARG_BYTES"] += arg_bytes
        c["HBM_OUT_BYTES"] += out_bytes
        c["BYTES_ACCESSED"] += arg_bytes + out_bytes
        c["LAUNCHES"] += 1
