"""Performance groups: named event sets + derived metrics (likwid-perfctr -g).

Port of ``repro/core/groups.py``: the whole catalogue, with the JAX
package's metric names, over the declared events of
:mod:`repro_torch.core.events` and a GPU data sheet.  Metrics are pure
functions of ``(EventCounts, chip, time_s)``; ``time_s`` is the measured
time of the region (CUDA events on the card) or ``None`` (static).  An
event the port cannot produce (collectives, fusion counts, remat
duplicates) reads 0, as in the reference.

Two differences, both about peaks: the compute term divides the fp32
share of the FLOPs (``FLOPS_F32``, e.g. the stencil and the triad) by the
fp32 CUDA-core peak and the rest by the bf16 tensor peak, never all of it
by the bf16 peak; and the interconnect term is NVLink, 0 on one card.

Group catalogue::

    FLOPS_BF16  compute throughput, tensor-core utilization ceiling
    HBM         memory traffic, arithmetic intensity, bandwidth ceiling
    ICI         per-collective wire bytes, link-bound time (NVLink here)
    ROOFLINE    all three terms + bottleneck verdict
    MOE         expert-parallel traffic: a2a share of wire bytes
    REMAT       recompute waste: duplicate ops, flops overhead estimate
    SERVE       decode-step arithmetic intensity + KV-cache traffic share
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core import hwinfo
from repro_torch.core.events import EventCounts

__all__ = ["Metric", "Group", "GROUPS", "get_group", "list_groups"]


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    # fn(events, chip, time_s) -> value.  time_s may be None (static mode);
    # metrics that need it return float('nan') then, and the table says so.
    fn: Callable[[EventCounts, hwinfo.ChipSpec, Optional[float]], float]


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    description: str
    events: List[str]          # raw events this group reads — printed, always
    metrics: List[Metric]

    def derive(self, ev: EventCounts, chip: hwinfo.ChipSpec,
               time_s: Optional[float] = None) -> Dict[str, float]:
        return {m.name: m.fn(ev, chip, time_s) for m in self.metrics}

    def table(self, ev: EventCounts, chip: hwinfo.ChipSpec,
              time_s: Optional[float] = None, label: str = "") -> str:
        """Render the paper's two-part listing: raw events, then metrics."""
        out = [f"Measuring group {self.name}" + (f"  [{label}]" if label else "")]
        out.append(ev.table(self.events))
        rows = self.derive(ev, chip, time_s)
        w = max(len(k) for k in rows) + 2
        out.append(f"| {'Metric':<{w}} | {'value':>14} |")
        out.append(f"|{'-'*(w+2)}|{'-'*16}|")
        for m in self.metrics:
            v = rows[m.name]
            vs = "n/a (static)" if v != v else (f"{v:.6g}" if abs(v) < 1e6 else f"{v:.5e}")
            out.append(f"| {m.name + ' [' + m.unit + ']':<{w}} | {vs:>14} |")
        return "\n".join(out)


# --------------------------------------------------------------------------
# metric helpers
# --------------------------------------------------------------------------

def t_compute(ev, chip):
    f32 = ev["FLOPS_F32"]
    return ((ev["FLOPS_TOTAL"] - f32) / chip.peak_bf16_flops
            + (f32 / chip.peak_f32_flops if f32 else 0.0))


def _t_memory(ev, chip):
    return ev["BYTES_ACCESSED"] / chip.hbm_bw


def _t_ici(ev, chip):
    b = ev["ICI_TOTAL_BYTES"]
    return b / chip.nvlink_bw if b else 0.0


def _ai(ev, chip, _t):
    b = ev["BYTES_ACCESSED"]
    return ev["FLOPS_TOTAL"] / b if b else float("inf")


def _nan_if_no_time(f):
    def g(ev, chip, t):
        return f(ev, chip, t) if t else float("nan")
    return g


# --------------------------------------------------------------------------
# groups
# --------------------------------------------------------------------------

_FLOPS_BF16 = Group(
    name="FLOPS_BF16",
    description="Compute throughput against the dtype's peak (paper: FLOPS_DP)",
    events=["FLOPS_TOTAL", "FLOPS_F32", "TRANSCENDENTALS", "DOT_COUNT",
            "FUSION_COUNT"],
    metrics=[
        Metric("T_compute", "s", lambda ev, ch, t: t_compute(ev, ch)),
        Metric("Peak fraction if compute-bound", "1",
               lambda ev, ch, t: 1.0),
        Metric("GFLOP (per device)", "GFLOP",
               lambda ev, ch, t: ev["FLOPS_TOTAL"] / 1e9),
        Metric("MFlops/s (measured)", "MFlop/s",
               _nan_if_no_time(lambda ev, ch, t: ev["FLOPS_TOTAL"] / t / 1e6)),
        Metric("MFU (measured)", "1",
               _nan_if_no_time(
                   lambda ev, ch, t: t_compute(ev, ch) / t)),
    ],
)

_HBM = Group(
    name="HBM",
    description="Main-memory traffic and arithmetic intensity (paper: MEM)",
    events=["BYTES_ACCESSED", "HBM_ARG_BYTES", "HBM_OUT_BYTES",
            "HBM_TEMP_BYTES", "HBM_PEAK_BYTES", "FLOPS_TOTAL", "LAUNCHES"],
    metrics=[
        Metric("T_memory", "s", lambda ev, ch, t: _t_memory(ev, ch)),
        Metric("Data volume (per device)", "GB",
               lambda ev, ch, t: ev["BYTES_ACCESSED"] / 1e9),
        Metric("HBM peak footprint", "GiB",
               lambda ev, ch, t: ev["HBM_PEAK_BYTES"] / 2**30),
        Metric("HBM footprint fraction", "1",
               lambda ev, ch, t: ev["HBM_PEAK_BYTES"] / ch.hbm_bytes),
        Metric("Arithmetic intensity", "FLOP/B", _ai),
        Metric("Bandwidth (measured)", "GB/s",
               _nan_if_no_time(lambda ev, ch, t: ev["BYTES_ACCESSED"] / t / 1e9)),
    ],
)

_ICI = Group(
    name="ICI",
    description="Inter-GPU (NVLink) traffic by collective kind; 0 on one card",
    events=["ICI_AG_BYTES", "ICI_AR_BYTES", "ICI_RS_BYTES", "ICI_A2A_BYTES",
            "ICI_CP_BYTES", "ICI_TOTAL_BYTES",
            "ICI_AG_COUNT", "ICI_AR_COUNT", "ICI_RS_COUNT", "ICI_A2A_COUNT",
            "ICI_CP_COUNT", "ICI_ASYNC_COUNT"],
    metrics=[
        Metric("T_ici", "s", lambda ev, ch, t: _t_ici(ev, ch)),
        Metric("Wire volume (per device)", "GB",
               lambda ev, ch, t: ev["ICI_TOTAL_BYTES"] / 1e9),
        Metric("all-reduce share", "1",
               lambda ev, ch, t: (ev["ICI_AR_BYTES"] / ev["ICI_TOTAL_BYTES"])
               if ev["ICI_TOTAL_BYTES"] else 0.0),
        Metric("async (overlappable) ops share", "1",
               lambda ev, ch, t: (ev["ICI_ASYNC_COUNT"] /
                                  max(ev["ICI_AG_COUNT"] + ev["ICI_AR_COUNT"]
                                      + ev["ICI_RS_COUNT"] + ev["ICI_A2A_COUNT"]
                                      + ev["ICI_CP_COUNT"], 1))),
    ],
)

_ROOFLINE = Group(
    name="ROOFLINE",
    description="Three-term roofline: compute vs HBM vs NVLink",
    events=["FLOPS_TOTAL", "FLOPS_F32", "BYTES_ACCESSED", "ICI_TOTAL_BYTES"],
    metrics=[
        Metric("T_compute", "s", lambda ev, ch, t: t_compute(ev, ch)),
        Metric("T_memory", "s", lambda ev, ch, t: _t_memory(ev, ch)),
        Metric("T_ici", "s", lambda ev, ch, t: _t_ici(ev, ch)),
        Metric("Bound", "0=flops,1=hbm,2=ici",
               lambda ev, ch, t: float(max(range(3), key=lambda i: (
                   t_compute(ev, ch), _t_memory(ev, ch), _t_ici(ev, ch))[i]))),
        Metric("Roofline fraction (overlap)", "1",
               lambda ev, ch, t: (max(t_compute(ev, ch), _t_memory(ev, ch),
                                      _t_ici(ev, ch))
                                  / (sum((t_compute(ev, ch), _t_memory(ev, ch),
                                          _t_ici(ev, ch))) or 1.0))),
    ],
)

_MOE = Group(
    name="MOE",
    description="Expert-parallel dispatch traffic",
    events=["ICI_A2A_BYTES", "ICI_A2A_COUNT", "ICI_TOTAL_BYTES", "FLOPS_TOTAL"],
    metrics=[
        Metric("a2a share of wire bytes", "1",
               lambda ev, ch, t: (ev["ICI_A2A_BYTES"] / ev["ICI_TOTAL_BYTES"])
               if ev["ICI_TOTAL_BYTES"] else 0.0),
        Metric("a2a volume", "GB", lambda ev, ch, t: ev["ICI_A2A_BYTES"] / 1e9),
        Metric("T_a2a", "s",
               lambda ev, ch, t: (ev["ICI_A2A_BYTES"] / ch.nvlink_bw)
               if ev["ICI_A2A_BYTES"] else 0.0),
    ],
)

_REMAT = Group(
    name="REMAT",
    description="Recompute waste introduced by activation checkpointing",
    events=["REMAT_DUP_OPS", "DOT_COUNT", "FLOPS_TOTAL", "HLO_LINES"],
    metrics=[
        Metric("duplicate ops", "#", lambda ev, ch, t: ev["REMAT_DUP_OPS"]),
        Metric("dup fraction of dots", "1",
               lambda ev, ch, t: ev["REMAT_DUP_OPS"] / max(ev["DOT_COUNT"], 1)),
    ],
)

_SERVE = Group(
    name="SERVE",
    description="Decode-step balance: KV traffic vs weight traffic",
    events=["BYTES_ACCESSED", "HBM_ARG_BYTES", "FLOPS_TOTAL"],
    metrics=[
        Metric("Arithmetic intensity", "FLOP/B", _ai),
        Metric("T_memory", "s", lambda ev, ch, t: _t_memory(ev, ch)),
        Metric("weight-read share of traffic", "1",
               lambda ev, ch, t: min(ev["HBM_ARG_BYTES"] /
                                     max(ev["BYTES_ACCESSED"], 1.0), 1.0)),
    ],
)

GROUPS: Dict[str, Group] = {
    g.name: g for g in
    (_FLOPS_BF16, _HBM, _ICI, _ROOFLINE, _MOE, _REMAT, _SERVE)
}


def get_group(name: str) -> Group:
    try:
        return GROUPS[name.upper()]
    except KeyError:
        raise ValueError(f"unknown group {name!r}; available: {sorted(GROUPS)}")


def list_groups() -> str:
    w = max(len(n) for n in GROUPS) + 2
    lines = [f"{'Group':<{w}} Description"]
    for name, g in sorted(GROUPS.items()):
        lines.append(f"{name:<{w}} {g.description}")
        lines.append(f"{'':<{w}}   events: {', '.join(g.events)}")
    return "\n".join(lines)
