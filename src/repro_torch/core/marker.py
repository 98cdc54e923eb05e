"""Marker API (paper §II-A marker mode) — public re-export.

Port of ``repro/core/marker.py``.  The marker implementation lives on
:class:`repro_torch.core.perfctr.PerfCtr` (regions accumulate across
calls, the paper's semantics).  This module offers a module-level
convenience for scripts that want a process-global counter::

    from repro_torch.core import marker
    with marker.region("triad"):
        marker.probe(stream_triad, b, c)
    print(marker.report())

The global counter measures on ``cuda`` (it raises where no GPU is
visible); a script on the host creates its own ``PerfCtr(device="cpu")``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from repro_torch.core.perfctr import Measurement, PerfCtr

__all__ = ["global_perfctr", "region", "probe", "report", "reset"]

_GLOBAL: Optional[PerfCtr] = None


def global_perfctr() -> PerfCtr:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = PerfCtr()
    return _GLOBAL


def region(name: str):
    return global_perfctr().marker(name)


def probe(fn: Callable, *args, **kwargs) -> Measurement:
    return global_perfctr().probe(fn, *args, **kwargs)


def report(groups: Optional[Sequence[str]] = None) -> str:
    return global_perfctr().report(groups)


def reset() -> None:
    """Reset accumulated regions on the global counter (its chip and
    device survive)."""
    if _GLOBAL is not None:
        _GLOBAL.reset_regions()
