"""Marker API (paper §II-A marker mode) — public re-export, and spans.

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

**Spans** instrument the program's own code on the profiler's clock
(the paper's "instrument your own code" mode, read by ``torch.profiler``
instead of a counter).  :func:`span` is on exactly while a
``torch.profiler`` session runs (``torch.autograd._profiler_enabled()``
when it opens)::

    with marker.span("model.attention") as s:
        y = s.output(attention(s.input(x)))

On, it records a host range named ``repro.<name>`` among the profiler's
CPU ops (a ``cpu_op`` with no copy on the device's timeline, so the
device's events and idle gaps are the program's alone; never
``record_function``, whose user annotations the profiler copies onto the
device timeline).  Marked tensors carry it into the backward: the
output's mark opens ``repro.<name>.backward`` when its gradient arrives
and the input's mark closes it when its own does.  The marks are
gradient hooks that return nothing: they add no node to the autograd
graph, dispatch no op (a selective checkpoint's recompute sees the
forward's ops, marked or not), save no tensor and launch no kernel; each
span keys its own pair, so the blocks of a stack never collide.  A
backward range still open when the outermost span of the thread that
applied the marks exits (the training step) is closed there, which
covers an input that needs no gradient.  Spans nest per thread; autograd's device thread runs the
backward ranges inside the step's range in time.

Off, :func:`span` returns one shared no-op whose ``input``/``output``
return their tensor: the autograd graph, the kernels and every number
are those of an uninstrumented program.  :meth:`PerfCtr.marker` and
:meth:`PerfCtr.region_timer` open the span of their region, so marker
regions show on the profiler's timeline too.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Callable, List, Optional, Sequence

import torch

if TYPE_CHECKING:
    from repro_torch.core.perfctr import Measurement, PerfCtr

__all__ = ["global_perfctr", "region", "probe", "report", "reset", "span",
           "SPAN_PREFIX"]

_GLOBAL: Optional["PerfCtr"] = None


def global_perfctr() -> "PerfCtr":
    global _GLOBAL
    from repro_torch.core.perfctr import PerfCtr
    if _GLOBAL is None:
        _GLOBAL = PerfCtr()
    return _GLOBAL


def region(name: str):
    return global_perfctr().marker(name)


def probe(fn: Callable, *args, **kwargs) -> "Measurement":
    return global_perfctr().probe(fn, *args, **kwargs)


def report(groups: Optional[Sequence[str]] = None) -> str:
    return global_perfctr().report(groups)


def reset() -> None:
    """Reset accumulated regions on the global counter (its chip and
    device survive)."""
    if _GLOBAL is not None:
        _GLOBAL.reset_regions()


# ------------------------------------------------------------------ spans
#: the prefix of every span's range in the profiler's trace
SPAN_PREFIX = "repro."


def _open_range(name: str):
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


class _Backward:
    """One span's backward range: opened by its output's mark, closed by
    its input's mark or by the outermost span of the forward's thread."""

    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def open(self) -> None:
        if self.rf is None and torch.autograd._profiler_enabled():
            self.rf = _open_range(self.name)

    def close(self) -> None:
        rf, self.rf = self.rf, None
        if rf is not None:
            rf.__exit__(None, None, None)

    def on_output(self, grad: torch.Tensor) -> None:
        self.open()

    def on_input(self, grad: torch.Tensor) -> None:
        self.close()


# the outermost open span of each thread
_TLS = threading.local()


class _Span:
    """An open span (see the module note)."""

    __slots__ = ("name", "_rf", "_root", "_pairs", "_pair")

    def __init__(self, name: str):
        self.name = name
        self._pair: Optional[_Backward] = None
        self._pairs: List[_Backward] = []

    def __enter__(self) -> "_Span":
        root = getattr(_TLS, "root", None)
        if root is None:
            _TLS.root = self
        self._root = root or self
        self._rf = _open_range(SPAN_PREFIX + self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._root is self:
            _TLS.root = None
            for pair in self._pairs:
                pair.close()
        self._rf.__exit__(None, None, None)
        return False

    def _backward(self) -> _Backward:
        if self._pair is None:
            self._pair = _Backward(SPAN_PREFIX + self.name + ".backward")
            self._root._pairs.append(self._pair)
        return self._pair

    def _mark(self, t: torch.Tensor, hook: str) -> torch.Tensor:
        if t.requires_grad and torch.is_grad_enabled():
            t.register_hook(getattr(self._backward(), hook))
        return t

    def input(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, marked to close this span's backward range."""
        return self._mark(t, "on_input")

    def output(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, marked to open this span's backward range."""
        return self._mark(t, "on_output")


class _Off:
    """The span while no profiler runs: applies nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def input(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def output(self, t: torch.Tensor) -> torch.Tensor:
        return t


_OFF = _Off()


def span(name: str):
    """A span named ``name`` (``repro.<name>`` in the profiler's trace),
    or the shared no-op while no profiler runs."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)
