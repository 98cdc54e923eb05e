"""The program's own spans in a profile: device time and idle by span.

While a ``torch.profiler`` session runs, the port records spans named
``repro.<name>`` among the profiler's CPU ops: host ranges with no copy
on the device's timeline, nested per thread, a backward range running on
autograd's thread inside the step's range in time.  From a profile's
events (``torch.profiler.profile.events()``) and its window (the
``cellbench.window`` range, microseconds):

- ``by_span``: ``{span: [device seconds, device operations]}``.  Each
  device event in the window (kernels, copies and fills, clipped to the
  window as :func:`cellbench.trace.profile_summary` clips them) goes to
  the innermost program range open on its launching thread when it was
  launched: the time and thread of the runtime's launch call that shares
  the event's correlation id (``cudaLaunchKernel`` and the like, which
  the profiler puts on the launching op's thread; torch 2.11's events
  carry no ``linked_correlation_id``), else the event's own start on no
  thread.
  On a thread with no program range open there (autograd's thread
  outside the backward ranges) it goes to the innermost open on any
  thread, the step that thread works for.  Events launched under no
  program range go under ``""``; a backward range counts under its own
  name (``model.attention.backward``).
- ``idle_by_span``: the idle gaps' seconds by the innermost program range
  open on any thread at each gap's middle; where none is, the label
  ``profile_summary`` gives the gap (the innermost ``cellbench.`` span,
  else ``host``).

:func:`step_shares` reads the training step's shares from a summary that
holds both keys.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cellbench.trace import SPAN_PREFIX as BENCH_PREFIX
from cellbench.trace import _merge

__all__ = ["PROGRAM_PREFIX", "STEP", "window_of", "span_summary",
           "step_shares"]

PROGRAM_PREFIX = "repro."
#: the program's training-step span, which every ``train.`` and ``model.``
#: span of a training profile lies in
STEP = "train.step"

#: the CUDA runtime's and driver's calls among the profiler's CPU events
RUNTIME_PREFIX = "cu"

Range = Tuple[float, float, Optional[int], str]


def window_of(evs) -> Optional[Tuple[float, float]]:
    """The profile's window: the ``cellbench.window`` range, or None."""
    for e in evs:
        if (e.name == BENCH_PREFIX + "window"
                and e.device_type != torch.autograd.DeviceType.CUDA):
            return e.time_range.start, e.time_range.end
    return None


def _innermost(ranges: Sequence[Range],
               points: Sequence[Tuple[float, Optional[int]]]
               ) -> List[Optional[str]]:
    """For each point ``(t, thread)``: the name of the innermost range
    open at ``t`` (``start <= t < end``) on that thread, else the
    innermost open on any thread (the last opened), else None."""
    marks = sorted([(a, 1, i) for i, (a, _, _, _) in enumerate(ranges)]
                   + [(b, 0, i) for i, (_, b, _, _) in enumerate(ranges)])
    out: List[Optional[str]] = [None] * len(points)
    active: List[int] = []
    j = 0
    for k in sorted(range(len(points)), key=lambda k: points[k][0]):
        t, thread = points[k]
        while j < len(marks) and marks[j][0] <= t:
            _, opening, i = marks[j]
            if opening:
                active.append(i)
            elif i in active:
                active.remove(i)
            j += 1
        pick = next((i for i in reversed(active)
                     if ranges[i][2] == thread), None)
        if pick is None and active:
            pick = active[-1]
        out[k] = None if pick is None else ranges[pick][3]
    return out


def span_summary(evs, window: Tuple[float, float]) -> dict:
    """``by_span`` and ``idle_by_span`` of the events ``evs`` over
    ``window`` (see the module note)."""
    cuda = torch.autograd.DeviceType.CUDA
    program: List[Range] = []
    bench: List[Range] = []
    runtime: Dict[int, Tuple[float, int]] = {}
    dev = []
    for e in evs:
        tr = e.time_range
        if e.device_type == cuda:
            if not e.name.startswith(BENCH_PREFIX):
                dev.append(e)
            continue
        if e.name.startswith(PROGRAM_PREFIX):
            program.append((tr.start, tr.end, e.thread,
                            e.name[len(PROGRAM_PREFIX):]))
        elif (e.name.startswith(BENCH_PREFIX)
              and e.name != BENCH_PREFIX + "window"):
            bench.append((tr.start, tr.end, e.thread,
                          e.name[len(BENCH_PREFIX):]))
        if e.name.startswith(RUNTIME_PREFIX):
            runtime[e.id] = (tr.start, e.thread)
    w0, w1 = window
    kept, points, iv = [], [], []
    for e in dev:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        kept.append((b - a) * 1e-6)
        points.append(runtime.get(e.id, (e.time_range.start, None)))
        iv.append((a, b))
    by_span: Dict[str, List[float]] = {}
    for s, name in zip(kept, _innermost(program, points)):
        v = by_span.setdefault(name or "", [0.0, 0])
        v[0] += s
        v[1] += 1
    edges = [w0] + [x for ab in _merge(iv) for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(0.5 * (a + b), None) for a, b in gaps]
    idle_by_span: Dict[str, float] = {}
    for (a, b), own, label in zip(gaps, _innermost(program, mids),
                                  _innermost(bench, mids)):
        key = own or label or "host"
        idle_by_span[key] = idle_by_span.get(key, 0.0) + (b - a) * 1e-6
    return {"by_span": by_span, "idle_by_span": idle_by_span}


def _in_step(name: str) -> bool:
    return name == STEP or name.startswith(("train.", "model."))


def step_shares(summary: dict) -> Dict[str, Optional[float]]:
    """The training step's shares, in %, from a summary with ``by_span``
    and ``idle_by_span``: the device seconds under ``model.attention``
    (forward and recompute) and its backward, under ``model.head_loss``
    and its backward, and under ``train.optimizer``, each over
    ``busy_s``; and the idle seconds whose innermost program range lies
    in ``train.step`` over ``window_s``.  A share whose spans the
    profile lacks is None, and so is each without ``by_span``."""
    by = summary.get("by_span") or {}
    busy = summary.get("busy_s") or 0.0

    def share(*names):
        if busy <= 0 or not any(n in by for n in names):
            return None
        return 100.0 * sum(by[n][0] for n in names if n in by) / busy

    idle = None
    if STEP in by and summary.get("window_s"):
        idle = 100.0 * sum(
            s for k, s in summary["idle_by_span"].items() if _in_step(k)
        ) / summary["window_s"]
    return {"model.attention_share.train":
            share("model.attention", "model.attention.backward"),
            "model.head_loss_share.train":
            share("model.head_loss", "model.head_loss.backward"),
            "trainer.optimizer_share": share("train.optimizer"),
            "device.idle_in_step.train": idle}
