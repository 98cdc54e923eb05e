"""The traced run's readings: host spans from the benchmark's own
wrappers, and the device's work from ``torch.profiler`` over a short
steady window.

The profiler runs over a few seconds only (on the H100 machine a session
late in a long process drops records), started and stopped at points
where the host has just synchronised, so every kernel in its trace was
launched inside it.  From its events come the seconds some operation ran
on the device (the union of the kernels', copies' and fills' intervals),
each kernel's device time by name, the launches, and the idle gaps,
each named after the innermost benchmark span open on the host in its
middle (``host`` where none is).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["Spans", "Profile", "profile_summary"]

SPAN_PREFIX = "cellbench."


class Spans:
    """Host wall seconds of the benchmark's own spans, and a
    ``record_function`` of each for the profiler's trace."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        rf = (torch.profiler.record_function(SPAN_PREFIX + name)
              if self.traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                if sync and torch.cuda.is_available():
                    torch.cuda.synchronize()
        self.seconds[name] = self.seconds.get(name, 0.0) + (
            time.perf_counter() - t0)


class Profile:
    """One ``torch.profiler`` session, started and stopped on demand."""

    def __init__(self, device: Optional[torch.device] = None):
        self.cuda = device is None or device.type == "cuda"
        self.prof: Optional[torch.profiler.profile] = None
        self.t0 = self.t1 = 0.0
        self.active = False
        self.done = False

    def start(self) -> None:
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.active = True
        self.t0 = time.perf_counter()
        self._window = torch.profiler.record_function(SPAN_PREFIX + "window")
        self._window.__enter__()

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def stop(self) -> None:
        self._sync()
        self._window.__exit__(None, None, None)
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.active = False
        self.done = True


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def profile_summary(p: Profile) -> dict:
    """The profiled window's device readings: ``busy_s``, ``window_s``,
    ``kernels`` (device seconds and count by kernel name), ``launches``
    (kernels run), ``device_ops`` and ``idle_gaps`` (the ten largest,
    seconds), ``idle_by_host`` (idle seconds summed by host span) and
    ``host_window_s``, the window by the host's clock."""
    evs = p.prof.events()
    dev_type = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[float, float, str]] = []
    spans: List[Tuple[float, float, str]] = []
    window = None
    for e in evs:
        tr = e.time_range
        if e.name.startswith(SPAN_PREFIX):
            if e.device_type == dev_type:
                continue            # the spans' copies on the GPU timeline
            if e.name == SPAN_PREFIX + "window":
                window = (tr.start, tr.end)
            else:
                spans.append((tr.start, tr.end, e.name[len(SPAN_PREFIX):]))
        elif e.device_type == dev_type:
            dev.append((tr.start, tr.end, e.name))
    if window is None:
        lo = min((a for a, _, _ in dev), default=0.0)
        window = (lo, lo + (p.t1 - p.t0) * 1e6)
    w0, w1 = window
    kernels: Dict[str, List[float]] = {}
    launches = 0
    iv = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        iv.append((a, b))
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
    busy = _merge(iv)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    # the innermost span open at each gap's middle: a sweep over the
    # spans' starts and ends (spans of one thread nest)
    marks = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)]
                   + [(b, 0, i) for i, (_, b, _) in enumerate(spans)])
    idle_by_host: Dict[str, float] = {}
    named = []
    active: List[int] = []
    j = 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while j < len(marks) and marks[j][0] <= mid:
            _, opening, i = marks[j]
            if opening:
                active.append(i)
            elif i in active:
                active.remove(i)
            j += 1
        label = spans[active[-1]][2] if active else "host"
        idle_by_host[label] = idle_by_host.get(label, 0.0) + (b - a) * 1e-6
        named.append((label, (b - a) * 1e-6))
    named.sort(key=lambda x: -x[1])
    ops = sorted(((n, v[0]) for n, v in kernels.items()), key=lambda x: -x[1])
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "host_window_s": p.t1 - p.t0,
            "kernels": kernels, "launches": launches,
            "device_ops": [[n[:120], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in named[:10]],
            "idle_by_host": idle_by_host}
