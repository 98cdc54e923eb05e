"""repro-perfctr for the GPU: the measurement tool (likwid-perfCtr).

Port of ``repro/core/perfctr.py``.  The JAX tool's wrapper mode lowers and
compiles a program and reads its events from the artifact without running
it; PyTorch has no such artifact.  Here the measured code is **executed**:
:func:`measure` (and :meth:`PerfCtr.probe`) run ``fn`` once untimed (the
first call of a kernel includes its ``nvcc`` build), then time each of
``repeats`` calls between CUDA events, and collect the events that every
kernel wrapper inside declares for its launches (its FLOP and byte model,
:mod:`repro_torch.core.events`).  That is the retarget ROADMAP item 11
names: CUDA-event timing plus declared models, no HLO parsing.

The three modes keep the paper's shape:

(i)   **wrapper mode** — :func:`measure` around a callable;
(ii)  **marker mode** — ``with PerfCtr().marker("region")`` around
      :meth:`PerfCtr.probe` calls, or :meth:`PerfCtr.region_timer` around
      any executed block; results *accumulate across calls*;
(iii) **multiplex mode** — :meth:`PerfCtr.multiplex` cycles groups over
      executed steps.

Rates divide a region's summed events by the summed time of the calls
that produced them (``Measurement.time_s``), LIKWID's total-over-total.
Marker regions nest per thread, as in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.core import events as events_mod
from repro_torch.core import hwinfo
from repro_torch.core.events import EventCounts
from repro_torch.core.groups import get_group
from repro_torch.device import resolve_device

__all__ = ["Measurement", "PerfCtr", "measure", "CallClock"]

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass
class Measurement:
    """One measured region: summed events + the time of each counted call."""

    region: str
    events: EventCounts
    chip: hwinfo.ChipSpec
    num_devices: int
    calls: int = 1
    wall_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def mean_time(self) -> Optional[float]:
        return (sum(self.wall_times) / len(self.wall_times)
                if self.wall_times else None)

    @property
    def time_s(self) -> Optional[float]:
        """Summed time of the counted calls: the base of every rate."""
        return sum(self.wall_times) if self.wall_times else None

    def report(self, group_names: Sequence[str] = ("ROOFLINE",)) -> str:
        hdr = (f"Region: {self.region}   (calls={self.calls}, "
               f"devices={self.num_devices}, chip={self.chip.name}"
               + (f", mean time={self.mean_time*1e3:.4f} ms"
                  if self.wall_times else "")
               + ")")
        parts = [hdr, "-" * len(hdr)]
        for gn in group_names:
            g = get_group(gn)
            parts.append(g.table(self.events, self.chip, self.time_s,
                                 label=self.region))
        return "\n".join(parts)

    def accumulate(self, other: "Measurement") -> None:
        """Paper semantics: results accumulate across calls to the same region."""
        for k, v in other.events.counts.items():
            self.events.counts[k] = self.events.counts.get(k, 0.0) + v
        self.calls += other.calls
        self.wall_times.extend(other.wall_times)


class CallClock:
    """Per-call timing: CUDA events on the card, ``perf_counter`` on the
    CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self._pairs: List[Any] = []

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def call(self):
        if self.cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            try:
                yield
            finally:
                e.record()
                self._pairs.append((s, e))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._pairs.append(time.perf_counter() - t0)

    def seconds(self) -> List[float]:
        """The timed calls' seconds (synchronizes the card once)."""
        self.sync()
        if self.cuda:
            return [s.elapsed_time(e) / 1e3 for s, e in self._pairs]
        return list(self._pairs)


def measure(fn: Callable, *args, region: str = "program",
            chip: Optional[hwinfo.ChipSpec] = None, device: Device = None,
            warmup: int = 1, repeats: int = 10, **kwargs) -> Measurement:
    """Wrapper mode: run ``fn(*args, **kwargs)`` ``warmup`` times untimed
    and uncounted, then ``repeats`` times, each timed between CUDA events
    (``perf_counter`` on the CPU), collecting the declared events of every
    launch inside.  ``HBM_PEAK_BYTES`` is ``torch.cuda.max_memory_allocated``
    over the timed calls (0 on the CPU).  ``device=None`` means ``cuda``."""
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    dev = resolve_device(device)
    chip = chip or hwinfo.current_chip(dev)
    clock = CallClock(dev)
    for _ in range(warmup):
        fn(*args, **kwargs)
    clock.sync()
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with events_mod.collect() as ev:
        for _ in range(repeats):
            with clock.call():
                fn(*args, **kwargs)
    times = clock.seconds()
    if clock.cuda:
        ev.counts["HBM_PEAK_BYTES"] = float(
            torch.cuda.max_memory_allocated(dev))
    return Measurement(region=region, events=ev, chip=chip, num_devices=1,
                       calls=repeats, wall_times=times)


class PerfCtr:
    """The stateful tool: named regions, accumulation, multiplexing."""

    def __init__(self, chip: Optional[hwinfo.ChipSpec] = None,
                 groups: Sequence[str] = ("ROOFLINE",),
                 device: Device = None):
        self.device = resolve_device(device)
        self.chip = chip or hwinfo.current_chip(self.device)
        self.group_names = list(groups)
        self.regions: Dict[str, Measurement] = {}

    # ------------------------------------------------------------ marker API
    @contextlib.contextmanager
    def marker(self, region: str):
        """Marker mode: tag a region; measurements inside accumulate into it.

        Usage::

            ctr = PerfCtr()
            with ctr.marker("triad"):
                ctr.probe(stream_triad, b, c)
            print(ctr.report())
        """
        token = _ActiveRegion(self, region)
        stack = _region_stack()
        stack.append(token)
        try:
            yield token
        finally:
            stack.pop()

    def probe(self, fn: Callable, *args, **kwargs) -> Measurement:
        """Measure ``fn`` (see :func:`measure`) inside the innermost active
        marker region."""
        stack = _region_stack()
        region = stack[-1].name if stack else "default"
        m = measure(fn, *args, region=region, chip=self.chip,
                    device=self.device, **kwargs)
        self._accumulate(m)
        return m

    def record(self, m: Measurement) -> None:
        """Record an externally produced Measurement into its region."""
        self._accumulate(m)

    @contextlib.contextmanager
    def region_timer(self, region: str):
        """Time one executed block into ``region`` and collect the declared
        events of the launches inside it (CUDA events on the card,
        ``perf_counter`` on the CPU).  The block counts as one call."""
        clock = CallClock(self.device)
        with events_mod.collect() as ev:
            with clock.call():
                yield
        m = Measurement(region=region, events=ev, chip=self.chip,
                        num_devices=1, calls=1, wall_times=clock.seconds())
        self._accumulate(m)

    def reset_regions(self) -> None:
        """Forget accumulated regions; keep chip and device — the paper's
        'reset counters, keep the tool'."""
        self.regions.clear()

    def _accumulate(self, m: Measurement) -> None:
        if m.region in self.regions:
            self.regions[m.region].accumulate(m)
        else:
            # own a private copy: accumulate() mutates events/wall_times in
            # place, and the caller may still hold m
            self.regions[m.region] = dataclasses.replace(
                m, events=EventCounts(counts=dict(m.events.counts)),
                wall_times=list(m.wall_times))

    # --------------------------------------------------------- multiplex mode
    def multiplex(self, step_fn: Callable[[], Any], *, groups: Sequence[str],
                  steps_per_group: int = 3, cycles: int = 1,
                  region: str = "multiplex") -> Dict[str, Dict[str, float]]:
        """Cycle groups over executed steps in static time frames.

        Runs ``step_fn`` repeatedly, attributing timed windows to each group
        round-robin — the paper's multiplexing, with the same caveat:
        *statistical*, only sensible for longer runs.  One untimed warm-up
        call runs first.  Returns {group: derived metrics}, each from the
        events of ``region`` and the window's time per step."""
        if steps_per_group < 1:
            raise ValueError(
                f"steps_per_group must be >= 1, got {steps_per_group}")
        clock = CallClock(self.device)
        step_fn()                           # untimed: builds + warm caches
        clock.sync()
        timings: Dict[str, List[float]] = {g: [] for g in groups}
        for _ in range(cycles):
            for gname in groups:
                t0 = time.perf_counter()
                for _ in range(steps_per_group):
                    step_fn()
                clock.sync()
                timings[gname].append((time.perf_counter() - t0)
                                      / steps_per_group)
        base = self.regions.get(region)
        results: Dict[str, Dict[str, float]] = {}
        for gname in groups:
            g = get_group(gname)
            t = sum(timings[gname]) / len(timings[gname])
            ev = base.events if base else EventCounts(counts={})
            results[gname] = dict(g.derive(ev, self.chip, t), wall_s=t)
        return results

    # ---------------------------------------------------------------- output
    def report(self, groups: Optional[Sequence[str]] = None) -> str:
        groups = list(groups or self.group_names)
        parts = [f"GPU type:  {self.chip.name}",
                 f"GPU clock: {self.chip.clock_hz/1e9:.2f} GHz (max boost, "
                 f"data sheet)", ""]
        for region in self.regions.values():
            parts.append(region.report(groups))
            parts.append("")
        return "\n".join(parts)


@dataclasses.dataclass
class _ActiveRegion:
    ctr: PerfCtr
    name: str


# Marker regions nest per THREAD: a process-global stack would cross-
# attribute one worker's probes to another worker's innermost marker.
_TLS = threading.local()


def _region_stack() -> List[_ActiveRegion]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack
