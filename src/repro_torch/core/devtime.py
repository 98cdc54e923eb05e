"""Device-only time of a call on the card, read from ``torch.profiler``.

The one reader behind ``bench/profile_kernels.py``'s ``device_us`` rows and
:meth:`repro_torch.core.session.ProfileSession.measure`: run the call
``n`` times under the profiler, optionally zeroing a flush buffer larger
than L2 before each, and sum the device time of every CUDA kernel the
calls launched, the flush's fill kernel left out.  Host enqueue, launch
gaps and the profiler's own host work are not in the sum, which is what
separates it from a CUDA-event timer around the call.

On the H100 machine a profiler session late in a long process reports
fewer kernels than ran, and at last none (activity records never
arrive).  The reader checks the records against the calls: ``n``
identical calls launch every kernel of a call ``n`` times, so each
kernel name's count must be a multiple of ``n``; the fills (the
flushes' and the call's own) too, and at least ``n`` of them; and the
calls must show at least the ``launches`` a call declares (its event
collection's ``LAUNCHES``) — a partial drop fails one of these.  Short
of any, it times the same calls between CUDA events instead (the flush
outside each pair), which adds a call's host enqueue where it outlasts
the flush; the second value returned names the timer that was used.
A caller that compares several calls' times (a tune sweep) must compare
them under one timer: ``ProfileSession.measure(timer="events")``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = ["device_time_us", "device_us_per_call", "event_us_per_call",
           "flush_buffer", "FLUSH_BYTES"]

#: bytes zeroed before a flushed call: more than an H100's 50 MB L2
FLUSH_BYTES = 64 << 20


def device_time_us(avg) -> float:
    """The self device time (us) of one ``key_averages()`` entry, under the
    attribute name this torch version gives it."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, attr):
            return float(getattr(avg, attr))
    raise AttributeError("profiler averages carry no device time")


def flush_buffer(device: torch.device) -> torch.Tensor:
    """A :data:`FLUSH_BYTES` buffer on ``device`` whose ``zero_()`` evicts
    L2."""
    return torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)


def event_us_per_call(fn: Callable[[], object], n: int = 100,
                      flush: Optional[torch.Tensor] = None) -> float:
    """Microseconds a call of ``fn`` takes between two CUDA events, the
    mean over ``n`` calls (``flush.zero_()`` before each, outside the
    pair, when given)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) * 1e3 / n


def device_us_per_call(fn: Callable[[], object], n: int = 100,
                       flush: Optional[torch.Tensor] = None,
                       launches: int = 1) -> Tuple[float, str]:
    """``(us, timer)``: device microseconds a call of ``fn`` takes — one
    untimed call, then ``n`` calls under ``torch.profiler``
    (``flush.zero_()`` before each when given), the device time of every
    CUDA kernel they launched summed, the flush's fill kernel left out,
    over ``n`` — and ``"profiler"``; or, when the records do not add up
    to ``n`` whole calls (a kernel name, or the fills, counted other than
    a multiple of ``n``; fewer than ``n`` fills under a flush; fewer than
    ``n * launches`` kernels), :func:`event_us_per_call` and
    ``"events"``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    fills = sum(a.count for a in kernels if "Fill" in a.key)
    rest = [a for a in kernels if "Fill" not in a.key]
    whole = (all(a.count % n == 0 for a in rest) and fills % n == 0
             and sum(a.count for a in rest) >= n * max(1, launches)
             and (flush is None or fills >= n))
    if whole:
        return sum(device_time_us(a) for a in rest) / n, "profiler"
    return event_us_per_call(fn, n, flush), "events"
