"""Bandwidth map (paper §VI future plans): sweep working-set size, map the
memory hierarchy of one GPU.

Port of ``repro/core/bandwidth.py``.  The hierarchy is HBM -> L2 ->
shared memory -> registers:

* **measured mode** (:func:`measure_map`): the port's STREAM-triad kernel
  (``csrc/stream_triad.cu``, not a PyTorch elementwise op) over a
  geometric sweep of working sets from 16 KiB to 2 GiB; the repeats run
  back to back on the device (queued behind a short spin of the card, so
  the host's dispatch of each call is not timed), each between CUDA
  events, with **no L2 flush** —
  working sets that fit the 50 MB L2 stay there between launches, and
  that plateau is what the map is for.  Each point gives the median and
  the best time's bandwidth; points that live in L2 may read above the
  HBM peak, correctly.
* **modeled mode** (:func:`model_map`): one row per level from the data
  sheet, at the level's capacity on the whole card.  Only HBM has a
  data-sheet bandwidth; the others print "n/a" rather than an invented
  multiple of HBM.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import List, Optional, Union

import torch

from repro_torch.core import hwinfo
from repro_torch.core.perfctr import CallClock
from repro_torch.device import resolve_device

__all__ = ["BandwidthPoint", "measure_map", "model_map", "render_map",
           "DEFAULT_SIZES"]

#: working sets of the measured map: 16 KiB .. 2 GiB, x2 per step
DEFAULT_SIZES = [2**k for k in range(14, 32)]
# ~0.25 ms of spinning at the H100's clock: more than the host takes to
# queue one timed launch
_SPIN_CYCLES_PER_REPEAT = 500_000


@dataclasses.dataclass(frozen=True)
class BandwidthPoint:
    working_set_bytes: int
    bandwidth: float          # bytes/s (median-of-repeats; nan = no number)
    level: str                # which hierarchy level the model predicts
    measured: bool
    bandwidth_best: float = 0.0   # bytes/s from the MIN time (0.0 for
                                  # modeled points)


def _level_for(ws: int, chip: hwinfo.ChipSpec) -> str:
    """Where a streaming kernel's arrays live between launches."""
    if ws <= chip.l2_bytes:
        return "L2"
    if ws <= chip.hbm_bytes:
        return "HBM"
    return ">HBM"


def model_map(chip: hwinfo.ChipSpec) -> List[BandwidthPoint]:
    """Static data-sheet map: each level at its capacity on the card, with
    its data-sheet bandwidth or nan (printed "n/a")."""
    nan = float("nan")
    return [
        BandwidthPoint(chip.sm_count * chip.regs_per_sm * 4, nan, "REG",
                       measured=False),
        BandwidthPoint(chip.sm_count * chip.smem_per_sm, nan, "SMEM",
                       measured=False),
        BandwidthPoint(chip.l2_bytes, nan, "L2", measured=False),
        BandwidthPoint(chip.hbm_bytes, chip.hbm_bw, "HBM", measured=False),
    ]


def measure_map(sizes: Optional[List[int]] = None, *, repeats: int = 5,
                dtype=torch.float32,
                device: Optional[Union[str, torch.device]] = None,
                chip: Optional[hwinfo.ChipSpec] = None
                ) -> List[BandwidthPoint]:
    """Measured triad bandwidth over a working-set sweep.  ``device=None``
    means ``cuda``; on the CPU the wrapper runs its plain version, timed
    with ``perf_counter``."""
    from repro_torch.kernels.stream_triad import (LANES, default_block_rows,
                                                  stream_triad, triad_bytes)
    dev = resolve_device(device)
    chip = chip or hwinfo.current_chip(dev)
    esize = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for ws in sizes or DEFAULT_SIZES:
        rows = max(ws // (3 * esize) // LANES, 1)
        n = rows * LANES
        # one CTA a tile: tiles smaller than the kernel's default where
        # that gives enough CTAs to fill the card (8 per SM), so the map
        # shows the memory level and not the kernel's schedule
        block_rows = max(1, min(default_block_rows(esize),
                                rows // (8 * max(chip.sm_count, 1))))
        # distinct streams, so no backend can fold b and c into one
        b = torch.randn(n, generator=gen, device=dev).to(dtype)
        c = torch.randn(n, generator=gen, device=dev).to(dtype)
        stream_triad(b, c, block_rows=block_rows)   # warm-up: build, touch
        clock = CallClock(dev)
        clock.sync()
        if clock.cuda:
            # spin the card while the host queues the timed launches, so
            # the events time the kernels back to back on the device and
            # not the host's per-call dispatch (tens of microseconds,
            # longer than the kernel below a few MiB)
            torch.cuda._sleep(_SPIN_CYCLES_PER_REPEAT * repeats)
        for _ in range(repeats):
            with clock.call():
                stream_triad(b, c, block_rows=block_rows)
        times = clock.seconds()
        nbytes = triad_bytes(n, esize)
        out.append(BandwidthPoint(
            working_set_bytes=nbytes,
            bandwidth=nbytes / statistics.median(times),
            level=_level_for(nbytes, chip),
            measured=True,
            bandwidth_best=nbytes / min(times),
        ))
        del b, c
    return out


def render_map(points: List[BandwidthPoint], title: str = "bandwidth map",
               width: int = 50) -> str:
    """ASCII bar map, working-set size vs bandwidth ("n/a" for a point
    with no number)."""
    if not points:
        return f"{title}: (empty)"
    peak = max((p.bandwidth for p in points if not math.isnan(p.bandwidth)),
               default=1.0)
    show_best = any(p.bandwidth_best for p in points)
    lines = [title, "-" * (width + 34)]
    for p in points:
        ws = p.working_set_bytes
        unit = "B"
        for u in ("KiB", "MiB", "GiB"):
            if ws >= 1024:
                ws /= 1024
                unit = u
        if math.isnan(p.bandwidth):
            lines.append(f"{ws:8.1f} {unit:<4} {'n/a':>9} GB/s {p.level}")
            continue
        bar = "#" * max(int(width * p.bandwidth / peak), 1)
        best = (f" (best {p.bandwidth_best/1e9:8.2f})"
                if show_best and p.bandwidth_best else "")
        lines.append(f"{ws:8.1f} {unit:<4} {p.bandwidth/1e9:9.2f} GB/s"
                     f"{best} {p.level:<14} {bar}")
    return "\n".join(lines)
