"""Straggler detection on step-time statistics (fault-tolerance substrate).

Copied verbatim from ``repro/ft/straggler.py`` (pure Python); the port's
``BatchScheduler`` records every decode segment's wall time in it.

A TPU pod job runs SPMD: one slow host drags every step (the collective
waits).  The detector keeps an EMA + robust deviation (MAD-style) of step
wall-times and flags outliers; the trainer logs them, and on a real
deployment the policy layer decides between waiting, hot-sparing (see
elastic.py) or restarting the slow host.

The same class ingests *per-host* heartbeat times in the multi-host
monitor (heartbeat.py), where argmax-over-hosts attribution actually
identifies WHICH host is slow.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["StragglerVerdict", "StragglerDetector"]


@dataclasses.dataclass(frozen=True)
class StragglerVerdict:
    is_straggler: bool
    value: float
    ema: float
    deviation: float


class StragglerDetector:
    """EMA + mean-absolute-deviation outlier detector.

    Flags a step when ``t > ema + threshold * mad`` (and t > min_ratio*ema,
    guarding against flagging noise on very fast steps).  Warmup steps are
    never flagged (compile time).
    """

    def __init__(self, alpha: float = 0.2, threshold: float = 4.0,
                 warmup: int = 3, min_ratio: float = 1.5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.min_ratio = min_ratio
        self.ema: Optional[float] = None
        self.mad: Optional[float] = None
        self.count = 0
        self.flagged: List[int] = []

    def record(self, dt: float) -> StragglerVerdict:
        self.count += 1
        if self.ema is None:
            self.ema, self.mad = dt, 0.0
            return StragglerVerdict(False, dt, dt, 0.0)
        dev = abs(dt - self.ema)
        is_bad = (self.count > self.warmup
                  and self.mad is not None
                  and dt > self.ema + self.threshold * max(self.mad, 1e-9)
                  and dt > self.min_ratio * self.ema)
        if is_bad:
            self.flagged.append(self.count)
            # don't poison the statistics with the outlier — but LEAK a
            # slow update so a *sustained* regression becomes the new
            # baseline instead of being flagged forever (a real slowdown
            # after, say, a network reroute is the new normal to track)
            leak = self.alpha / 4.0
            self.ema = (1 - leak) * self.ema + leak * dt
            self.mad = (1 - leak) * (self.mad or 0.0) + leak * dev
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
            self.mad = (1 - self.alpha) * (self.mad or 0.0) + self.alpha * dev
        return StragglerVerdict(is_bad, dt, self.ema, dev)
