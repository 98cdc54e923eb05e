"""Multi-host heartbeat monitor (fault-tolerance substrate).

Each host's training loop reports (host_id, step, wall_time) after every
step — over DCN in production, in-process in tests.  The monitor detects

* **missing hosts**: no heartbeat for ``timeout_steps`` global steps
  -> the host is presumed dead -> elastic.py plans a re-mesh;
* **slow hosts**: per-host StragglerDetector, attribution by host id.

This is deliberately simple machinery (files/dicts, no RPC framework) in
the spirit of the paper: transparent, zero-dependency, inspectable.

Copied from ``repro/ft/heartbeat.py`` (pure Python); only the straggler
detector's import changes, to the port's ``repro_torch.ft.straggler``.
The port's ``BatchScheduler`` reports one heartbeat per mesh rank per
decode segment on a ``ServeMesh`` engine, every rank from values all
ranks hold alike (``repro_torch/serve/engine.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set

from repro_torch.ft.straggler import StragglerDetector

__all__ = ["Heartbeat", "HeartbeatMonitor"]


@dataclasses.dataclass(frozen=True)
class Heartbeat:
    host: int
    step: int
    wall_time: float
    timestamp: float


class HeartbeatMonitor:
    def __init__(self, num_hosts: int, timeout_steps: int = 3):
        self.num_hosts = num_hosts
        self.timeout_steps = timeout_steps
        self.latest: Dict[int, Heartbeat] = {}
        self.detectors: Dict[int, StragglerDetector] = {
            h: StragglerDetector() for h in range(num_hosts)}
        self.log: List[Heartbeat] = []

    def report(self, host: int, step: int, wall_time: float,
               timestamp: Optional[float] = None) -> None:
        hb = Heartbeat(host, step, wall_time,
                       timestamp if timestamp is not None else time.time())
        self.latest[host] = hb
        self.log.append(hb)
        self.detectors[host].record(wall_time)

    def global_step(self) -> int:
        return max((hb.step for hb in self.latest.values()), default=0)

    def missing_hosts(self) -> Set[int]:
        """Hosts more than timeout_steps behind the front-runner (or silent)."""
        front = self.global_step()
        out = set()
        for h in range(self.num_hosts):
            hb = self.latest.get(h)
            if hb is None or front - hb.step >= self.timeout_steps:
                out.add(h)
        return out

    def slow_hosts(self, ratio: float = 1.5) -> Set[int]:
        """Hosts flagged by their own step-time history (StragglerDetector)
        OR whose latest heartbeat is ``ratio``x the cross-host median —
        the argmax-over-hosts attribution that one host's history alone
        cannot provide (its first sample just seeds its EMA)."""
        out = {h for h, d in self.detectors.items() if d.flagged}
        times = sorted(hb.wall_time for hb in self.latest.values())
        if len(times) >= 3:
            median = times[len(times) // 2]
            for h, hb in self.latest.items():
                if median > 0 and hb.wall_time > ratio * median:
                    out.add(h)
        return out

    def healthy(self) -> bool:
        return not self.missing_hosts()
