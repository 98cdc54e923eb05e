"""Deterministic fault injection for the serving request plane.

Copied from ``repro/ft/chaos.py`` (pure Python); only the snapshot
store's import changes, to the port's ``repro_torch.checkpoint``.
``KINDS``, the draw order and :meth:`ChaosSchedule.smoke` are the JAX
package's, so a seed deals the same faults in both packages.  The port
serves on one card: its scheduler has no heartbeats, so
``heartbeat_flap`` and ``device_death`` take their single-device skip.

A :class:`ChaosSchedule` is a SEEDED list of :class:`ChaosEvent`s the
scheduler ticks through at every segment boundary
(``BatchScheduler(..., chaos=schedule)``).  Each event perturbs exactly
one failure surface the robustness work claims to cover:

========================  ==================================================
kind                      what it exercises
========================  ==================================================
``pool_exhaust``          seizes a fraction of the KV pool's free pages
                          (``KVPool.seize``) for ``duration`` segments —
                          admission backpressure, bounded-bypass blocking,
                          and the scheduler's seized-pool relief path
``slow_segment``          inflates the next segment's OBSERVED wall clock
                          by ``magnitude`` (no real sleep) — the straggler
                          detector's warning path
``hung_segment``          a pathological ``slow_segment`` (default 50x) —
                          the detector must flag it on every engine,
                          single-device included
``heartbeat_flap``        one device misses exactly ONE heartbeat — the
                          remesh governor's confirm window must absorb it
                          (a flap is NOT a death)
``device_death``          stops a device's heartbeats for good via
                          ``inject_failure`` — detection, confirmation,
                          re-mesh, degraded continue (mesh engines only;
                          recorded as skipped on single-device)
``snapshot_corrupt``      flips bytes in the newest on-disk serving
                          snapshot and asserts the loader REFUSES it
                          (:class:`repro_torch.checkpoint.SnapshotCorrupt`) —
                          corruption is detected, never restored
``cancel_request``        fires an in-flight request's cancellation token
                          (preferring a speculative row of a mixed batch,
                          mid-verify) — the retire path must release the
                          slot AND its draft-namespace pages, with no
                          token past the flag ever returned
``expire_request``        forces an in-flight request's deadline into the
                          past (same spec-row preference) — the expiry
                          path under speculative decoding
========================  ==================================================

After applying each event — and again at the end of every tick — the
harness runs the full invariant closure: ``KVPool.check()`` plus
``BatchScheduler.check()`` (state-disjointness, budget bounds, page
ownership).  A chaos run that finishes is therefore a proof that every
injected fault left the request plane consistent, not just alive.

Every applied event lands in ``sched.ft_events`` as
``{"type": "chaos", "kind": ..., "segment": ...}`` so BENCH artifacts
and the CI chaos-smoke job can assert the schedule actually ran.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, List, Optional, Tuple

__all__ = ["ChaosEvent", "ChaosSchedule", "KINDS", "ALL_KINDS"]

# KINDS is frozen: the seeded default schedule draws from it with
# rng.choice, so appending here would silently re-deal every historical
# seed.  New kinds join ALL_KINDS (valid in explicit schedules and in a
# ``kinds=`` override) instead.
KINDS = ("pool_exhaust", "slow_segment", "hung_segment", "heartbeat_flap",
         "device_death", "snapshot_corrupt")
ALL_KINDS = KINDS + ("cancel_request", "expire_request")


@dataclasses.dataclass
class ChaosEvent:
    """One scheduled fault: fires at the tick where ``segment`` segments
    have completed.  ``magnitude`` scales the fault (pool fraction, wall
    multiplier); ``duration`` is in segments where the fault persists
    (pool_exhaust); ``device`` targets flaps/deaths.  ``applied``/``note``
    are filled by the harness."""

    segment: int
    kind: str
    magnitude: float = 1.0
    duration: int = 1
    device: int = 0
    applied: bool = False
    note: str = ""


class ChaosSchedule:
    """A seeded, replayable fault schedule.

    ``ChaosSchedule(seed=N)`` draws a random mix of events over
    ``horizon`` segments from ``random.Random(seed)`` — the SAME seed
    always produces the SAME faults at the same boundaries, so a chaos
    failure reproduces from its seed alone.  Pass ``events`` explicitly
    to script a schedule by hand (the tests do), or use
    :meth:`smoke` for the fixed schedule the CI job runs.
    """

    def __init__(self, seed: int = 0,
                 events: Optional[List[ChaosEvent]] = None,
                 horizon: int = 24, rate: float = 0.35,
                 kinds: Tuple[str, ...] = KINDS):
        for k in kinds:
            if k not in ALL_KINDS:
                raise ValueError(f"unknown chaos kind {k!r}; "
                                 f"choose from {ALL_KINDS}")
        self.seed = int(seed)
        if events is None:
            rng = random.Random(self.seed)
            events = []
            for seg in range(1, horizon + 1):
                if rng.random() >= rate:
                    continue
                kind = rng.choice(list(kinds))
                events.append(ChaosEvent(
                    segment=seg, kind=kind,
                    magnitude=(rng.uniform(0.3, 0.9)
                               if kind == "pool_exhaust"
                               else 50.0 if kind == "hung_segment"
                               else rng.uniform(5.0, 12.0)),
                    duration=rng.randint(1, 3),
                    device=rng.randint(0, 7)))
        self.events = list(events)
        self.checks = 0            # invariant closures run
        self.skipped: List[str] = []
        # (release_segment, pages) for pool seizures still in force
        self._pending_release: List[Tuple[int, int]] = []

    @classmethod
    def smoke(cls) -> "ChaosSchedule":
        """The fixed schedule ``bench_chaos --smoke`` / CI runs: one of
        each fault kind at known boundaries, small enough to finish in
        seconds yet covering every injection path."""
        return cls(seed=0, events=[
            ChaosEvent(segment=1, kind="slow_segment", magnitude=8.0),
            ChaosEvent(segment=2, kind="pool_exhaust", magnitude=0.6,
                       duration=2),
            ChaosEvent(segment=3, kind="hung_segment", magnitude=50.0),
            ChaosEvent(segment=4, kind="heartbeat_flap", device=1),
            ChaosEvent(segment=5, kind="snapshot_corrupt"),
            ChaosEvent(segment=6, kind="device_death", device=1),
        ])

    # ----------------------------------------------------------- injection
    def tick(self, sched, segment: int) -> List[ChaosEvent]:
        """Apply every event due at ``segment`` (called by the scheduler
        after each decode segment), then verify invariants.  Returns the
        events applied this tick."""
        fired: List[ChaosEvent] = []
        for rel_seg, pages in list(self._pending_release):
            if segment >= rel_seg and sched.pool is not None:
                sched.pool.unseize()
                self._pending_release.remove((rel_seg, pages))
                sched.ft_events.append(dict(
                    type="chaos", kind="pool_release", segment=segment,
                    pages=pages))
        for ev in self.events:
            if ev.applied or ev.segment > segment:
                continue
            self._apply(sched, ev, segment)
            ev.applied = True
            fired.append(ev)
            sched.ft_events.append(dict(
                type="chaos", kind=ev.kind, segment=segment,
                magnitude=ev.magnitude, device=ev.device,
                note=ev.note))
            self.verify(sched)
        self.verify(sched)
        return fired

    def _apply(self, sched, ev: ChaosEvent, segment: int) -> None:
        if ev.kind == "pool_exhaust":
            if sched.pool is None:
                ev.note = "skipped: dense engine (no pool)"
                self.skipped.append(ev.kind)
                return
            want = max(1, int(len(sched.pool.free) * ev.magnitude))
            got = sched.pool.seize(want)
            ev.note = f"seized {got} pages for {ev.duration} segments"
            self._pending_release.append((segment + ev.duration, got))
        elif ev.kind in ("slow_segment", "hung_segment"):
            sched._wall_inflate = max(float(ev.magnitude), 1.0)
            ev.note = f"next segment wall x{ev.magnitude:g}"
        elif ev.kind == "heartbeat_flap":
            if sched.heartbeats is None:
                ev.note = "skipped: no heartbeats (single-device engine)"
                self.skipped.append(ev.kind)
                return
            dev = sched._hb_ids[ev.device % len(sched._hb_ids)]
            sched._flap.add(dev)
            ev.note = f"device {dev} misses one heartbeat"
        elif ev.kind == "device_death":
            if sched.heartbeats is None:
                ev.note = "skipped: no heartbeats (single-device engine)"
                self.skipped.append(ev.kind)
                return
            alive = [d for d in sched._hb_ids if d not in sched._dead]
            if len(alive) < 2:
                ev.note = "skipped: would kill the last device"
                self.skipped.append(ev.kind)
                return
            # never kill device index 0 (the coordinator in real meshes)
            dev = alive[1 + ev.device % (len(alive) - 1)]
            sched.inject_failure(dev, at_segment=segment)
            ev.note = f"device {dev} heartbeats stop"
        elif ev.kind == "snapshot_corrupt":
            ev.note = self._corrupt_snapshot(sched)
        elif ev.kind in ("cancel_request", "expire_request"):
            # lifecycle faults against a RESIDENT request, preferring a
            # speculative row so mixed-batch chaos exercises the draft
            # namespace teardown (pages in two pool slots, mid-verify)
            live = [r for r in sched._slots if r is not None]
            pick_from = [r for r in live if r.spec] or live
            if not pick_from:
                ev.note = "skipped: no request in flight"
                self.skipped.append(ev.kind)
                return
            req = pick_from[ev.device % len(pick_from)]
            row = "spec row" if req.spec else "plain row"
            if ev.kind == "cancel_request":
                req.cancel()
                ev.note = f"rid {req.rid} cancelled in flight ({row})"
            else:
                req.deadline_ms = 0.0
                ev.note = f"rid {req.rid} deadline forced past ({row})"
        else:                                           # pragma: no cover
            raise ValueError(f"unknown chaos kind {ev.kind!r}")

    def _corrupt_snapshot(self, sched) -> str:
        """Flip bytes in the newest snapshot and PROVE the loader refuses
        it.  The damaged file is left with a ``.corrupt`` suffix so the
        restore path never sees it as a candidate."""
        from repro_torch.checkpoint import store
        if not sched.snapshot_dir:
            self.skipped.append("snapshot_corrupt")
            return "skipped: no snapshot_dir"
        path = store.latest_snapshot(sched.snapshot_dir)
        if path is None:
            self.skipped.append("snapshot_corrupt")
            return "skipped: no snapshot on disk yet"
        with open(path, "rb") as f:
            blob = bytearray(f.read())
        mid = len(blob) // 2
        for off in range(mid, min(mid + 8, len(blob))):
            blob[off] ^= 0xFF
        with open(path, "wb") as f:
            f.write(blob)
        try:
            store.load_serving_snapshot(path)
        except store.SnapshotCorrupt:
            pass
        else:
            raise AssertionError(
                f"corrupted snapshot {path} loaded without error — "
                f"CRC validation is broken")
        os.replace(path, path + ".corrupt")
        return f"corrupted + detected: {os.path.basename(path)}"

    # ---------------------------------------------------------- invariants
    def verify(self, sched) -> None:
        """The invariant closure after every injected event."""
        self.checks += 1
        sched.check()

    def summary(self) -> Dict[str, object]:
        applied = [e for e in self.events if e.applied]
        return dict(seed=self.seed,
                    events=len(self.events), applied=len(applied),
                    by_kind={k: sum(1 for e in applied if e.kind == k)
                             for k in ALL_KINDS
                             if any(e.kind == k for e in applied)},
                    skipped=list(self.skipped), checks=self.checks)
