"""Bounded admission for the serving request plane.

Copied verbatim from ``repro/serve/admission.py`` (pure Python; the port
never imports the JAX package).

Before this module the scheduler's queue was an unbounded FIFO deque:
overload deferred silently and forever, a large request stuck behind
``can_reserve`` could be starved by an endless stream of smaller later
arrivals, and a rejected caller had no signal about when (or whether) to
retry.  :class:`AdmissionQueue` fixes all three:

* **Priority classes** — requests carry an integer priority (lower is
  more urgent; 0 = interactive, 1 = default, 2 = batch/background).
  Dequeue order is (priority, arrival), so within a class the queue is
  strictly FIFO — the order the scheduler's admission log asserts.
* **Bounded depth + load shedding** — ``max_queue`` caps the queue.  At
  capacity, ``shed_policy`` decides in O(1): ``"reject-new"`` refuses
  the arriving request; ``"shed-lowest"`` evicts the *newest request of
  the strictly worst priority class* (least sunk cost, least urgent) to
  make room for a more urgent arrival — an arrival no more urgent than
  the worst resident class is itself refused.  Either way the refused
  party gets a structured :class:`Rejection` (retryable, with a
  suggested backoff derived from observed service rate) wrapped in
  :class:`AdmissionRejected` — never an unbounded defer.
* **Bounded bypass** — when the head-of-line request cannot reserve its
  worst-case pages, the scheduler may admit smaller later requests past
  it, but only ``max_bypass`` times per head: after that the queue
  BLOCKS until the head fits (pages drain toward it), so a large
  request is delayed at most K admissions, never starved.
* **Drain** — :meth:`close` stops admission (rejections carry
  ``reason="draining"``, not retryable here — the process is going
  away); already-queued work is unaffected.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Deque, Dict, Iterator, List, Optional

__all__ = ["AdmissionQueue", "AdmissionRejected", "Rejection",
           "SHED_POLICIES"]

SHED_POLICIES = ("reject-new", "shed-lowest")


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Structured admission refusal — the caller can act on it.

    ``retryable`` distinguishes transient overload (back off and retry
    after ``retry_after_s``) from terminal refusals (the scheduler is
    draining); ``queue_depth`` is the depth observed at refusal time so
    clients can do their own load-aware routing."""

    rid: int
    reason: str                  # "queue_full" | "shed" | "draining"
    retryable: bool = True
    retry_after_s: float = 0.1
    priority: int = 1
    queue_depth: int = 0


class AdmissionRejected(RuntimeError):
    """Raised by submit/push when a request is refused admission."""

    def __init__(self, rejection: Rejection):
        self.rejection = rejection
        hint = (f"; retry after {rejection.retry_after_s:.2f}s"
                if rejection.retryable else "; not retryable")
        super().__init__(
            f"request {rejection.rid} rejected ({rejection.reason}, "
            f"depth={rejection.queue_depth}){hint}")


class AdmissionQueue:
    """Priority-FIFO admission queue with a bounded depth and bounded
    head-of-line bypass.

    All mutating operations are O(number of priority classes) or better
    — the rejection path never scans the queue, which is what makes the
    overload behavior O(1) per arrival."""

    def __init__(self, max_queue: Optional[int] = None,
                 shed_policy: str = "reject-new", max_bypass: int = 4):
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed_policy {shed_policy!r}; "
                             f"choose from {SHED_POLICIES}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.max_bypass = int(max_bypass)
        self.closed = False
        self._classes: Dict[int, Deque] = {}
        self._seq = itertools.count()
        self._order: Dict[int, int] = {}     # rid -> arrival seq
        # bounded-bypass bookkeeping: how many times the CURRENT head has
        # been bypassed by later arrivals (reset whenever the head changes)
        self._bypass_rid: Optional[int] = None
        self._bypass_count = 0
        # EMA of per-request service time, fed by the scheduler at retire
        # time; the backoff hint scales with it and the observed depth
        self._service_ema_s: Optional[float] = None

    # -------------------------------------------------------------- queries
    def __len__(self) -> int:
        return sum(len(d) for d in self._classes.values())

    def __bool__(self) -> bool:
        return any(self._classes.values())

    def ordered(self) -> Iterator:
        """Requests in dequeue order: (priority, arrival)."""
        for prio in sorted(self._classes):
            yield from self._classes[prio]

    def head(self):
        """The request the queue would serve next, or None."""
        for prio in sorted(self._classes):
            if self._classes[prio]:
                return self._classes[prio][0]
        return None

    def retry_after_s(self) -> float:
        """Suggested backoff: queue depth x observed service time (with a
        floor so a cold queue still suggests a real pause)."""
        per = self._service_ema_s if self._service_ema_s else 0.05
        return max(0.05, per * (len(self) + 1))

    def note_service_time(self, seconds: float) -> None:
        """Feed one completed request's wall time into the backoff EMA."""
        if self._service_ema_s is None:
            self._service_ema_s = float(seconds)
        else:
            self._service_ema_s += 0.2 * (float(seconds)
                                          - self._service_ema_s)

    # ------------------------------------------------------------ mutation
    def _reject(self, req, reason: str, retryable: bool = True) -> None:
        raise AdmissionRejected(Rejection(
            rid=req.rid, reason=reason, retryable=retryable,
            retry_after_s=self.retry_after_s() if retryable else 0.0,
            priority=getattr(req, "priority", 1), queue_depth=len(self)))

    def _enqueue(self, req, seq: int) -> None:
        prio = int(getattr(req, "priority", 1))
        self._classes.setdefault(prio, collections.deque()).append(req)
        self._order[req.rid] = seq

    def push(self, req):
        """Admit ``req`` (or shed/refuse in O(1)).

        Returns the shed victim (a request previously queued, now
        evicted under ``shed-lowest``) or None; raises
        :class:`AdmissionRejected` when ``req`` itself is refused."""
        if self.closed:
            self._reject(req, "draining", retryable=False)
        victim = None
        if self.max_queue is not None and len(self) >= self.max_queue:
            if self.shed_policy == "reject-new":
                self._reject(req, "queue_full")
            worst = max((p for p, d in self._classes.items() if d),
                        default=None)
            if worst is None or worst <= int(getattr(req, "priority", 1)):
                # nothing strictly less urgent to shed -> refuse arrival
                self._reject(req, "queue_full")
            victim = self._classes[worst].pop()     # newest of worst class
            self._order.pop(victim.rid, None)
            if self._bypass_rid == victim.rid:
                self._bypass_rid, self._bypass_count = None, 0
        self._enqueue(req, next(self._seq))
        return victim

    def push_front(self, req) -> None:
        """Re-queue ahead of every same-priority request (resume/restore
        path: the request was already admitted once).  Never bounded —
        refusing previously-admitted work would lose it."""
        prio = int(getattr(req, "priority", 1))
        self._classes.setdefault(prio, collections.deque()).appendleft(req)
        # arrival seq below every existing one of this class
        floor = min((self._order[r.rid] for r in self._classes[prio]
                     if r.rid in self._order), default=0)
        self._order[req.rid] = floor - 1

    def remove(self, req) -> bool:
        """Drop a queued request (cancel/expiry sweep).  True if found."""
        for d in self._classes.values():
            try:
                d.remove(req)
            except ValueError:
                continue
            self._order.pop(req.rid, None)
            if self._bypass_rid == req.rid:
                self._bypass_rid, self._bypass_count = None, 0
            return True
        return False

    def close(self) -> None:
        """Stop admission (drain): future pushes are refused."""
        self.closed = True

    # ------------------------------------------------- bounded head bypass
    def bypasses(self, head) -> int:
        """Times the current head has been bypassed (0 on head change)."""
        if self._bypass_rid != head.rid:
            return 0
        return self._bypass_count

    def note_bypass(self, head) -> int:
        """Record one bypass of ``head`` by a later arrival."""
        if self._bypass_rid != head.rid:
            self._bypass_rid, self._bypass_count = head.rid, 0
        self._bypass_count += 1
        return self._bypass_count
