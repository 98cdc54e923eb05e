"""What the port's serving benches share: claims, speed bars, the card.

A **claim** is a correctness statement a bench carries over from the JAX
package (tokens equal, a pool leak-free, a bytes ratio): :func:`claim`
raises :class:`ClaimFailed` when it does not hold, as the JAX benches'
asserts do, and nothing catches it.  A **bar** is a speed statement (the
fused loop at least 3x the per-token loop): :func:`bar` records its value
and whether it was met under the summary's ``bars``, and the bench's
``main`` and the runner exit non-zero when one was missed
(:func:`missed_bars`).  Bars are never loosened or dropped.

A bench that autotunes takes its session from :func:`tune_session`: the
winners persist only in a cache root the caller named, since a record
in the default root changes the tiles of every later run in that home.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.device import resolve_device

__all__ = ["ClaimFailed", "claim", "bar", "missed_bars", "card_line",
           "setup_device", "sync", "timed", "finish", "tune_session"]


class ClaimFailed(AssertionError):
    """A bench's correctness claim does not hold."""


def claim(ok: bool, msg: str) -> None:
    """Raise :class:`ClaimFailed` with ``msg`` unless ``ok``."""
    if not ok:
        raise ClaimFailed(msg)


def bar(value: float, floor: float) -> Dict[str, object]:
    """A speed bar's record: ``value`` against ``floor`` (met when
    ``value >= floor``)."""
    return {"value": float(value), "bar": float(floor),
            "met": bool(value >= floor)}


def missed_bars(summary: Dict) -> List[str]:
    """Names of the bars a summary records as missed."""
    return [name for name, b in summary.get("bars", {}).items()
            if not b["met"]]


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or a note that
    the times are the host's."""
    if device.type != "cuda":
        return "cpu (host times)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def setup_device(name: Optional[str]) -> torch.device:
    """Resolve ``--device`` (``cuda`` unless ``cpu`` is asked for; raises
    with no GPU) and, on the card, build every kernel up front so no
    timed call pays ``nvcc``."""
    device = resolve_device(name)
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    return device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(device: torch.device, fn: Callable, reps: int = 1):
    """(last result, mean seconds a call) of ``reps`` calls, the card
    synchronized before and after."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) / reps


def finish(tag: str, csv: list, summary: Dict, args, device) -> int:
    """Print a bench's CSV block, write its ``--json`` and return its exit
    code: 1 when a bar was missed, else 0."""
    print("name,us_per_call,derived")
    for name, us, derived in csv:
        print(f"{name},{us:.2f},{derived}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"smoke": args.smoke, "device": str(device),
                       "card": card_line(device), **summary}, f, indent=1)
        print(f"[{tag}] wrote {args.json}")
    missed = missed_bars(summary)
    for name in missed:
        b = summary["bars"][name]
        print(f"[{tag}] bar missed: {name} {b['value']:.3f} < {b['bar']}")
    return 1 if missed else 0


@contextlib.contextmanager
def tune_session(cache_dir: Optional[str] = None) -> Iterator:
    """A ``ProfileSession`` for a bench's autotune.  On the root the caller
    named (``cache_dir``, else ``$REPRO_CACHE_DIR`` when set) the winners
    persist for later processes; with neither, the session works in a
    temporary root removed on exit, and the in-process tune table is
    cleared then too, so the bench changes no tile of what runs after it."""
    from repro_torch.core.session import ProfileSession
    from repro_torch.kernels import registry
    root = cache_dir or os.environ.get("REPRO_CACHE_DIR")
    if root:
        yield ProfileSession(cache_dir=root)
        return
    with tempfile.TemporaryDirectory(prefix="repro-tune-") as tmp:
        try:
            yield ProfileSession(cache_dir=tmp)
        finally:
            registry.clear_tune_table()
