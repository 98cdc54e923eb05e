"""ProfileSession: stateful, cache-backed measurement (likwid marker runs).

Port of ``repro/core/session.py``.  LIKWID's performance-engineering
workflow is *repeated structured measurement*: run the same regions over
and over while turning knobs, and let the tool keep the bookkeeping cheap.
The JAX session caches a compile (the events are read from the lowered
program, which never runs).  The port has no compile artifact: a kernel's
cost on the card is what it does when it runs.  So :meth:`measure` runs
the probe and caches the run:

* on a miss it calls ``fn(*args)`` once untimed (the first call of a
  kernel includes its ``nvcc`` build), once inside an event collection
  (the declared FLOPs and bytes of every launch inside,
  :mod:`repro_torch.core.events`), and, on the card, ``calls`` more times
  under ``torch.profiler`` with L2 flushed before each: the launched
  kernels' own device seconds a call (:func:`repro_torch.core.devtime.
  device_us_per_call`, the reader ``bench/profile_kernels.py`` uses;
  where a profiler session drops kernel records, CUDA events around each
  call, counted in ``session.event_timed``; ``timer="events"`` asks for
  the events outright, so that a sweep compares its candidates under one
  timer; the timer asked for is part of the cache key, the one used is
  in the entry and on the ``Measurement``);
* the result is stored under a digest of (function fingerprint, argument
  shapes / dtypes / strides / device, chip, toolchain), so a repeated
  probe, in this process or a later one, is a disk lookup that times
  nothing;
* ``session.lowerings`` keeps the reference's name, and counts what
  the port does in place of a lower+compile: probes the cache did not
  serve (each one executed, and timed on the card).  "The second run
  lowered nothing" reads here as "the second run timed nothing".

Usage::

    from repro_torch.core.session import ProfileSession
    sess = ProfileSession(cache_dir=".cache")        # or $REPRO_CACHE_DIR
    m = sess.measure(fn, x, region="attn")           # cold: runs and times
    m = sess.measure(fn, x, region="attn")           # warm: disk lookup
    print(m.device_s, m.events["BYTES_ACCESSED"], sess.stats())

Key caveat (documented, deliberate): the key covers the arguments'
shapes, dtypes, strides and device, never their values.  A probe whose
work depends on the data (a paged decode's lengths) must build its
inputs from a seed, as the registry's tune probes do, or the cached time
belongs to other data.  The function fingerprint hashes the source text
plus a bounded repr of closure cells, as the reference's does.

:meth:`sweep` keeps the reference's signature: its default cell is the
dry run of an (arch, shape) cell (:func:`repro_torch.launch.dryrun.
run_cell`, a shape-and-count walk of one rank on the ``meta`` device),
each record stored whole under :meth:`cell_digest`, so a warm sweep
walks nothing.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import inspect
import os
import textwrap
import threading
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import devtime, events, hwinfo
from repro_torch.core.artifact_cache import ArtifactCache, canonical_digest
from repro_torch.core.events import EventCounts
from repro_torch.core.perfctr import Measurement

__all__ = ["ProfileSession", "fingerprint_callable", "describe_abstract"]


# ---------------------------------------------------------------------------
# key material
# ---------------------------------------------------------------------------

def _fingerprint_value(v: Any) -> str:
    """Bounded, cross-process-stable description of one bound value."""
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return f"array[{tuple(v.shape)},{v.dtype}]"
    if isinstance(v, functools.partial) or callable(v):
        return fingerprint_callable(v)
    return repr(v)[:200]


def fingerprint_callable(fn: Callable) -> str:
    """Stable content fingerprint of a Python callable.

    Source text (dedented, hashed) + qualified name + bounded closure-cell
    reprs.  ``functools.partial`` unwraps into (inner fingerprint, bound
    args, bound keywords): ``inspect.getsource`` raises on a partial, and
    ``repr(fn)`` embeds a memory address, so partial-wrapped probes (the
    tune candidates) would never hit the cache across processes.  Falls
    back to ``repr(fn)`` when source is unavailable (C builtins, REPL
    lambdas) — unstable across processes but never a false hit.
    """
    if isinstance(fn, functools.partial):
        inner = fingerprint_callable(fn.func)
        args = ",".join(_fingerprint_value(a) for a in fn.args)
        kws = ",".join(f"{k}={_fingerprint_value(v)}"
                       for k, v in sorted((fn.keywords or {}).items()))
        return f"partial({inner})({args})({kws})"
    base = f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', '?')}"
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return f"{base}:{repr(fn)}"
    h = hashlib.sha256(src.encode("utf-8")).hexdigest()[:16]
    closure = getattr(fn, "__closure__", None) or ()
    cells = []
    for cell in closure:
        try:
            v = cell.cell_contents
        except ValueError:          # empty cell
            cells.append("<empty>")
            continue
        cells.append(_fingerprint_value(v))
    return f"{base}:{h}:[{','.join(cells)}]"


def _leaf_desc(x: Any) -> Dict[str, Any]:
    if isinstance(x, torch.Tensor):
        return {"shape": list(x.shape), "dtype": str(x.dtype),
                "stride": list(x.stride()), "device": x.device.type}
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return {"shape": list(x.shape), "dtype": str(x.dtype)}
    return {"py": repr(x)[:200]}


def _flatten(tree: Any, leaves: List[Any]) -> str:
    """The structure of a tree of tuples, lists and dicts as a string,
    its leaves appended to ``leaves`` in order (no JAX tree utilities in
    the port)."""
    if isinstance(tree, (tuple, list)):
        inner = ",".join(_flatten(t, leaves) for t in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{_flatten(tree[k], leaves)}"
                              for k in sorted(tree, key=repr)) + "}"
    leaves.append(tree)
    return "*"


def describe_abstract(tree: Any) -> Dict[str, Any]:
    """Shapes / dtypes / strides / devices of a tree of tensors."""
    leaves: List[Any] = []
    treedef = _flatten(tree, leaves)
    return {"treedef": treedef, "leaves": [_leaf_desc(x) for x in leaves]}


@functools.lru_cache(maxsize=1)
def _repo_fingerprint() -> str:
    """Content hash of every ``.py``, ``.cu`` and ``.cuh`` file under
    ``src/repro_torch``.

    Probed functions call into model and kernel code whose source is NOT
    part of the per-function fingerprint, and a kernel's time is its CUDA
    source's; keying on the whole package means any edit (a kernel's
    included) invalidates, conservatively, instead of serving times of
    old code.
    """
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(pkg_root)):
        dirnames.sort()
        for name in sorted(filenames):
            if not name.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(dirpath, name)
            h.update(os.path.relpath(path, pkg_root).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def _backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


@functools.lru_cache(maxsize=1)
def _toolchain() -> Dict[str, str]:
    """What a measurement's validity rests on: the torch and CUDA
    versions, the card, the ``nvcc`` the kernels build with, the backend
    and the port's source digest.  Computed once a process."""
    from repro_torch.kernels import _build
    backend = _backend()
    return {"torch": torch.__version__,
            "cuda": str(torch.version.cuda),
            "device": (torch.cuda.get_device_name(0) if backend == "cuda"
                       else "cpu"),
            "nvcc": _build.nvcc_version() if backend == "cuda" else "none",
            "backend": backend,
            "repro_src": _repo_fingerprint()}


def _device_of(tree: Any) -> torch.device:
    leaves: List[Any] = []
    _flatten(tree, leaves)
    for x in leaves:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

class ProfileSession:
    """A measurement session backed by the artifact cache.

    ``calls``: the profiled calls a measurement on the card averages over
    (each after an L2 flush)."""

    def __init__(self, cache_dir: Optional[str] = None,
                 chip: Optional[hwinfo.ChipSpec] = None,
                 cache: Optional[ArtifactCache] = None,
                 enabled: bool = True, calls: int = 10):
        self.cache = cache or ArtifactCache(cache_dir, enabled=enabled)
        self.chip = chip
        self.calls = calls
        self.lowerings = 0           # probes the cache did not serve
        self.event_timed = 0         # ... of them timed by CUDA events
        self._lock = threading.Lock()
        self._key_locks: Dict[str, threading.Lock] = {}
        self._flush: Dict[torch.device, torch.Tensor] = {}

    def chip_for(self, device: torch.device) -> hwinfo.ChipSpec:
        """The session's chip, else the data sheet of ``device``."""
        return self.chip or hwinfo.current_chip(device)

    # --------------------------------------------------------------- keys
    def measure_digest(self, fn: Callable, args: Tuple, kwargs: Dict,
                       chip: hwinfo.ChipSpec, timer: str = "auto"
                       ) -> Tuple[str, Dict[str, Any]]:
        material = {
            "kind": "measure",
            "fn": fingerprint_callable(fn),
            "args": describe_abstract(args),
            "kwargs": describe_abstract(kwargs),
            "calls": self.calls,
            "timer": timer,
            "chip": chip.name,
            "toolchain": _toolchain(),
        }
        return canonical_digest(material), material

    def cell_digest(self, **cell_material) -> Tuple[str, Dict[str, Any]]:
        """Digest for a whole dry-run cell record
        (:func:`repro_torch.launch.dryrun.run_cell`)."""
        material = {"kind": "dryrun-cell",
                    "chip": (self.chip or hwinfo.H100_SXM).name,
                    "toolchain": _toolchain(), **cell_material}
        return canonical_digest(material), material

    @contextlib.contextmanager
    def _locked(self, digest: str):
        """Per-key lock: concurrent sweep workers never time the same
        program twice — the second waits, then hits the cache."""
        with self._lock:
            lk = self._key_locks.setdefault(digest, threading.Lock())
        with lk:
            yield

    def note_lowering(self) -> None:
        with self._lock:
            self.lowerings += 1

    def _flush_for(self, device: torch.device) -> torch.Tensor:
        with self._lock:
            buf = self._flush.get(device)
            if buf is None:
                buf = self._flush[device] = devtime.flush_buffer(device)
        return buf

    # ------------------------------------------------------------ measure
    def measure(self, fn: Callable, *args, region: str = "program",
                chip: Optional[hwinfo.ChipSpec] = None,
                timer: str = "auto", **kwargs) -> Measurement:
        """Run ``fn(*args, **kwargs)`` on the args' device and return its
        Measurement: the declared events of one call, and on the card its
        device seconds a call (``device_s``) and the timer that read them
        (``timer``: ``"auto"`` takes the profiler's kernel records and
        falls back to CUDA events where they do not add up, ``"events"``
        takes the events).  A repeated probe is a disk lookup and runs
        nothing."""
        if timer not in ("auto", "events"):
            raise ValueError(f"timer is 'auto' or 'events', not {timer!r}")
        dev = _device_of((args, kwargs))
        chip = chip or self.chip_for(dev)
        digest, material = self.measure_digest(fn, args, kwargs, chip,
                                               timer)
        with self._locked(digest):
            entry = self.cache.get(digest)
            if entry is not None:
                try:
                    ev = EventCounts.from_dict(entry["events"])
                    dev_s = entry.get("device_s")
                    dev_s = None if dev_s is None else float(dev_s)
                    used = entry.get("timer")
                except (KeyError, TypeError, ValueError, AttributeError):
                    # schema-valid JSON, garbage content: re-measure
                    self.cache.quarantine(digest)
                else:
                    return Measurement(region=region, events=ev, chip=chip,
                                       num_devices=1, device_s=dev_s,
                                       timer=used)
            fn(*args, **kwargs)                 # builds, warms up
            with events.collect() as ev:
                fn(*args, **kwargs)
            dev_s = used = None
            if dev.type == "cuda":
                call = functools.partial(fn, *args, **kwargs)
                flush = self._flush_for(dev)
                if timer == "events":
                    us, used = devtime.event_us_per_call(
                        call, self.calls, flush), "events"
                else:
                    us, used = devtime.device_us_per_call(
                        call, n=self.calls, flush=flush,
                        launches=int(ev["LAUNCHES"]))
                dev_s = us * 1e-6
                if used != "profiler":
                    with self._lock:
                        self.event_timed += 1
            self.note_lowering()
            self.cache.put(digest, {"kind": "measure",
                                    "events": ev.to_dict(),
                                    "device_s": dev_s, "timer": used,
                                    "key": material})
        return Measurement(region=region, events=ev, chip=chip,
                           num_devices=1, device_s=dev_s, timer=used)

    # alias matching PerfCtr vocabulary
    probe = measure

    # -------------------------------------------------------------- sweep
    def sweep(self, archs: Sequence[str], shapes: Sequence[str],
              groups: Sequence[str] = ("ROOFLINE",), parallel: int = 4,
              multi_pod: bool = False,
              cell_fn: Optional[Callable[[str, str], Dict]] = None,
              out_dir: Optional[str] = None) -> List[Dict]:
        """Batched measurement: every (arch x shape) cell through a thread
        pool sharing this session's cache.

        ``cell_fn(arch, shape) -> record`` defaults to
        :func:`repro_torch.launch.dryrun.run_cell` with this session
        attached (record caching included); tests and custom drivers can
        supply their own.  Per-group derived metrics are attached to each
        ``ok`` record that carries an event bag (and ``time_s``, when it
        has one).  Results come back in (arch-major, shape-minor) input
        order; a worker exception becomes a ``FAILED`` record, never an
        exception out of the sweep."""
        if cell_fn is None:
            from repro_torch.launch import dryrun

            def cell_fn(arch: str, shape: str) -> Dict:
                return dryrun.run_cell(arch, shape, multi_pod,
                                       out_dir=out_dir, verbose=False,
                                       session=self)

        cells = [(a, s) for a in archs for s in shapes]
        results: List[Optional[Dict]] = [None] * len(cells)
        with ThreadPoolExecutor(max_workers=max(1, parallel)) as ex:
            futs = {ex.submit(cell_fn, a, s): i
                    for i, (a, s) in enumerate(cells)}
            for fut in as_completed(futs):
                i = futs[fut]
                a, s = cells[i]
                try:
                    results[i] = fut.result()
                except Exception as e:   # keep the sweep alive
                    results[i] = {"cell": f"{a}/{s}", "status": "FAILED",
                                  "error": f"{type(e).__name__}: {e}"}
        for rec in results:
            self._attach_derived(rec, groups)
        return [r for r in results if r is not None]

    def _attach_derived(self, rec: Optional[Dict],
                        groups: Sequence[str]) -> None:
        if not (isinstance(rec, dict) and rec.get("status") == "ok"
                and "events" in rec):
            return
        from repro_torch.core.groups import get_group
        ev = EventCounts(counts=dict(rec["events"]))
        chip = self.chip or hwinfo.H100_SXM
        rec["derived"] = {g: get_group(g).derive(ev, chip,
                                                 rec.get("time_s"))
                          for g in groups}

    # ------------------------------------------------------------- output
    def stats(self) -> str:
        events = (f" ({self.event_timed} by CUDA events)"
                  if self.event_timed else "")
        return (f"{self.cache.stats.render()}, "
                f"{self.lowerings} timed probes this session{events} "
                f"[{self.cache.root}]")
