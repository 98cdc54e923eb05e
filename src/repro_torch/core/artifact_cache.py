"""Content-addressed measurement cache (the LIKWID 'stateful' layer).

Copy of ``repro/core/artifact_cache.py`` for the port.  The JAX tool
persists what a compile produced (HLO text and the events read from it);
the port has no compile artifact, so :class:`repro_torch.core.session.
ProfileSession` persists what a timed run produced: the declared events
of one call and its device seconds on the card.  Every (function
fingerprint, argument shapes / dtypes / strides / device, chip, toolchain)
combination maps to a SHA-256 digest, and a second measurement of the same
program is a dictionary lookup, not a timed run.

Disk layout (all under one root, default ``~/.cache/repro-perfctr``,
overridable with ``$REPRO_CACHE_DIR``, the same root and variable as the
JAX package's)::

    <root>/v1/<digest[:2]>/<digest>.json       # entry: events, times, meta

The JAX package's ``<digest>.hlo.zlib`` companion has no counterpart here.
Entries never cross between the two packages: the port's key material
names torch, CUDA and the port's own sources, never jax.

Invalidation is structural, never time-based:

* bump :data:`SCHEMA_VERSION` (new directory tree, old one ignored);
* the torch and CUDA versions, the card and ``nvcc`` participate in every
  key (``session._toolchain``), so a toolchain change is a miss;
* ``ArtifactCache.clear()`` (or ``rm -rf`` the root) for a hard reset.

Corrupted entries (truncated writes, bad JSON, schema drift) are detected
on read, moved aside as ``*.corrupt`` and treated as a miss: the cache
heals rather than serve garbage.  Writes are atomic (tempfile +
``os.replace``), so a killed process leaves a missing entry, never a torn
one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
from typing import Any, Dict, Iterator, Optional

__all__ = ["SCHEMA_VERSION", "CacheStats", "ArtifactCache",
           "default_cache_dir", "canonical_digest"]

# Bump to invalidate every existing entry (on-disk format or key-material
# semantics changed).  The version is part of the directory name so old
# trees are simply never read again.
SCHEMA_VERSION = 1

_ENV_VAR = "REPRO_CACHE_DIR"


def default_cache_dir() -> str:
    """``$REPRO_CACHE_DIR`` if set, else ``~/.cache/repro-perfctr``."""
    env = os.environ.get(_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-perfctr")


def canonical_digest(material: Dict[str, Any]) -> str:
    """SHA-256 over the canonical JSON form of the key material.

    ``material`` must be JSON-serializable; sort_keys + compact separators
    make the digest stable across processes and dict orderings.
    """
    blob = json.dumps(material, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


@dataclasses.dataclass
class CacheStats:
    """Hit/miss accounting for one :class:`ArtifactCache` instance."""

    hits: int = 0
    misses: int = 0
    stores: int = 0
    corrupt_evictions: int = 0
    quarantined: int = 0

    def render(self) -> str:
        total = self.hits + self.misses
        rate = self.hits / total if total else 0.0
        return (f"cache: {self.hits} hits / {self.misses} misses "
                f"({rate:.0%}), {self.stores} stores"
                + (f", {self.corrupt_evictions} corrupt evicted"
                   if self.corrupt_evictions else "")
                + (f", {self.quarantined} quarantined"
                   if self.quarantined else ""))


class ArtifactCache:
    """Content-addressed, disk-persistent store for measurement artifacts.

    Thread-safe: stats mutation is locked, writes are atomic renames, and
    reads tolerate (quarantine) partial or corrupt entries.  Multiple
    processes may share one root — last atomic write wins, which is fine
    because entries are content-addressed (same key => same content).
    """

    def __init__(self, root: Optional[str] = None, *, enabled: bool = True):
        self.root = os.path.abspath(root or default_cache_dir())
        self.enabled = enabled
        self.stats = CacheStats()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- layout
    @property
    def tree(self) -> str:
        return os.path.join(self.root, f"v{SCHEMA_VERSION}")

    def _entry_path(self, digest: str) -> str:
        return os.path.join(self.tree, digest[:2], f"{digest}.json")

    # -------------------------------------------------------------- reads
    def get(self, digest: str) -> Optional[Dict[str, Any]]:
        """Entry dict for ``digest``, or None (miss / disabled / corrupt)."""
        if not self.enabled:
            return None
        path = self._entry_path(digest)
        try:
            with open(path, "r", encoding="utf-8") as f:
                entry = json.load(f)
            if not isinstance(entry, dict) or \
                    entry.get("schema") != SCHEMA_VERSION:
                raise ValueError("schema mismatch")
        except FileNotFoundError:
            with self._lock:
                self.stats.misses += 1
            return None
        except (json.JSONDecodeError, ValueError, OSError):
            # keep the damaged bytes (renamed aside) for post-mortem
            # instead of destroying the evidence; the read is a miss and
            # the caller re-measures, overwriting the healthy path
            self.quarantine(digest)
            with self._lock:
                self.stats.corrupt_evictions += 1
                self.stats.misses += 1
            return None
        with self._lock:
            self.stats.hits += 1
        return entry

    # ------------------------------------------------------------- writes
    def put(self, digest: str, entry: Dict[str, Any]) -> None:
        """Persist one entry (atomic)."""
        if not self.enabled:
            return
        entry = dict(entry, schema=SCHEMA_VERSION)
        self._atomic_write(self._entry_path(digest),
                           json.dumps(entry, default=float).encode("utf-8"))
        with self._lock:
            self.stats.stores += 1

    def _atomic_write(self, path: str, blob: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".tmp-", suffix=".part")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # --------------------------------------------------------- management
    def _evict(self, digest: str) -> None:
        try:
            os.unlink(self._entry_path(digest))
        except OSError:
            pass

    def quarantine(self, digest: str) -> bool:
        """Move a damaged entry aside as ``<path>.corrupt`` (atomic
        rename; any previous quarantine of the same digest is replaced).
        The digest then reads as a miss — the caller re-measures and the
        healthy path is rewritten — while the bad bytes stay inspectable.
        Returns True if anything was moved."""
        p = self._entry_path(digest)
        if not os.path.exists(p):
            return False
        try:
            os.replace(p, p + ".corrupt")
        except OSError:
            # cross-device or permission trouble: fall back to evict so
            # the corrupt entry can never be served again
            try:
                os.unlink(p)
            except OSError:
                return False
        with self._lock:
            self.stats.quarantined += 1
        return True

    def entries(self) -> Iterator[str]:
        """Digests currently stored (current schema tree only)."""
        if not os.path.isdir(self.tree):
            return
        for shard in sorted(os.listdir(self.tree)):
            d = os.path.join(self.tree, shard)
            if not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                if name.endswith(".json"):
                    yield name[:-len(".json")]

    def __len__(self) -> int:
        return sum(1 for _ in self.entries())

    def clear(self) -> int:
        """Delete every entry in the current schema tree; return count."""
        n = 0
        for digest in list(self.entries()):
            self._evict(digest)
            n += 1
        return n
