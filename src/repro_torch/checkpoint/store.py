"""Serving snapshots: the request plane's crash-safety format.

Port of the serving half of ``repro/checkpoint/store.py`` (its
``:202-301``), byte-compatible with it: a snapshot either package writes
loads in the other.  One self-contained file per snapshot::

    <header JSON: magic, version, crc32, length>\\n<payload JSON>

The payload is an arbitrary JSON tree; arrays (KV page contents, page
ids) are encoded in place as ``{"__nd__": [dtype, shape, b64]}`` so the
whole thing round-trips through one ``json.dumps``.  The CRC covers the
payload bytes: a truncated write, a flipped bit or schema drift is a
*detected* :class:`SnapshotCorrupt`, never silently restored state.
Writes go through a temp file, ``fsync`` and ``os.replace`` in the
destination directory, so a crash mid-save leaves the previous snapshot
intact.

bf16.  NumPy has no bfloat16; the JAX package names its bf16 arrays
``"bfloat16"`` and decodes them through ``ml_dtypes``.  The port encodes
a ``torch.bfloat16`` tensor under that same name with its raw 2-byte
payload, and decodes ``"bfloat16"`` bit for bit into a
``torch.bfloat16`` tensor through an ``int16`` view, with no
``ml_dtypes``.  Every other dtype decodes to a numpy array, as in the JAX
package; torch tensors of other dtypes encode through ``.numpy()``.

The pytree checkpoints of the JAX module (``save_checkpoint`` /
``restore_checkpoint``) go with training (``ROADMAP.md``, queue 1 item
13).
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

__all__ = ["SnapshotCorrupt", "save_serving_snapshot",
           "load_serving_snapshot", "list_snapshots", "latest_snapshot",
           "SNAP_MAGIC", "SNAP_VERSION"]

SNAP_MAGIC = "repro-serving-snapshot"
SNAP_VERSION = 1
_SNAP_SUFFIX = ".snap"
_BF16 = "bfloat16"


class SnapshotCorrupt(RuntimeError):
    """A serving snapshot failed validation (magic/version/CRC/JSON)."""


def _nd(dtype: str, shape, raw: bytes) -> dict:
    return {"__nd__": [dtype, list(shape),
                       base64.b64encode(raw).decode("ascii")]}


def _snap_encode(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _nd(_BF16, t.shape, t.view(torch.int16).numpy().tobytes())
        return _snap_encode(t.numpy())
    if isinstance(obj, np.ndarray):
        raw = np.ascontiguousarray(obj)
        return _nd(str(raw.dtype), raw.shape, raw.tobytes())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _snap_encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_snap_encode(v) for v in obj]
    return obj


def _snap_decode(obj: Any) -> Any:
    if isinstance(obj, dict):
        if set(obj) == {"__nd__"}:
            dtype, shape, b64 = obj["__nd__"]
            raw = base64.b64decode(b64.encode("ascii"))
            if dtype == _BF16:
                bits = np.frombuffer(raw, dtype=np.int16).reshape(shape)
                return torch.from_numpy(bits.copy()).view(torch.bfloat16)
            try:
                np_dtype = np.dtype(dtype)
            except TypeError as e:
                raise SnapshotCorrupt(
                    f"array dtype {dtype!r} has no numpy or torch "
                    f"decoding here") from e
            return np.frombuffer(raw, dtype=np_dtype).reshape(shape)
        return {k: _snap_decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_snap_decode(v) for v in obj]
    return obj


def save_serving_snapshot(path: str, payload: Any) -> str:
    """Atomically write one serving snapshot; returns ``path``."""
    body = json.dumps(_snap_encode(payload),
                      separators=(",", ":")).encode("utf-8")
    header = json.dumps({"magic": SNAP_MAGIC, "version": SNAP_VERSION,
                         "crc32": zlib.crc32(body), "length": len(body)
                         }).encode("utf-8")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=".snap.part")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(header + b"\n" + body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_serving_snapshot(path: str) -> Any:
    """Load + validate one snapshot; :class:`SnapshotCorrupt` on any
    header/CRC/JSON failure (a missing file stays FileNotFoundError)."""
    with open(path, "rb") as f:
        blob = f.read()
    head, sep, body = blob.partition(b"\n")
    if not sep:
        raise SnapshotCorrupt(f"{path}: no header line")
    try:
        header = json.loads(head.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise SnapshotCorrupt(f"{path}: unreadable header ({e})") from e
    if header.get("magic") != SNAP_MAGIC:
        raise SnapshotCorrupt(f"{path}: bad magic {header.get('magic')!r}")
    if header.get("version") != SNAP_VERSION:
        raise SnapshotCorrupt(
            f"{path}: snapshot version {header.get('version')} != "
            f"{SNAP_VERSION}")
    if header.get("length") != len(body):
        raise SnapshotCorrupt(
            f"{path}: payload truncated ({len(body)} of "
            f"{header.get('length')} bytes)")
    if header.get("crc32") != zlib.crc32(body):
        raise SnapshotCorrupt(f"{path}: CRC mismatch")
    try:
        payload = json.loads(body.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise SnapshotCorrupt(f"{path}: unreadable payload ({e})") from e
    return _snap_decode(payload)


def list_snapshots(dirpath: str) -> List[str]:
    """Snapshot paths under ``dirpath``, oldest first (name order — the
    scheduler names them by monotonically increasing segment count)."""
    if not os.path.isdir(dirpath):
        return []
    return [os.path.join(dirpath, n) for n in sorted(os.listdir(dirpath))
            if n.endswith(_SNAP_SUFFIX)]


def latest_snapshot(dirpath: str) -> Optional[str]:
    snaps = list_snapshots(dirpath)
    return snaps[-1] if snaps else None
