"""Training checkpoints and serving snapshots.

Port of ``repro/checkpoint/store.py``, byte-compatible with it both ways.

**Pytree checkpoints** (``:44-199``)::

    <dir>/step_000000100/
        manifest.json      {step, leaves: [{file, path, shape, dtype}]}
        leaf_00000.npy ... (one raw-byte file per REFERENCE leaf)
    <dir>/step_000000100.COMMITTED   (empty marker written LAST)

The layout is the reference's: one file a leaf of the reference's
``TrainState`` in ``jax.tree_util.tree_flatten`` order (``params``,
``opt.m``, ``opt.v``, ``opt.step``, ``opt.ef`` when present, ``step``;
dict keys sorted), each stacked subtree's per-layer tensors stacked on
the leading axis (:func:`repro_torch.bridge.group_by_leaf`), ``path``
strings equal to ``jax.tree_util.keystr`` (``.params['blocks']['attn']
['wq']``), bf16 leaves under the name ``"bfloat16"`` as raw 2-byte data.
So a checkpoint either package writes restores in the other.

* **Atomic**: writers fill a ``.tmp-`` dir, fsync the manifest, rename,
  then touch the COMMITTED marker; readers ignore directories without a
  marker, so a mid-crash save can never be restored.
* **Async**: ``save_checkpoint(..., async_save=True)`` copies the tensors
  to host (the only synchronous part) and writes on a daemon thread;
  ``wait_pending()`` joins and re-raises a failed write's exception, and
  the next save or restore calls it first.
* **Retention**: keep the newest ``keep`` committed steps, delete older.
* **Restore** (:func:`restore_checkpoint`) copies each stored leaf IN
  PLACE into ``target``'s tensors (split over the layers where the port
  keeps one tensor a layer, cast to each tensor's dtype), matching
  leaves by path and shape, so a wrong order or structure fails loudly.
  A target tensor on the ``meta`` device is checked and skipped (the
  serve launcher restores only ``params``).

**Serving snapshots** (``:202-301``).  One self-contained file per
snapshot::

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
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import tempfile
import threading
import zlib
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_steps", "wait_pending", "SnapshotCorrupt",
           "save_serving_snapshot",
           "load_serving_snapshot", "list_snapshots", "latest_snapshot",
           "SNAP_MAGIC", "SNAP_VERSION"]

SNAP_MAGIC = "repro-serving-snapshot"
SNAP_VERSION = 1
_SNAP_SUFFIX = ".snap"
_BF16 = "bfloat16"


# ===========================================================================
# Pytree checkpoints (the training state)
# ===========================================================================

_PENDING: List[threading.Thread] = []
_FAILED: List[BaseException] = []


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:09d}")


def _marker(base: str, step: int) -> str:
    return _step_dir(base, step) + ".COMMITTED"


def list_steps(base: str) -> List[int]:
    if not os.path.isdir(base):
        return []
    out = []
    for name in os.listdir(base):
        if name.startswith("step_") and name.endswith(".COMMITTED"):
            out.append(int(name[len("step_"):-len(".COMMITTED")]))
    return sorted(out)


def latest_step(base: str) -> Optional[int]:
    steps = list_steps(base)
    return steps[-1] if steps else None


def _leaves(tree: Any, prefix: str = ""
            ) -> List[Tuple[str, List[torch.Tensor], bool]]:
    """(keystr path, tensors, stacked) of every reference leaf of
    ``tree`` in ``tree_flatten`` order: NamedTuples by field, dicts by
    sorted key (a dict of port-named tensors grouped into reference
    leaves first), None skipped.  ``stacked`` leaves hold one tensor a
    layer."""
    from repro_torch.bridge import leaf_tree
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, [tree], False)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for f in tree._fields
                for leaf in _leaves(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, Mapping):
        if all(isinstance(v, torch.Tensor) for v in tree.values()):
            tree = leaf_tree(tree)
        out = []
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, list):
                out.append((f"{prefix}['{k}']", v, True))
            else:
                out.extend(_leaves(v, f"{prefix}['{k}']"))
        return out
    raise TypeError(f"{prefix or 'tree'}: cannot checkpoint a "
                    f"{type(tree).__name__}")


def _host(parts: List[torch.Tensor], stacked: bool) -> torch.Tensor:
    """A host copy of one reference leaf (the layers stacked into one
    buffer, each copied once)."""
    if not stacked:
        return parts[0].detach().to("cpu", copy=True)
    out = torch.empty((len(parts), *parts[0].shape), dtype=parts[0].dtype)
    for i, t in enumerate(parts):
        out[i].copy_(t.detach())
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _write(base: str, step: int, host_leaves: List[torch.Tensor],
           paths: List[str], keep: Optional[int]) -> None:
    final = _step_dir(base, step)
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (leaf, path) in enumerate(zip(host_leaves, paths)):
        fname = f"leaf_{i:05d}.npy"
        # raw bytes (uint8 view): numpy has no bfloat16; dtype and shape
        # live in the manifest
        raw = leaf.contiguous().reshape(-1).view(torch.uint8).numpy()
        np.save(os.path.join(tmp, fname), raw)
        manifest["leaves"].append({
            "file": fname, "path": path,
            "shape": list(leaf.shape), "dtype": _dtype_name(leaf)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(_marker(base, step), "w"):
        pass
    if keep:
        for old in list_steps(base)[:-keep]:
            shutil.rmtree(_step_dir(base, old), ignore_errors=True)
            try:
                os.remove(_marker(base, old))
            except OSError:
                pass


def _write_or_record(*args) -> None:
    try:
        _write(*args)
    except BaseException as e:         # raised again by wait_pending()
        _FAILED.append(e)


def save_checkpoint(base: str, step: int, tree: Any, *,
                    keep: Optional[int] = 3,
                    async_save: bool = False) -> str:
    """Write one checkpoint of ``tree`` (a ``TrainState``, or any tree of
    NamedTuples, dicts and tensors).  Returns the committed directory.
    A write still in flight is joined first: at most one writer runs, so
    two writes of one step, or retention, never race on a directory."""
    wait_pending()
    os.makedirs(base, exist_ok=True)
    leaves = _leaves(tree)
    paths = [p for p, _, _ in leaves]
    host = [_host(parts, stacked) for _, parts, stacked in leaves]
    if async_save:
        t = threading.Thread(target=_write_or_record,
                             args=(base, step, host, paths, keep),
                             daemon=True)
        t.start()
        _PENDING.append(t)
    else:
        _write(base, step, host, paths, keep)
    return _step_dir(base, step)


def wait_pending() -> None:
    """Join the writes in flight; raise the first that failed."""
    while _PENDING:
        _PENDING.pop().join()
    if _FAILED:
        err = _FAILED[0]
        _FAILED.clear()
        raise err


def _load_leaf(path: str, entry: dict) -> torch.Tensor:
    raw = np.load(path)
    if entry["dtype"] == _BF16:
        t = torch.from_numpy(raw.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.view(np.dtype(entry["dtype"])).copy())
    return t.reshape(entry["shape"])


def restore_checkpoint(base: str, step: Optional[int] = None, *,
                       target: Any) -> Tuple[Any, dict]:
    """Restore into ``target``'s tensors, in place (see the module note);
    returns (target, manifest)."""
    wait_pending()
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {base}")
    d = _step_dir(base, step)
    if not os.path.exists(_marker(base, step)):
        raise FileNotFoundError(f"checkpoint step {step} not committed")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _leaves(target)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target has "
            f"{len(leaves)} — structure mismatch")
    for entry, (path, parts, stacked) in zip(manifest["leaves"], leaves):
        if entry["path"] != path:
            raise ValueError(f"leaf {entry['file']}: stored {entry['path']}"
                             f" != target {path}")
        want = ([len(parts)] if stacked else []) + list(parts[0].shape)
        if list(entry["shape"]) != want:
            raise ValueError(f"leaf {path}: stored {tuple(entry['shape'])} "
                             f"!= target {tuple(want)}")
        if parts[0].device.type == "meta":
            continue
        arr = _load_leaf(os.path.join(d, entry["file"]), entry)
        with torch.no_grad():
            for i, t in enumerate(parts):
                t.copy_(arr[i] if stacked else arr)
    return target, manifest


# ===========================================================================
# Serving snapshots (the request-plane crash-safety format)
# ===========================================================================

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
