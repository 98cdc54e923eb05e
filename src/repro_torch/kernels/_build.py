"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C entry points (no PyTorch headers,
so a build takes seconds, not minutes) and compiles on its own into
``build/repro_torch/<name>-<hash>.so`` at the repository root; the hash
covers the source, the shared header and the flags, so an edited source
rebuilds and an unchanged one loads from disk.  Nothing builds at import:
the first CUDA launch of a kernel builds its library, and
:func:`build_all` starts one ``nvcc`` per source, all at once, for callers
that want every kernel ready up front.

Every entry point takes its pointers and the CUDA stream as ``c_void_p``
and returns the ``cudaGetLastError()`` of its launch; :func:`check` turns
a non-zero code into an exception.  :func:`launch_on` gives a wrapper the
device guard and the raw stream handle for a launch at a fraction of the
host cost of ``torch.cuda.device`` and ``torch.cuda.current_stream``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import ContextManager, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["SOURCES", "CSRC", "SMEM_OPT_IN", "build_dir", "build_all",
           "library", "check", "launch_on", "P", "I", "L", "F"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_attention", "paged_decode", "paged_decode_q8", "argmax",
           "stream_triad", "jacobi7", "ssd_scan")
_HEADERS = ("common.cuh", "paged_split.cuh", "tensor_core.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: dynamic shared memory a block may opt in to on sm_90, 227 KiB
#: (``csrc/common.cuh::kMaxSmemOptIn``)
SMEM_OPT_IN = 232448

# ctypes argument kinds for the signature tables in the kernel modules
P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_NO_GUARD = contextlib.nullcontext()


def build_dir() -> Path:
    """``build/repro_torch`` under the repository root (``src/..``)."""
    return CSRC.parents[2] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def _so_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when the library is on disk."""
    out = _so_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)            # atomic: concurrent builds agree


def build_all() -> float:
    """Build every library in parallel (one ``nvcc`` per source) and load
    it.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in SOURCES if n not in _loaded}
        try:
            for n, job in jobs.items():
                _finish(n, job)
        finally:
            for job in jobs.values():       # never leave a compiler running
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
    for n in SOURCES:
        library(n)
    return time.perf_counter() - t0


def library(name: str,
            signatures: Optional[Dict[str, Sequence]] = None
            ) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps entry-point names to their ``argtypes``; every
    entry point returns an ``int`` (its ``cudaError_t``)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _loaded[name] = ctypes.CDLL(str(_so_path(name)))
        for fn, argtypes in (signatures or {}).items():
            f = getattr(lib, fn)        # ctypes caches the function object
            if f.argtypes is None:
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_error_string.argtypes = [ctypes.c_int]
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} "
                           f"(cudaError_t {err})")


def launch_on(dev: torch.device) -> Tuple[ContextManager, int]:
    """``(guard, stream)`` for a launch on CUDA device ``dev``.

    A kernel launches on the calling thread's current device, so ``guard``
    makes ``dev`` current for the launch: a no-op context when it already
    is (the common case), else ``torch.cuda.device``.  ``stream`` is the
    raw handle of ``dev``'s current stream, read without building a
    ``torch.cuda.Stream`` object."""
    cur = torch.cuda.current_device()
    idx = cur if dev.index is None else dev.index
    guard = _NO_GUARD if idx == cur else torch.cuda.device(idx)
    return guard, torch._C._cuda_getCurrentRawStream(idx)
