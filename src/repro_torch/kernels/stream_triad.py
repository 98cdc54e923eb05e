"""STREAM triad (paper case study 1, §III): the CUDA kernel and its plain twin.

Port of ``repro/kernels/stream_triad.py``: the Pallas ``stream_triad_kernel``
becomes ``csrc/stream_triad.cu`` (its source note says what bounds it on an
H100 and how it is laid out).  The contract is the reference's: ``b`` and
``c`` are 1-D of one shape with ``N % 128 == 0``; ``a = b + s*c``;
``block_rows`` rows of 128 elements per block; ``pipelined=False`` runs
the whole array as one block (one CTA), the reference's "one block, no
pipelining" schedule — the same result, only the schedule changes.  On
the card a block is a CTA's tile (:func:`triad_plan`: one CTA a tile),
and the default tile is one 16-byte vector of each input a thread.

Traffic model: 3 streams of N elements (read b, read c, write a); a GPU
store does not read its line first when whole sectors are written, so
like the TPU kernel this is the paper's "NT store" case.

:func:`stream_triad` dispatches on the tensors' device: CPU tensors run
:func:`stream_triad_plain`, CUDA tensors launch the kernel (or raise —
there is no fallback).  Each call declares its FLOPs and bytes to
:mod:`repro_torch.core.events`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import events
from repro_torch.kernels import _build

__all__ = ["stream_triad", "stream_triad_plain", "triad_bytes",
           "triad_flops", "triad_plan", "default_block_rows",
           "declare_triad", "LANES"]

LANES = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"stream_triad_fwd": (_build.P, _build.P, _build.P, _build.L,
                             _build.F, _build.I, _build.L, _build.I,
                             _build.P)}
#: threads a CTA (``csrc/stream_triad.cu``'s kThreads)
TRIAD_THREADS = 256
_MAX_GRID = 2**31 - 1


def default_block_rows(dtype_bytes: int) -> int:
    """Rows of 128 in the default tile: one 16-byte vector of each input
    for each of the kernel's threads."""
    return TRIAD_THREADS * 16 // dtype_bytes // LANES


def triad_plan(n: int, dtype_bytes: int, block_rows: Optional[int] = None,
               pipelined: bool = True) -> tuple:
    """``(grid, tile)`` for the kernel: one CTA a tile of ``tile``
    elements (a multiple of 128), CTA ``i`` taking tiles ``i``,
    ``i + grid``, ... when the grid is smaller than the tile count.
    ``block_rows`` rows of 128 make a tile; the default is one 16-byte
    vector a thread (1024 fp32, 2048 bf16 elements).
    ``pipelined=False``: one CTA, one tile."""
    if not pipelined:
        return 1, max(n, LANES)
    rows = block_rows or default_block_rows(dtype_bytes)
    tile = max(min(rows, n // LANES), 1) * LANES
    return max(min(-(-n // tile), _MAX_GRID), 1), tile


def triad_bytes(n: int, dtype_bytes: int = 4) -> int:
    """Modeled HBM traffic per call (3 streams, no write-allocate)."""
    return 3 * n * dtype_bytes


def triad_flops(n: int) -> int:
    """One multiply and one add per element."""
    return 2 * n


def stream_triad_plain(b: torch.Tensor, c: torch.Tensor,
                       s: float = 2.5) -> torch.Tensor:
    """The plain PyTorch version: fp32 math, one rounding to b's dtype."""
    return (b.float() + s * c.float()).to(b.dtype)


def stream_triad(b: torch.Tensor, c: torch.Tensor, *, s: float = 2.5,
                 block_rows: Optional[int] = None, pipelined: bool = True
                 ) -> torch.Tensor:
    """b, c: flat [N] tensors with N % 128 == 0.  Returns a = b + s*c.

    ``block_rows`` (None: the card's default tile, see :func:`triad_plan`)
    and ``pipelined`` choose the schedule, never the result.  CUDA tensors
    launch ``csrc/stream_triad.cu`` (and count one launch in
    ``stream_triad.launches``); CPU tensors run the plain version."""
    if b.shape != c.shape or b.dim() != 1:
        raise ValueError(f"stream_triad takes two 1-D tensors of one shape, "
                         f"got {tuple(b.shape)} and {tuple(c.shape)}")
    n = b.shape[0]
    if n % LANES:
        raise ValueError(f"N={n} must be lane-aligned ({LANES})")
    if b.dtype not in _DTYPE_CODE or c.dtype != b.dtype:
        raise TypeError(f"stream_triad takes fp32 or bf16 of one dtype, got "
                        f"{b.dtype}/{c.dtype}")
    if block_rows is not None and block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if b.device != c.device:
        raise ValueError(f"b on {b.device}, c on {c.device}")
    if b.device.type == "cpu":
        a = stream_triad_plain(b, c, s)
    elif b.device.type == "cuda":
        a = _launch(b.contiguous(), c.contiguous(), s, block_rows,
                    pipelined)
    else:
        raise ValueError(f"stream_triad runs on cpu or cuda, not {b.device}")
    declare_triad(b)
    return a


def declare_triad(b: torch.Tensor, launch: bool = True) -> None:
    """Declare one triad over ``b``'s length and dtype (two streams read,
    one written) to the open event collections: as a launch from the
    wrapper, as plain work (``launch=False``) from the registry's plain
    impl."""
    n, nbytes = b.shape[0], b.element_size()
    record = events.record_launch if launch else events.record_ops
    record(flops=triad_flops(n), arg_bytes=2 * n * nbytes,
           out_bytes=n * nbytes)


def _launch(b: torch.Tensor, c: torch.Tensor, s: float,
            block_rows: Optional[int], pipelined: bool) -> torch.Tensor:
    a = torch.empty_like(b)
    n = b.shape[0]
    grid, tile = triad_plan(n, b.element_size(), block_rows, pipelined)
    lib = _build.library("stream_triad", _SIG)
    guard, stream = _build.launch_on(b.device)
    with guard:
        err = lib.stream_triad_fwd(b.data_ptr(), c.data_ptr(), a.data_ptr(),
                                   n, s, grid, tile, _DTYPE_CODE[b.dtype],
                                   stream)
    _build.check(lib, err, "stream_triad_fwd")
    stream_triad.launches += 1
    return a


#: kernel launches made through the wrapper (a plain counter; reset it by
#: assignment)
stream_triad.launches = 0
