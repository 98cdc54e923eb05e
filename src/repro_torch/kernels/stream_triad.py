"""STREAM triad (paper case study 1, §III): the CUDA kernel and its plain twin.

Port of ``repro/kernels/stream_triad.py``: the Pallas ``stream_triad_kernel``
becomes ``csrc/stream_triad.cu`` (its source note says what bounds it on an
H100 and how it is laid out).  The contract is the reference's: ``b`` and
``c`` are 1-D of one shape with ``N % 128 == 0``; ``a = b + s*c``;
``block_rows`` rows of 128 elements per block (per CTA on the card);
``pipelined=False`` runs the whole array as one block (one CTA), the
reference's "one block, no pipelining" schedule — the same result, only
the schedule changes.

Traffic model: 3 streams of N elements (read b, read c, write a); a GPU
store does not read its line first when whole sectors are written, so
like the TPU kernel this is the paper's "NT store" case.

:func:`stream_triad` dispatches on the tensors' device: CPU tensors run
:func:`stream_triad_plain`, CUDA tensors launch the kernel (or raise —
there is no fallback).  Each call declares its FLOPs and bytes to
:mod:`repro_torch.core.events`.
"""

from __future__ import annotations

import torch

from repro_torch.core import events
from repro_torch.kernels import _build

__all__ = ["stream_triad", "stream_triad_plain", "triad_bytes",
           "triad_flops", "LANES"]

LANES = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"stream_triad_fwd": (_build.P, _build.P, _build.P, _build.L,
                             _build.F, _build.L, _build.I, _build.P)}


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
                 block_rows: int = 256, pipelined: bool = True
                 ) -> torch.Tensor:
    """b, c: flat [N] tensors with N % 128 == 0.  Returns a = b + s*c.

    CUDA tensors launch ``csrc/stream_triad.cu`` (and count one launch in
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
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if b.device != c.device:
        raise ValueError(f"b on {b.device}, c on {c.device}")
    if b.device.type == "cpu":
        a = stream_triad_plain(b, c, s)
    elif b.device.type == "cuda":
        a = _launch(b.contiguous(), c.contiguous(), s,
                    min(block_rows, n // LANES) * LANES if pipelined else n)
    else:
        raise ValueError(f"stream_triad runs on cpu or cuda, not {b.device}")
    nbytes = b.element_size()
    events.record_launch(flops=triad_flops(n), arg_bytes=2 * n * nbytes,
                         out_bytes=n * nbytes)
    return a


def _launch(b: torch.Tensor, c: torch.Tensor, s: float,
            per_cta: int) -> torch.Tensor:
    a = torch.empty_like(b)
    lib = _build.library("stream_triad", _SIG)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.stream_triad_fwd(b.data_ptr(), c.data_ptr(), a.data_ptr(),
                                   b.shape[0], s, max(per_cta, 1),
                                   _DTYPE_CODE[b.dtype], stream)
    _build.check(lib, err, "stream_triad_fwd")
    stream_triad.launches += 1
    return a


#: kernel launches made through the wrapper (a plain counter; reset it by
#: assignment)
stream_triad.launches = 0
