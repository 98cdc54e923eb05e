"""Sampling: greedy decoding through a row-wise argmax kernel.

Port of ``repro/kernels/sampling.py`` for ``method="greedy"``: the Pallas
``_argmax_kernel`` behind ``block_argmax`` becomes ``csrc/argmax.cu``
(its source note says what bounds it on an H100 and how it is laid out).
Greedy ignores the PRNG by contract, so tokens are held bit for bit to
``torch.argmax`` and to the JAX package: the lowest index among equal
maxima wins.  ``top_k`` / ``top_p`` (filtering plus the Gumbel shift) wait
for the sampled-decoding item of ``ROADMAP.md``.

:func:`block_argmax` dispatches on the tensor's device: CPU tensors run
:func:`argmax_plain`, CUDA tensors launch the kernel (or raise — there is
no fallback).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["sample", "block_argmax", "argmax_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"argmax_rows": (_build.P, _build.P, _build.I, _build.I,
                        _build.L, _build.I, _build.P)}


def argmax_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``torch.argmax`` over the last dim,
    as int32 [B]."""
    return torch.argmax(x, dim=-1).to(torch.int32)


def block_argmax(x: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax of ``x`` [B, V] (fp32 or bf16) -> int32 [B].

    CUDA tensors launch ``csrc/argmax.cu`` (and count one launch in
    ``block_argmax.launches``); CPU tensors run the plain version."""
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"block_argmax takes [B, V>=1] logits, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"block_argmax takes fp32 or bf16, got {x.dtype}")
    if x.device.type == "cpu":
        return argmax_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"block_argmax runs on cpu or cuda, not {x.device}")
    if x.stride(1) != 1:
        raise ValueError("block_argmax needs a contiguous vocab dim")
    b, v = x.shape
    out = torch.empty((b,), dtype=torch.int32, device=x.device)
    lib = _build.library("argmax", _SIG)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.argmax_rows(x.data_ptr(), out.data_ptr(), b, v,
                              x.stride(0), _DTYPE_CODE[x.dtype], stream)
    _build.check(lib, err, "argmax_rows")
    block_argmax.launches += 1
    return out


#: kernel launches made through the wrapper (a plain counter; reset it by
#: assignment)
block_argmax.launches = 0


def sample(logits: torch.Tensor, *, method: str = "greedy") -> torch.Tensor:
    """One sampling step: logits [B, V] -> tokens int32 [B].

    Only ``greedy`` is ported (it needs no random numbers)."""
    if method != "greedy":
        raise NotImplementedError(
            f"sampling method {method!r} is not ported yet (ROADMAP.md, "
            f"queue 1 item 5: sampled top_k/top_p decoding)")
    return block_argmax(logits)
