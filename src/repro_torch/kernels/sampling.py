"""Sampling: greedy, top-k and top-p decoding through a row-wise argmax
kernel.

Port of ``repro/kernels/sampling.py``: the Pallas ``_argmax_kernel``
behind ``block_argmax`` becomes ``csrc/argmax.cu`` (its source note says
what bounds it on an H100 and how it is laid out).  The kernel splits each
row over a few CTAs, one thread block cluster per row; :func:`argmax_plan`
chooses the split.

Every token is an argmax through :func:`block_argmax`:

* ``greedy`` ignores the generator by contract, so tokens are held bit for
  bit to ``torch.argmax`` and to the JAX package: the lowest index among
  equal maxima wins;
* ``top_k`` / ``top_p`` are ``argmax(filtered(logits / T) + gumbel)``, the
  Gumbel-argmax trick, as the reference's ``_run_pallas_topk`` /
  ``_run_pallas_topp`` run it: :func:`filtered_logits` and
  :func:`gumbel_shift` are plain tensor ops, the argmax is the kernel.
  The draw comes from an explicit ``torch.Generator`` on the logits'
  device.  CPU draws (mt19937) and CUDA draws (Philox) differ, and both
  differ from JAX's threefry, so sampled tokens are held to the reference
  in distribution and, inside the port, to themselves under one seed.

:func:`block_argmax` dispatches on the tensor's device: CPU tensors run
:func:`argmax_plain`, CUDA tensors launch the kernel (or raise — there is
no fallback).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["sample", "sample_ref", "filtered_logits", "gumbel_shift",
           "block_argmax", "argmax_plain", "argmax_plan",
           "argmax_boundary_logits", "METHODS"]

#: sampling methods, as the reference's registry names them
METHODS = ("greedy", "top_k", "top_p")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"argmax_rows": (_build.P, _build.P, _build.I, _build.I, _build.L,
                        _build.I, _build.I, _build.I, _build.P)}

#: CTAs a row at most: the portable thread block cluster size
ARGMAX_MAX_SPLIT = 8
#: elements a CTA at least: below that a split costs more than it reads
ARGMAX_MIN_CHUNK = 4096
#: CTAs a launch aims at: two per SM of an H100 SXM (132 SMs)
ARGMAX_TARGET_CTAS = 264


@functools.lru_cache(maxsize=64)
def argmax_plan(b: int, v: int) -> tuple:
    """``(split, chunk)`` for ``b`` rows of ``v`` logits: CTA ``r`` of a
    row scans ``[r * chunk, min(v, (r + 1) * chunk))``.  ``chunk`` is a
    multiple of 8 elements (16 bytes of bf16), so an aligned row splits on
    16-byte boundaries, and every CTA gets at least one element."""
    want = min(ARGMAX_MAX_SPLIT, -(-v // ARGMAX_MIN_CHUNK),
               -(-ARGMAX_TARGET_CTAS // max(b, 1)))
    chunk = -(-v // want)
    chunk = -(-chunk // 8) * 8
    return -(-v // chunk), chunk


def argmax_boundary_logits(rng: np.random.Generator, b: int, v: int,
                           peak: float = 60.0) -> np.ndarray:
    """fp32 logits [b, v] that put ties and NaN on both sides of each
    split boundary of :func:`argmax_plan`, by row kind (row ``i`` is kind
    ``i % 5``): 0, equal maxima ``peak`` either side of every cut; 1, NaN
    either side of a cut (the first wins); 2, the max just before a cut and
    NaN after it; 3, NaN just before a cut and the max after it; 4, all
    ``-inf`` (index 0).  The kernel's checks on the card and its CPU
    emulation both use it."""
    x = rng.standard_normal((b, v), np.float32)
    split, chunk = argmax_plan(b, v)
    cuts = [r * chunk for r in range(1, split)] or [v // 2]
    for i in range(b):
        c = cuts[i % len(cuts)]
        kind = i % 5
        if kind == 0:
            for cc in cuts:
                x[i, [cc - 1, cc]] = peak
        elif kind == 1:
            x[i, [c - 1, c]] = np.nan
        elif kind == 2:
            x[i, c - 1] = peak
            x[i, [c, min(c + 3, v - 1)]] = np.nan
        elif kind == 3:
            x[i, c - 1] = np.nan
            x[i, [c, min(c + 5, v - 1)]] = [peak, np.nan]
        else:
            x[i] = -np.inf
    return x


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
    dev = x.device
    if dev.type == "cpu":
        return argmax_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"block_argmax runs on cpu or cuda, not {dev}")
    if x.stride(1) != 1:
        raise ValueError("block_argmax needs a contiguous vocab dim")
    b, v = x.shape
    if b > 65535:
        raise ValueError(f"block_argmax takes at most 65535 rows, got {b}")
    split, chunk = argmax_plan(b, v)
    out = x.new_empty((b,), dtype=torch.int32)
    lib = _build.library("argmax", _SIG)
    guard, stream = _build.launch_on(dev)
    with guard:
        err = lib.argmax_rows(x.data_ptr(), out.data_ptr(), b, v,
                              x.stride(0), split, chunk,
                              _DTYPE_CODE[x.dtype], stream)
    _build.check(lib, err, "argmax_rows")
    block_argmax.launches += 1
    return out


#: kernel launches made through the wrapper (a plain counter; reset it by
#: assignment)
block_argmax.launches = 0


def filtered_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                    k: int = 0, p: float = 1.0) -> torch.Tensor:
    """Scale by 1/T and mask everything outside the top-k / nucleus set
    with ``-inf``, op for op as the reference.

    ``k=0`` / ``p=1.0`` are exact no-ops (no extra float ops).  The nucleus
    is the smallest prefix of the descending probabilities whose sum
    reaches ``p``; its cutoff is a value, so the sort's tie order does not
    matter."""
    x = logits
    if temperature != 1.0:
        x = x / temperature
    if k:
        thresh = torch.topk(x, min(int(k), x.shape[-1]), dim=-1
                            ).values[..., -1:]
        x = torch.where(x >= thresh, x, -torch.inf)
    if p < 1.0:
        xs = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(xs, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < p        # smallest set with cum >= p
        cutoff = torch.where(keep, xs, torch.inf).amin(dim=-1, keepdim=True)
        x = torch.where(x >= cutoff, x, -torch.inf)
    return x


def gumbel_shift(x: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    """``x + gumbel``: the argmax of this is a categorical draw.

    ``u`` is drawn in ``x``'s dtype on ``[finfo.tiny, 1)``, as
    ``jax.random.gumbel`` draws it (a 0 would give ``+inf`` and fix the
    token), and the shift is ``-log(-log(u))``.  One draw of ``x.shape``
    from ``generator``, which must live on ``x``'s device."""
    tiny = torch.finfo(x.dtype).tiny
    u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                   device=x.device).clamp_(min=tiny)
    return x - torch.log(-torch.log(u))


def _shifted(logits: torch.Tensor, generator: Optional[torch.Generator],
             method: str, temperature: float, k: int, p: float
             ) -> torch.Tensor:
    if method == "top_k":
        x = filtered_logits(logits, temperature=temperature, k=k)
    elif method == "top_p":
        x = filtered_logits(logits, temperature=temperature, p=p)
    else:
        raise ValueError(f"unknown sampling method {method!r}; choose from "
                         f"{METHODS}")
    if generator is None:
        raise ValueError(f"sampling method {method!r} needs a generator")
    return gumbel_shift(x, generator)


def sample_ref(logits: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               method: str = "greedy", temperature: float = 1.0, k: int = 0,
               p: float = 1.0) -> torch.Tensor:
    """The plain version of :func:`sample`: the same filter and draw, then
    :func:`argmax_plain` on any device."""
    if method == "greedy":
        return argmax_plain(logits)
    return argmax_plain(_shifted(logits, generator, method, temperature, k,
                                 p))


def sample(logits: torch.Tensor,
           generator: Optional[torch.Generator] = None, *,
           method: str = "greedy", temperature: float = 1.0, k: int = 0,
           p: float = 1.0) -> torch.Tensor:
    """One sampling step: logits [B, V] -> tokens int32 [B].

    ``greedy`` takes no random numbers; ``top_k`` keeps the ``k`` best of
    ``logits / temperature``, ``top_p`` the nucleus of mass ``p``, and
    both take one Gumbel draw of ``[B, V]`` from ``generator`` before
    :func:`block_argmax` (kernel #4 on the card) picks the token."""
    if method == "greedy":
        return block_argmax(logits)
    return block_argmax(_shifted(logits, generator, method, temperature, k,
                                 p))
