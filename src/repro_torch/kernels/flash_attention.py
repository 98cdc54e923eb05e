"""Blockwise causal GQA flash attention: the CUDA kernel and its plain twin.

Port of ``repro/kernels/flash_attention.py`` (the Pallas ``_flash_kernel``).
The kernel is ``csrc/flash_attention.cu``; its source note says what bounds
it on an H100 and how it is laid out.  bf16 runs on the tensor cores (P is
rounded to bf16 before the PV product, the denominator and the output
accumulate in fp32); fp32 runs on the CUDA cores in fp32 throughout.
Contract, shared by both versions:

* q ``[B,H,Sq,Dh]``, k/v ``[B,KVH,Sk,Dh]`` -> out ``[B,H,Sq,Dh]`` in q's
  dtype; GQA maps q head ``h`` to kv head ``h // (H // KVH)``;
* query ``i`` sits at key position ``q_offset + i`` (causal mask);
* ``kv_valid`` ``[B]`` int32 (or None = Sk) masks keys at or past each
  row's valid length, causal or not; values are clamped to ``[0, Sk]``;
* rows with no valid key output exactly 0.

The kernel's tiles, ``(bq, bk)`` — queries a CTA and keys a shared-memory
tile — are template parameters over the pairs :data:`FLASH_PAIRS` lists
for each dtype (the kernel builds those and refuses any other);
:func:`default_blocks` is the pair an untuned call takes and
:func:`flash_smem_bytes` the shared memory a pair needs, the registry's
tune gate.

:func:`flash_attention_bhsd` dispatches on the tensors' device: CPU tensors
run :func:`flash_attention_plain`, CUDA tensors launch the kernel (or raise
— there is no fallback).  Inputs may be strided views (the model passes
BSHD tensors transposed to BHSD) as long as the head dim is contiguous.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import events
from repro_torch.kernels import _build

__all__ = ["flash_attention_bhsd", "flash_attention_plain",
           "flash_traffic", "declare_flash", "SUPPORTED_HEAD_DIMS",
           "FLASH_PAIRS", "default_blocks", "flash_smem_bytes"]

NEG_INF = -2.0e38
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"flash_attention_fwd": (
    _build.P, _build.P, _build.P, _build.P, _build.P,       # q k v o kv_valid
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,  # B H KVH Sq Sk Dh
    _build.I, _build.I, _build.F, _build.I,   # q_offset causal scale dtype
    _build.I, _build.I,                       # bq bk
    _build.P, _build.P)}                      # strides stream

#: the (bq, bk) pairs ``csrc/flash_attention.cu`` builds, per dtype
#: (``pick_bf16`` / ``pick_f32`` there list the same): bf16 on the tensor
#: cores, bq as 4 or 8 warps of 16 rows; fp32 on the CUDA cores in static
#: shared memory, every pair under 48 KB at Dh 128.  The first of each is
#: today's default.
FLASH_PAIRS = {
    torch.bfloat16: ((64, 64), (64, 32), (64, 128), (128, 32), (128, 64),
                     (128, 128)),
    torch.float32: ((64, 32), (32, 32), (64, 16), (128, 16)),
}


def default_blocks(dtype: torch.dtype) -> Tuple[int, int]:
    """The ``(bq, bk)`` an untuned call of ``dtype`` takes."""
    return FLASH_PAIRS[dtype][0]


def flash_smem_bytes(bq: int, bk: int, dh: int, dtype: torch.dtype) -> int:
    """Shared memory one CTA of the pair needs: bf16, the swizzled Q tile
    and two stages of K and V tiles; fp32, the K and V tiles and the
    padded ``[bq][bk + 1]`` score tile."""
    if dtype == torch.bfloat16:
        return (bq + 4 * bk) * dh * 2
    return (2 * bk * dh + bq * (bk + 1)) * 4


def _blocks(dtype: torch.dtype, blocks) -> Tuple[int, int]:
    if blocks is None:
        return default_blocks(dtype)
    pair = (int(blocks[0]), int(blocks[1]))
    if pair not in FLASH_PAIRS[dtype]:
        raise ValueError(f"the flash kernel builds (bq, bk) in "
                         f"{FLASH_PAIRS[dtype]} for {dtype}, not {pair}")
    return pair


def _check(q, k, v, kv_valid):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes q [B,H,Sq,Dh], k/v "
                         "[B,KVH,Sk,Dh]")
    b, h, _, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"H={h} is not a multiple of KVH={k.shape[1]}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes fp32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    devs = {q.device, k.device, v.device}
    if kv_valid is not None:
        if kv_valid.shape != (b,) or kv_valid.dtype != torch.int32:
            raise ValueError("kv_valid must be an int32 tensor of shape "
                             f"({b},)")
        devs.add(kv_valid.device)
    if len(devs) != 1:
        raise ValueError(f"flash attention inputs on several devices: {devs}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          kv_valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The plain PyTorch version: masked softmax over materialized scores,
    fp32, then cast to q's dtype."""
    b, h, sq, dh = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scores = (q.float() @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    kpos = torch.arange(sk, device=q.device)
    valid = (torch.full((b,), sk, dtype=torch.int32, device=q.device)
             if kv_valid is None else kv_valid.clamp(0, sk))
    ok = (kpos[None, :] < valid[:, None])[:, None, None, :]     # [B,1,1,Sk]
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        ok = ok & (kpos[None, :] <= qpos[:, None])[None, None]  # [B,1,Sq,Sk]
    scores = torch.where(ok, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(ok.any(dim=-1, keepdim=True), probs, 0.0)
    return (probs @ vf).to(q.dtype)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         kv_valid: Optional[torch.Tensor] = None,
                         bq: Optional[int] = None, bk: Optional[int] = None
                         ) -> torch.Tensor:
    """q: [B,H,Sq,Dh]; k,v: [B,KVH,Sk,Dh] -> out [B,H,Sq,Dh] (q's dtype).

    CUDA tensors launch ``csrc/flash_attention.cu`` (and count one launch
    in ``flash_attention_bhsd.launches``); CPU tensors run the plain
    version.  ``q_offset`` is a host int; ``kv_valid`` lives with q.
    ``bq``/``bk`` choose the tiles among :data:`FLASH_PAIRS` (None: the
    dtype's default; a pair not built raises on either device).  Each
    call declares :func:`flash_traffic` to the open event collections."""
    _check(q, k, v, kv_valid)
    blocks = _blocks(q.dtype, None if bq is None and bk is None
                     else (bq or default_blocks(q.dtype)[0],
                           bk or default_blocks(q.dtype)[1]))
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, causal=causal,
                                    q_offset=q_offset, kv_valid=kv_valid)
    elif q.device.type == "cuda":
        out = _launch(q, k, v, causal, q_offset, kv_valid, blocks)
    else:
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    declare_flash(q, k, kv_valid, causal=causal, q_offset=q_offset)
    return out


def declare_flash(q: torch.Tensor, k: torch.Tensor,
                  kv_valid: Optional[torch.Tensor], *, causal: bool,
                  q_offset: int, launch: bool = True) -> None:
    """Declare one call's :func:`flash_traffic` to the open event
    collections: as a launch from the wrapper, as plain work
    (``launch=False``) from the registry's plain impls."""
    if not events.active():
        return
    b, h, sq, dh = q.shape
    model = functools.partial(flash_traffic, h=h, kvh=k.shape[1], sq=sq,
                              sk=k.shape[2], dh=dh,
                              itemsize=q.element_size(), causal=causal,
                              q_offset=int(q_offset))
    f32 = q.dtype == torch.float32       # bf16 runs on the tensor cores
    if kv_valid is None:
        flops, arg_bytes, out_bytes = model(np.full(b, k.shape[2]))
        record = events.record_launch if launch else events.record_ops
        record(flops=flops, arg_bytes=arg_bytes, out_bytes=out_bytes,
               f32=f32)
    elif launch:
        events.record_launch_from(kv_valid, model, f32=f32)
    else:
        events.record_ops_from(kv_valid, model, f32=f32)


def flash_traffic(kv_valid: np.ndarray, *, h: int, kvh: int, sq: int,
                  sk: int, dh: int, itemsize: int, causal: bool,
                  q_offset: int) -> Tuple[float, float, float]:
    """(FLOPs, bytes read, bytes written) of one call, from each row's
    valid keys: QK^T and PV over the live (query, key) pairs only (a
    causal query ``i`` sees ``min(kv_valid, q_offset + i + 1)`` keys), q
    and the output once, each row's K/V up to the last key any query
    sees, and ``kv_valid``."""
    kv = np.clip(np.asarray(kv_valid, np.int64), 0, sk)
    if causal:
        reach = q_offset + np.arange(1, sq + 1)
        pairs = np.minimum(kv[:, None], reach[None, :]).sum()
        rows = np.minimum(kv, max(q_offset + sq, 0)).sum()
    else:
        pairs, rows = sq * kv.sum(), kv.sum()
    qo = kv.size * h * sq * dh * itemsize
    return (4.0 * dh * h * float(pairs),
            float(qo + 2 * kvh * dh * itemsize * rows + 4 * kv.size),
            float(qo))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            q_offset: int, kv_valid: Optional[torch.Tensor],
            blocks: Tuple[int, int]) -> torch.Tensor:
    b, h, sq, dh = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the flash kernel supports head dims "
                         f"{SUPPORTED_HEAD_DIMS}, got {dh}")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError("the flash kernel needs a contiguous head dim")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    strides = qs[:3] + ks[:3] + vs[:3]
    if q.dtype == torch.bfloat16 and (any(p % 16 for p in ptrs)
                                      or any(st % 8 for st in strides)):
        raise ValueError("the bf16 flash kernel copies 16-byte row chunks: "
                         "q/k/v must start on 16 bytes with batch, head "
                         "and seq strides that are multiples of 8")
    if kv_valid is None:
        kv_valid = torch.full((b,), sk, dtype=torch.int32, device=q.device)
    elif not kv_valid.is_contiguous():
        raise ValueError("kv_valid must be contiguous")
    out = q.new_empty((b, h, sq, dh))           # contiguous
    strides = (ctypes.c_int64 * 12)(*strides, h * sq * dh, sq * dh, dh)
    lib = _build.library("flash_attention", _SIG)
    guard, stream = _build.launch_on(q.device)
    with guard:
        err = lib.flash_attention_fwd(
            *ptrs, out.data_ptr(), kv_valid.data_ptr(), b, h, kvh, sq, sk,
            dh, int(q_offset), int(bool(causal)), 1.0 / math.sqrt(dh),
            _DTYPE_CODE[q.dtype], blocks[0], blocks[1], strides, stream)
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention_bhsd.launches += 1
    return out


#: kernel launches made through the wrapper (a plain counter; reset it by
#: assignment)
flash_attention_bhsd.launches = 0
