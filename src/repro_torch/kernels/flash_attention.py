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

:func:`flash_attention_bhsd` dispatches on the tensors' device: CPU tensors
run :func:`flash_attention_plain`, CUDA tensors launch the kernel (or raise
— there is no fallback).  Inputs may be strided views (the model passes
BSHD tensors transposed to BHSD) as long as the head dim is contiguous.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_bhsd", "flash_attention_plain",
           "SUPPORTED_HEAD_DIMS"]

NEG_INF = -2.0e38
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"flash_attention_fwd": (
    _build.P, _build.P, _build.P, _build.P, _build.P,       # q k v o kv_valid
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,  # B H KVH Sq Sk Dh
    _build.I, _build.I, _build.F, _build.I,   # q_offset causal scale dtype
    _build.P, _build.P)}                      # strides stream


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
                         kv_valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q: [B,H,Sq,Dh]; k,v: [B,KVH,Sk,Dh] -> out [B,H,Sq,Dh] (q's dtype).

    CUDA tensors launch ``csrc/flash_attention.cu`` (and count one launch
    in ``flash_attention_bhsd.launches``); CPU tensors run the plain
    version.  ``q_offset`` is a host int; ``kv_valid`` lives with q."""
    _check(q, k, v, kv_valid)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_valid=kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
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
            _DTYPE_CODE[q.dtype], strides, stream)
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention_bhsd.launches += 1
    return out


#: kernel launches made through the wrapper (a plain counter; reset it by
#: assignment)
flash_attention_bhsd.launches = 0
