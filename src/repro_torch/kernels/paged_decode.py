"""Paged decode attention: the CUDA kernel and its plain twin.

Port of ``repro/kernels/paged_decode.py`` (the Pallas ``_paged_kernel``, fp
pages; the int8 ``_paged_kernel_q8`` waits for the int8-pages slice).  The
kernel is ``csrc/paged_decode.cu``; its source note says what bounds it on
an H100 and how it is laid out.  Contract, shared by both versions:

* q4 ``[B,KVH,G,Dh]``; pages ``[P,ps,KVH,Dh]`` (one layer's pool);
  page_table ``[B,NP]`` int32; lengths ``[B]`` int32 (past tokens — the new
  token is not in the pages yet); k_new/v_new ``[B,KVH,Dh]``;
* row b attends its live pages ``j * ps < lengths[b]`` through
  ``page_table[b, j]`` (entries past them are never read), masks the
  partial last page, and folds the new token in last (two-part softmax);
* ``lengths[b] == 0`` outputs exactly ``v_new``.

:func:`paged_decode_attention_grouped` dispatches on the tensors' device:
CPU tensors run :func:`paged_decode_plain`, CUDA tensors launch the kernel
(or raise — there is no fallback).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

__all__ = ["paged_decode_attention_grouped", "paged_decode_plain",
           "SUPPORTED_HEAD_DIMS"]

NEG_INF = -2.0e38
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"paged_decode_fwd": (
    _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.P,                                  # q4 kp vp pt lens kn vn out
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,
    _build.F, _build.I, _build.P)}             # B KVH G Dh ps NP scale dt st


def _check(q4, k_pages, v_pages, page_table, lengths, k_new, v_new):
    if q4.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("paged decode takes q4 [B,KVH,G,Dh] and pages "
                         "[P,ps,KVH,Dh]")
    b, kvh, _, dh = q4.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (kvh, dh):
        raise ValueError(f"page shapes {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q4 "
                         f"{tuple(q4.shape)}")
    if k_new.shape != (b, kvh, dh) or v_new.shape != (b, kvh, dh):
        raise ValueError(f"k_new/v_new must be [{b},{kvh},{dh}]")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("page_table must be [B,NP] and lengths [B]")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    dt = q4.dtype
    if dt not in _DTYPE_CODE or any(t.dtype != dt for t in
                                    (k_pages, v_pages, k_new, v_new)):
        raise TypeError("paged decode takes fp32 or bf16 q/pages/k_new/v_new "
                        "of one dtype")
    devs = {t.device for t in (q4, k_pages, v_pages, page_table, lengths,
                               k_new, v_new)}
    if len(devs) != 1:
        raise ValueError(f"paged decode inputs on several devices: {devs}")


def paged_decode_plain(q4: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: gather each row's live pages into a dense
    context (dead table entries read the null page 0 instead), then one
    two-part softmax over (masked context, the new token) in fp32."""
    b, kvh, g, dh = q4.shape
    ps = k_pages.shape[1]
    np_w = page_table.shape[1]
    scale = 1.0 / math.sqrt(dh)
    live = (torch.arange(np_w, device=q4.device)[None, :] * ps
            < lengths[:, None])                                  # [B,NP]
    ids = torch.where(live, page_table, 0).long()
    # [B,NP,ps,KVH,Dh] -> [B,KVH,NP*ps,Dh]
    k_ctx = k_pages[ids].float().reshape(b, np_w * ps, kvh, dh)
    v_ctx = v_pages[ids].float().reshape(b, np_w * ps, kvh, dh)
    k_ctx, v_ctx = k_ctx.transpose(1, 2), v_ctx.transpose(1, 2)
    q = q4.float() * scale                                       # [B,KVH,G,Dh]
    valid = (torch.arange(np_w * ps, device=q4.device)[None, :]
             < lengths[:, None])[:, None, None, :]               # [B,1,1,S]
    s_c = torch.where(valid, q @ k_ctx.transpose(-1, -2), NEG_INF)
    s_t = (q * k_new.float()[:, :, None, :]).sum(-1, keepdim=True)
    m = torch.maximum(s_c.amax(-1, keepdim=True), s_t)
    p_c = torch.where(valid, torch.exp(s_c - m), 0.0)
    p_t = torch.exp(s_t - m)
    denom = p_c.sum(-1, keepdim=True) + p_t
    out = (p_c @ v_ctx + p_t * v_new.float()[:, :, None, :]) / denom
    return out.to(q4.dtype)


def paged_decode_attention_grouped(q4: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   page_table: torch.Tensor,
                                   lengths: torch.Tensor,
                                   k_new: torch.Tensor, v_new: torch.Tensor
                                   ) -> torch.Tensor:
    """q4: [B,KVH,G,Dh] -> [B,KVH,G,Dh] (q4's dtype).

    CUDA tensors launch ``csrc/paged_decode.cu`` (and count one launch in
    ``paged_decode_attention_grouped.launches``); CPU tensors run the plain
    version."""
    _check(q4, k_pages, v_pages, page_table, lengths, k_new, v_new)
    if q4.device.type == "cpu":
        return paged_decode_plain(q4, k_pages, v_pages, page_table, lengths,
                                  k_new, v_new)
    if q4.device.type != "cuda":
        raise ValueError(f"paged decode runs on cpu or cuda, not "
                         f"{q4.device}")
    b, kvh, g, dh = q4.shape
    ps, np_w = k_pages.shape[1], page_table.shape[1]
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the paged kernel supports head dims "
                         f"{SUPPORTED_HEAD_DIMS}, got {dh}")
    if not 1 <= g <= 32:
        raise ValueError(f"the paged kernel serves 1..32 query heads per kv "
                         f"head, got {g}")
    if 4 * (ps * (2 * dh + 1) + g * dh) > 48 * 1024:
        raise ValueError(f"page_size {ps} x head dim {dh} does not fit the "
                         f"kernel's 48 KB of shared memory")
    tensors = (q4, k_pages, v_pages, page_table, lengths, k_new, v_new)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged kernel takes contiguous tensors")
    out = torch.empty_like(q4)
    lib = _build.library("paged_decode", _SIG)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        err = lib.paged_decode_fwd(
            q4.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), out.data_ptr(), b, kvh, g, dh, ps, np_w,
            1.0 / math.sqrt(dh), _DTYPE_CODE[q4.dtype], stream)
    _build.check(lib, err, "paged_decode_fwd")
    paged_decode_attention_grouped.launches += 1
    return out


#: kernel launches made through the wrapper (a plain counter; reset it by
#: assignment)
paged_decode_attention_grouped.launches = 0
