"""Paged decode attention: the CUDA kernels and their plain twins.

Port of ``repro/kernels/paged_decode.py``: the Pallas ``_paged_kernel``
(fp pages) becomes ``csrc/paged_decode.cu`` and ``_paged_kernel_q8``
(int8 pages) becomes ``csrc/paged_decode_q8.cu``; their source notes say
what bounds them on an H100 and how they are laid out.  Both kernels
split each row's pages over a thread block cluster of :func:`split_plan`
CTAs and merge their partial softmaxes in one launch
(``csrc/paged_split.cuh``).  Contract, shared by all four versions:

* q4 ``[B,KVH,G,Dh]``; pages ``[P,ps,KVH,Dh]`` (one layer's pool);
  page_table ``[B,NP]`` int32; lengths ``[B]`` int32 (past tokens — the new
  token is not in the pages yet); k_new/v_new ``[B,KVH,Dh]`` in q's dtype;
* fp pages may be stored in another dtype than q (``kv_dtype="fp32"`` on a
  bf16 model): every load is cast to fp32, as the TPU kernel does;
* int8 pages hold codes with one f32 scale per (page, position) in
  ``k_scale``/``v_scale`` ``[P,ps]``, shared by every KV head, dequantized
  right after the load; the new token stays in floating point;
* row b attends its live pages ``j * ps < lengths[b]`` through
  ``page_table[b, j]`` (entries past them are never read), masks the
  partial last page, and folds the new token in last (two-part softmax);
* ``lengths[b] == 0`` outputs exactly ``v_new``.

:func:`paged_decode_attention_grouped` and
:func:`paged_decode_attention_q8_grouped` dispatch on the tensors' device:
CPU tensors run :func:`paged_decode_plain` / :func:`paged_decode_q8_plain`,
CUDA tensors launch the kernel (or raise — there is no fallback).
``split=`` overrides :func:`split_plan`'s CTAs a row (1 to
:data:`MAX_SPLIT`: the registry's tune knob); it changes the order of the
partial softmaxes' merge, never the set of keys.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import events
from repro_torch.kernels import _build

__all__ = ["paged_decode_attention_grouped", "paged_decode_plain",
           "paged_decode_attention_q8_grouped", "paged_decode_q8_plain",
           "split_plan", "fp_smem_bytes", "q8_smem_bytes", "paged_traffic",
           "declare_paged", "SUPPORTED_HEAD_DIMS"]

NEG_INF = -2.0e38
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"paged_decode_fwd": (
    _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.P,                                  # q4 kp vp pt lens kn vn out
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,
    _build.I, _build.F, _build.I, _build.I,    # B KVH G Dh ps NP split
    _build.P)}                                 # scale dt page_dt stream
_SIG_Q8 = {"paged_decode_q8_fwd": (
    _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.P, _build.P, _build.P,              # q4 kp vp ksc vsc pt lens
                                               # kn vn out
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,
    _build.I, _build.F, _build.I, _build.P)}   # B KVH G Dh ps NP split
                                               # scale dt stream
#: CTAs a row at most: the portable thread block cluster size
MAX_SPLIT = 8
#: CTAs a launch aims at: one per SM of an H100 SXM (132 SMs)
TARGET_CTAS = 132
#: pages in each CTA's shared-memory ring (``csrc/paged_split.cuh``)
STAGES = 4
#: dynamic shared memory one block may opt in to on sm_90 (227 KiB)
SMEM_PER_BLOCK = _build.SMEM_OPT_IN
#: the int8 kernel's shared memory takes no opt-in
Q8_SMEM_LIMIT = 48 * 1024


@functools.lru_cache(maxsize=64)
def split_plan(b: int, kvh: int, np_w: int) -> int:
    """CTAs (one thread block cluster) per (kv head, batch row) of either
    paged kernel, from shapes only: as many as the cluster, the table's
    ``np_w`` pages and a one-wave launch of ~132 CTAs allow.  It never
    reads ``lengths`` (on the card: a read would sync the host)."""
    return max(1, min(MAX_SPLIT, np_w, -(-TARGET_CTAS // max(b * kvh, 1))))


def fp_smem_bytes(ps: int, dh: int, g: int, page_bytes: int) -> int:
    """Shared memory of one CTA of the fp kernel: a ring of :data:`STAGES`
    slots, each the K and V rows ``[ps][dh]`` of one head in the pages'
    dtype (``page_bytes`` an element), then the partials (m, l, acc
    ``[dh]``) of its ``g`` query heads
    (``csrc/paged_decode.cu::smem_bytes``)."""
    return STAGES * 2 * ps * dh * page_bytes + 4 * g * (dh + 2)


def q8_smem_bytes(ps: int, dh: int, g: int) -> int:
    """Shared memory of one CTA of the int8 kernel: a ring of
    :data:`STAGES` slots, each the K and V codes ``[ps][dh]`` and their
    two ``[ps]`` f32 scales (rounded up to 16 bytes), then the partials
    (m, l, acc ``[dh]``) of its ``g`` query heads
    (``csrc/paged_decode_q8.cu::smem_bytes``)."""
    slot = 2 * ps * dh + -(-8 * ps // 16) * 16
    return STAGES * slot + 4 * g * (dh + 2)


def _check(q4, k_pages, v_pages, page_table, lengths, k_new, v_new,
           page_dtypes):
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
    if dt not in _DTYPE_CODE or k_new.dtype != dt or v_new.dtype != dt:
        raise TypeError("paged decode takes fp32 or bf16 q/k_new/v_new of "
                        "one dtype")
    if k_pages.dtype not in page_dtypes or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged decode takes K/V pages of one dtype among "
                        f"{page_dtypes}, got {k_pages.dtype}/"
                        f"{v_pages.dtype}")
    devs = {t.device for t in (q4, k_pages, v_pages, page_table, lengths,
                               k_new, v_new)}
    if len(devs) != 1:
        raise ValueError(f"paged decode inputs on several devices: {devs}")


def _split(split, b: int, kvh: int, np_w: int) -> int:
    """The CTAs a row: ``split`` (validated), else :func:`split_plan`."""
    if split is None:
        return split_plan(b, kvh, np_w)
    if not 1 <= int(split) <= MAX_SPLIT:
        raise ValueError(f"split must be in [1, {MAX_SPLIT}] (the portable "
                         f"cluster size), got {split}")
    return int(split)


def _check_scales(k_pages, k_scale, v_scale):
    want = tuple(k_pages.shape[:2])
    if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
        raise ValueError(f"k_scale/v_scale must be [P,ps] = {list(want)}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("k_scale/v_scale must be float32")
    if k_scale.device != k_pages.device or v_scale.device != k_pages.device:
        raise ValueError("k_scale/v_scale must live with the pages")


def _live_ids(page_table, lengths, ps):
    """Each row's table with the entries past its live pages replaced by
    the null page 0 (they are never read, so garbage there is harmless)."""
    np_w = page_table.shape[1]
    live = (torch.arange(np_w, device=page_table.device)[None, :] * ps
            < lengths[:, None])                                  # [B,NP]
    return torch.where(live, page_table, 0).long()


def _attend(q4, k_ctx, v_ctx, lengths, k_new, v_new):
    """The two-part softmax over (masked dense context, the new token) in
    fp32: k/v_ctx [B,NP,ps,KVH,Dh] fp32, gathered from the live pages."""
    b, kvh, g, dh = q4.shape
    s = k_ctx.shape[1] * k_ctx.shape[2]
    scale = 1.0 / math.sqrt(dh)
    k_ctx = k_ctx.reshape(b, s, kvh, dh).transpose(1, 2)     # [B,KVH,S,Dh]
    v_ctx = v_ctx.reshape(b, s, kvh, dh).transpose(1, 2)
    q = q4.float() * scale                                   # [B,KVH,G,Dh]
    valid = (torch.arange(s, device=q4.device)[None, :]
             < lengths[:, None])[:, None, None, :]           # [B,1,1,S]
    s_c = torch.where(valid, q @ k_ctx.transpose(-1, -2), NEG_INF)
    s_t = (q * k_new.float()[:, :, None, :]).sum(-1, keepdim=True)
    m = torch.maximum(s_c.amax(-1, keepdim=True), s_t)
    p_c = torch.where(valid, torch.exp(s_c - m), 0.0)
    p_t = torch.exp(s_t - m)
    denom = p_c.sum(-1, keepdim=True) + p_t
    out = (p_c @ v_ctx + p_t * v_new.float()[:, :, None, :]) / denom
    return out.to(q4.dtype)


def paged_decode_plain(q4: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: gather each row's live pages into a dense
    context (dead table entries read the null page 0 instead), cast to
    fp32, then one two-part softmax over (masked context, the new token)."""
    ids = _live_ids(page_table, lengths, k_pages.shape[1])
    return _attend(q4, k_pages[ids].float(), v_pages[ids].float(), lengths,
                   k_new, v_new)


def paged_decode_q8_plain(q4: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor) -> torch.Tensor:
    """The plain int8 version: gather each row's live pages, dequantize the
    codes with their per-token scales in fp32, then the same two-part
    softmax as :func:`paged_decode_plain`."""
    ids = _live_ids(page_table, lengths, k_pages.shape[1])
    k_ctx = k_pages[ids].float() * k_scale[ids][..., None, None]
    v_ctx = v_pages[ids].float() * v_scale[ids][..., None, None]
    return _attend(q4, k_ctx, v_ctx, lengths, k_new, v_new)


def _launch_checks(what, q4, k_pages, tensors, smem, smem_limit):
    """What the CUDA kernels take, beyond the shared contract; ``smem``:
    the kernel's shared-memory bytes at these shapes, at most
    ``smem_limit``."""
    if q4.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {q4.device}")
    _, _, g, dh = q4.shape
    ps = k_pages.shape[1]
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the {what} kernel supports head dims "
                         f"{SUPPORTED_HEAD_DIMS}, got {dh}")
    if not 1 <= g <= 32:
        raise ValueError(f"the {what} kernel serves 1..32 query heads per "
                         f"kv head, got {g}")
    if smem > smem_limit:
        raise ValueError(f"page_size {ps} x head dim {dh} x {g} heads needs "
                         f"{smem} B, over the {what} kernel's {smem_limit} "
                         f"B of shared memory")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {what} kernel takes contiguous tensors")
    if k_pages.data_ptr() % 16 or tensors[2].data_ptr() % 16:
        raise ValueError(f"the {what} kernel copies 16-byte vectors: the "
                         f"pages must start 16-byte aligned")


def paged_traffic(lengths: np.ndarray, *, kvh: int, g: int, dh: int,
                  ps: int, q_itemsize: int, page_itemsize: int,
                  scales: bool) -> Tuple[float, float, float]:
    """(FLOPs, bytes read, bytes written) of one call, from each row's
    past tokens: every live page (``ceil(length / ps)`` a row) of K and V
    once, with its two f32 scales a token for int8 pages and its table
    entry; q, the new K/V, ``lengths`` and the output once; QK^T and PV
    over the past tokens and the new one."""
    lens = np.maximum(np.asarray(lengths, np.int64), 0)
    live = int(((lens + ps - 1) // ps).sum())
    b = lens.size
    per_token = 2 * kvh * dh * page_itemsize + (8 if scales else 0)
    out = b * kvh * g * dh * q_itemsize
    arg = (out + 2 * b * kvh * dh * q_itemsize + 4 * b
           + live * (ps * per_token + 4))
    return (4.0 * dh * kvh * g * float((lens + 1).sum()), float(arg),
            float(out))


def declare_paged(q4: torch.Tensor, k_pages: torch.Tensor,
                  lengths: torch.Tensor, scales: bool,
                  launch: bool = True) -> None:
    """Declare one call's :func:`paged_traffic` (fp32 math on the CUDA
    cores, every dtype) to the open event collections: as a launch from
    the wrappers, as plain work (``launch=False``) from the registry's
    plain impls."""
    if events.active():
        _, kvh, g, dh = q4.shape
        record = (events.record_launch_from if launch
                  else events.record_ops_from)
        record(lengths, functools.partial(
            paged_traffic, kvh=kvh, g=g, dh=dh, ps=k_pages.shape[1],
            q_itemsize=q4.element_size(),
            page_itemsize=k_pages.element_size(), scales=scales))


def paged_decode_attention_grouped(q4: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   page_table: torch.Tensor,
                                   lengths: torch.Tensor,
                                   k_new: torch.Tensor, v_new: torch.Tensor,
                                   split: Optional[int] = None
                                   ) -> torch.Tensor:
    """q4: [B,KVH,G,Dh] -> [B,KVH,G,Dh] (q4's dtype); fp32 or bf16 pages.

    CUDA tensors launch ``csrc/paged_decode.cu`` (and count one launch in
    ``paged_decode_attention_grouped.launches``); CPU tensors run the plain
    version.  ``split``: CTAs a row (None: :func:`split_plan`)."""
    _check(q4, k_pages, v_pages, page_table, lengths, k_new, v_new,
           tuple(_DTYPE_CODE))
    n_split = _split(split, q4.shape[0], q4.shape[1], page_table.shape[1])
    if q4.device.type == "cpu":
        out = paged_decode_plain(q4, k_pages, v_pages, page_table, lengths,
                                 k_new, v_new)
        declare_paged(q4, k_pages, lengths, scales=False)
        return out
    tensors = (q4, k_pages, v_pages, page_table, lengths, k_new, v_new)
    b, kvh, g, dh = q4.shape
    ps, np_w = k_pages.shape[1], page_table.shape[1]
    _launch_checks("paged decode", q4, k_pages, tensors,
                   fp_smem_bytes(ps, dh, g, k_pages.element_size()),
                   SMEM_PER_BLOCK)
    out = torch.empty_like(q4)
    lib = _build.library("paged_decode", _SIG)
    guard, stream = _build.launch_on(q4.device)
    with guard:
        err = lib.paged_decode_fwd(
            *(t.data_ptr() for t in tensors), out.data_ptr(), b, kvh, g, dh,
            ps, np_w, n_split, 1.0 / math.sqrt(dh),
            _DTYPE_CODE[q4.dtype], _DTYPE_CODE[k_pages.dtype], stream)
    _build.check(lib, err, "paged_decode_fwd")
    paged_decode_attention_grouped.launches += 1
    declare_paged(q4, k_pages, lengths, scales=False)
    return out


#: kernel launches made through the wrapper (a plain counter; reset it by
#: assignment)
paged_decode_attention_grouped.launches = 0


def paged_decode_attention_q8_grouped(q4: torch.Tensor, k_pages: torch.Tensor,
                                      v_pages: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      page_table: torch.Tensor,
                                      lengths: torch.Tensor,
                                      k_new: torch.Tensor,
                                      v_new: torch.Tensor,
                                      split: Optional[int] = None
                                      ) -> torch.Tensor:
    """:func:`paged_decode_attention_grouped` over int8 pages with their
    ``[P,ps]`` f32 scales (the JAX wrapper's argument order).

    CUDA tensors launch ``csrc/paged_decode_q8.cu`` (and count one launch
    in ``paged_decode_attention_q8_grouped.launches``); CPU tensors run
    the plain version.  ``split``: CTAs a row (None: :func:`split_plan`)."""
    _check(q4, k_pages, v_pages, page_table, lengths, k_new, v_new,
           (torch.int8,))
    _check_scales(k_pages, k_scale, v_scale)
    n_split = _split(split, q4.shape[0], q4.shape[1], page_table.shape[1])
    if q4.device.type == "cpu":
        out = paged_decode_q8_plain(q4, k_pages, v_pages, k_scale, v_scale,
                                    page_table, lengths, k_new, v_new)
        declare_paged(q4, k_pages, lengths, scales=True)
        return out
    tensors = (q4, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
               k_new, v_new)
    b, kvh, g, dh = q4.shape
    ps, np_w = k_pages.shape[1], page_table.shape[1]
    _launch_checks("q8 paged decode", q4, k_pages, tensors,
                   q8_smem_bytes(ps, dh, g), Q8_SMEM_LIMIT)
    out = torch.empty_like(q4)
    lib = _build.library("paged_decode_q8", _SIG_Q8)
    guard, stream = _build.launch_on(q4.device)
    with guard:
        err = lib.paged_decode_q8_fwd(
            *(t.data_ptr() for t in tensors), out.data_ptr(), b, kvh, g, dh,
            ps, np_w, n_split, 1.0 / math.sqrt(dh),
            _DTYPE_CODE[q4.dtype], stream)
    _build.check(lib, err, "paged_decode_q8_fwd")
    paged_decode_attention_q8_grouped.launches += 1
    declare_paged(q4, k_pages, lengths, scales=True)
    return out


#: kernel launches made through the wrapper (a plain counter; reset it by
#: assignment)
paged_decode_attention_q8_grouped.launches = 0
