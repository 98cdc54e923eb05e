"""GQA attention for the dense family: projections, prefill, decode.

Port of ``repro/models/attention.py`` for serving without a prefix cache
and without int8 pages.  Weight layouts are the JAX package's (``wq``
``[d,H,Dh]``, ``wk``/``wv`` ``[d,KVH,Dh]``, ``wo`` ``[H,Dh,d]``, biases
``[H|KVH,Dh]``), so the parameter bridge needs no transposes.  KV caches
are stored ``[B, S, KVH, Dh]`` (dense) or as a page pool
``[P, page_size, KVH, Dh]`` (paged), as in the JAX package.

Unlike JAX's immutable arrays, cache tensors are updated IN PLACE: prefill
writes its K/V into the cache buffers it is given, and decode writes one
token per row.  The functions still return the cache (with its new
``length``) so call sites read like the JAX package's.

Prefill attention always goes through
:func:`repro_torch.kernels.flash_attention.flash_attention_bhsd` (the CUDA
kernel for CUDA tensors, its plain twin for CPU tensors); the kernel masks
ragged edges itself, so no shape heuristic sits in front of it.  Paged
decode goes through
:func:`repro_torch.kernels.paged_decode.paged_decode_attention_grouped`.
Dense decode has no kernel in the JAX package either; it is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.paged_decode import paged_decode_attention_grouped
from repro_torch.models.layers import apply_rope, truncated_normal_

__all__ = ["AttnConfig", "Attention", "KVCache", "init_kv_cache",
           "prefill_into_cache", "decode_attention", "PagedKVCache",
           "init_paged_kv_cache", "prefill_into_paged_cache",
           "paged_decode_attention_token"]

NEG_INF = -2.0e38


class AttnConfig(NamedTuple):
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    causal: bool = True
    use_rope: bool = True
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # Qwen2-VL
    chunk_size: int = 512
    chunk_threshold: int = 2048
    softmax_mode: str = "naive"


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """The attention weights of one block, in the JAX package's layouts."""

    def __init__(self, cfg: AttnConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, h, kvh, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.wq = param(d, h, dh)
        self.wk = param(d, kvh, dh)
        self.wv = param(d, kvh, dh)
        self.wo = param(h, dh, d)
        if cfg.qkv_bias:
            self.bq = param(h, dh)
            self.bk = param(kvh, dh)
            self.bv = param(kvh, dh)

    def init(self, generator: Optional[torch.Generator]) -> None:
        """``init_attn``'s distributions: truncated normals with std
        1/sqrt(d) (1/sqrt(H*Dh) for ``wo``), zero biases."""
        d = self.wq.shape[0]
        h, dh = self.wo.shape[0], self.wo.shape[1]
        for w in (self.wq, self.wk, self.wv):
            truncated_normal_(w, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.wo, 1.0 / math.sqrt(h * dh), generator)


# ---------------------------------------------------------------------------
# projections + rope
# ---------------------------------------------------------------------------

def _project_qkv(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor):
    """x [B,S,d] -> q [B,S,H,Dh], k/v [B,S,KVH,Dh], RoPE'd at ``positions``
    [B,S]."""
    b, s, d = x.shape
    q = (x @ p.wq.reshape(d, -1)).view(b, s, cfg.num_heads, cfg.head_dim)
    k = (x @ p.wk.reshape(d, -1)).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p.wv.reshape(d, -1)).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE (the vlm family) is not ported yet "
                                  "(ROADMAP.md, queue 1 item 12)")
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """[B,S,H,Dh] @ wo [H,Dh,d] -> [B,S,d]."""
    b, s, h, dh = out.shape
    return out.reshape(b, s, h * dh) @ p.wo.reshape(h * dh, -1)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,Sq,H,Dh], k: [B,Sk,KVH,Dh] -> scores [B,KVH,G,Sq,Sk] (q's
    dtype)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]                  # [B,KVH,1,Dh,Sk]
    return (qg @ kt) / math.sqrt(dh)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: [B,KVH,G,Sq,Sk], v: [B,Sk,KVH,Dh] -> [B,Sq,H,Dh]."""
    b, kvh, g, sq, _ = probs.shape
    out = probs @ v.permute(0, 2, 1, 3)[:, :, None]         # [B,KVH,G,Sq,Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, kvh * g, v.shape[-1])


# ---------------------------------------------------------------------------
# dense KV cache: prefill + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # [(L,) B, Smax, KVH, Dh]; a layer's view drops L
    v: torch.Tensor          # [(L,) B, Smax, KVH, Dh]
    length: torch.Tensor     # [B] int32 — tokens filled so far, per row


def init_kv_cache(batch: int, max_seq: int, cfg: AttnConfig,
                  dtype: torch.dtype, device: torch.device,
                  layers: int) -> KVCache:
    """Zeroed cache with a leading layers axis (the stacked state an LM
    carries; one layer's view is ``KVCache(k[i], v[i], length)``)."""
    shape = (layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((batch,), dtype=torch.int32,
                                      device=device))


def _prefill_qkv_attend(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                        lengths: Optional[torch.Tensor] = None):
    """The cache-agnostic half of prefill: project q/k/v and run the flash
    kernel (ragged ``lengths`` masked inside it).  Returns (attn out
    [B,S,H,Dh], k, v)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=cfg.causal,
                               q_offset=0, kv_valid=lengths)
    return out.transpose(1, 2), k, v


def _new_lengths(lengths: Optional[torch.Tensor], b: int, s: int,
                 device: torch.device) -> torch.Tensor:
    if lengths is not None:
        return lengths
    return torch.full((b,), s, dtype=torch.int32, device=device)


def prefill_into_cache(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                       cache: KVCache,
                       lengths: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill attention that also writes this segment's K/V into the
    cache (in place, at positions ``[0, S)``).  ``lengths`` [B] int32 marks
    each row's real prompt length: pad keys are masked out of every
    softmax and the cache records the true lengths."""
    b, s, _ = x.shape
    out, k, v = _prefill_qkv_attend(p, x, cfg, lengths)
    cache.k[:, :s] = k.to(cache.k.dtype)
    cache.v[:, :s] = v.to(cache.v.dtype)
    y = _out_proj(p, out)
    return y, cache._replace(length=_new_lengths(lengths, b, s, x.device))


def decode_attention(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                     cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: x [B,1,d]; row b holds ``length[b]`` past tokens.

    The new token's K/V are written in place at each row's own index
    ``length[b]``; attention spans the whole buffer with positions past
    ``length[b]`` masked (one softmax, the JAX package's dense path)."""
    b = x.shape[0]
    length = cache.length
    q, k, v = _project_qkv(p, x, cfg, length[:, None])
    rows = torch.arange(b, device=x.device)
    cache.k[rows, length.long()] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, length.long()] = v[:, 0].to(cache.v.dtype)
    scores = _gqa_scores(q, cache.k.to(q.dtype)).float()
    smax = cache.k.shape[1]
    valid = (torch.arange(smax, device=x.device)[None, :]
             <= length[:, None])                      # includes the new token
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = _gqa_out(probs, cache.v.to(q.dtype))
    return _out_proj(p, out), cache._replace(length=length + 1)


# ---------------------------------------------------------------------------
# paged KV cache: prefill + decode
# ---------------------------------------------------------------------------

class PagedKVCache(NamedTuple):
    """Page-pool KV storage.  ``page_table[b, j]`` is the physical page of
    row b's logical page j; physical page 0 is the null page (unallocated
    entries point at it; writes routed there are trash, never read)."""

    k_pages: torch.Tensor     # [(L,) P, page_size, KVH, Dh]
    v_pages: torch.Tensor     # [(L,) P, page_size, KVH, Dh]
    page_table: torch.Tensor  # [B, NP] int32 physical page ids
    length: torch.Tensor      # [B] int32 — tokens filled so far, per row

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[-3]


def init_paged_kv_cache(batch: int, num_pages: int, table_width: int,
                        page_size: int, cfg: AttnConfig, dtype: torch.dtype,
                        device: torch.device, layers: int) -> PagedKVCache:
    """Zeroed pools with a leading layers axis and an all-null page table
    (the table and lengths are shared by every layer)."""
    shape = (layers, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        page_table=torch.zeros((batch, table_width), dtype=torch.int32,
                               device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def _scatter_pages(pages: torch.Tensor, page_table: torch.Tensor,
                   seq: torch.Tensor) -> torch.Tensor:
    """Write [B,S,KVH,Dh] token rows into their pages, in place.

    Position t of row b lands in physical page ``page_table[b, t//ps]`` at
    offset ``t%ps``.  S is padded up to a page multiple; positions whose
    table entry is unallocated (0) land in the null page."""
    b, s, kvh, dh = seq.shape
    ps = pages.shape[1]
    pad = (-s) % ps
    if pad:
        seq = torch.cat([seq, seq.new_zeros((b, pad, kvh, dh))], dim=1)
    npp_eff = min(seq.shape[1] // ps, page_table.shape[1])
    tiles = seq[:, :npp_eff * ps].reshape(b * npp_eff, ps, kvh, dh)
    ids = page_table[:, :npp_eff].reshape(-1).long()
    pages[ids] = tiles.to(pages.dtype)
    return pages


def prefill_into_paged_cache(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                             cache: PagedKVCache,
                             lengths: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, PagedKVCache]:
    """:func:`prefill_into_cache` with the K/V landing in the pages each
    row's table already lists (in place).  The JAX package's ``prefix_len``
    suffix prefill waits for the prefix cache."""
    b, s, _ = x.shape
    out, k, v = _prefill_qkv_attend(p, x, cfg, lengths)
    _scatter_pages(cache.k_pages, cache.page_table, k)
    _scatter_pages(cache.v_pages, cache.page_table, v)
    y = _out_proj(p, out)
    return y, cache._replace(length=_new_lengths(lengths, b, s, x.device))


def paged_decode_attention_token(p: Attention, x: torch.Tensor,
                                 cfg: AttnConfig, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 length: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """One-token decode against READ-ONLY pages (one layer's pool).

    Attention reads only the pages each row's table lists, through the
    paged kernel; the new token's K/V ``[B,1,KVH,Dh]`` are returned for
    the caller to write into its page."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, length[:, None])
    kvh, dh = cfg.num_kv_heads, cfg.head_dim
    out = paged_decode_attention_grouped(
        q.reshape(b, kvh, cfg.num_heads // kvh, dh), k_pages, v_pages,
        page_table, length, k.reshape(b, kvh, dh), v.reshape(b, kvh, dh))
    return _out_proj(p, out.reshape(b, 1, cfg.num_heads, dh)), k, v
