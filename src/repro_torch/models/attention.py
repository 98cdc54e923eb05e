"""GQA attention for the dense family: projections, prefill, decode.

Port of ``repro/models/attention.py`` for serving: dense and paged KV
caches, int8 pages with per-token scales, and the suffix prefill behind
the prefix cache.  Weight layouts are the JAX package's (``wq``
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
:func:`repro_torch.kernels.paged_decode.paged_decode_attention_grouped`
(fp pages) or ``paged_decode_attention_q8_grouped`` (int8 pages); a
prefix-cache hit prefills its suffix with plain ops, as the JAX package
does.  Dense decode has no kernel in the JAX package either; it is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.paged_decode import (
    paged_decode_attention_grouped, paged_decode_attention_q8_grouped)
from repro_torch.models.layers import apply_rope, truncated_normal_

__all__ = ["AttnConfig", "Attention", "KVCache", "init_kv_cache",
           "prefill_into_cache", "decode_attention", "PagedKVCache",
           "init_paged_kv_cache", "prefill_into_paged_cache",
           "paged_decode_attention_token", "KV_QUANT_EPS",
           "quantize_kv_rows", "dequantize_gathered"]

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
    ``length[b]`` masked (one softmax, the JAX package's dense path).  A
    row already at the buffer's end (an idle scheduler slot, or a
    segment's overshoot) drops its write, as a JAX scatter out of bounds
    does."""
    b = x.shape[0]
    length = cache.length
    q, k, v = _project_qkv(p, x, cfg, length[:, None])
    rows = torch.arange(b, device=x.device)
    smax = cache.k.shape[1]
    idx = torch.clamp(length, max=smax - 1).long()
    keep = (length < smax)[:, None, None]
    cache.k[rows, idx] = torch.where(keep, k[:, 0].to(cache.k.dtype),
                                     cache.k[rows, idx])
    cache.v[rows, idx] = torch.where(keep, v[:, 0].to(cache.v.dtype),
                                     cache.v[rows, idx])
    scores = _gqa_scores(q, cache.k.to(q.dtype)).float()
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
    entries point at it; writes routed there are trash, never read).

    int8 storage: when ``k_scale``/``v_scale`` are present the pages hold
    int8 codes and the scales hold one f32 dequantization factor per token
    row (``[(L,) P, page_size]``, amax over that token's [KVH, Dh] / 127),
    shared by every KV head.  Appends never requantize resident tokens."""

    k_pages: torch.Tensor     # [(L,) P, page_size, KVH, Dh] (fp or int8)
    v_pages: torch.Tensor     # [(L,) P, page_size, KVH, Dh]
    page_table: torch.Tensor  # [B, NP] int32 physical page ids
    length: torch.Tensor      # [B] int32 — tokens filled so far, per row
    k_scale: Optional[torch.Tensor] = None   # [(L,) P, page_size] f32
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[-3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


KV_QUANT_EPS = 1e-8


def quantize_kv_rows(seq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token-row int8: seq [..., KVH, Dh] -> (codes int8,
    scale f32 [...]) with scale = amax over the trailing [KVH, Dh] / 127.
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
    codes equal the JAX package's bit for bit."""
    f = seq.float()
    amax = f.abs().amax(dim=(-2, -1))
    scale = torch.clamp(amax, min=KV_QUANT_EPS) / 127.0
    codes = torch.clamp(torch.round(f / scale[..., None, None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_gathered(gathered: torch.Tensor, scale: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantize gathered int8 pages: gathered [..., ps, KVH, Dh] codes,
    scale [..., ps] -> fp values in ``dtype``."""
    return (gathered.float() * scale.float()[..., None, None]).to(dtype)


def init_paged_kv_cache(batch: int, num_pages: int, table_width: int,
                        page_size: int, cfg: AttnConfig, dtype: torch.dtype,
                        device: torch.device, layers: int,
                        kv_dtype: Optional[torch.dtype] = None
                        ) -> PagedKVCache:
    """Zeroed pools with a leading layers axis and an all-null page table
    (the table and lengths are shared by every layer).  ``kv_dtype``
    overrides the page storage dtype; ``torch.int8`` turns on quantized
    storage (per-token-row f32 scales ride along)."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    shape = (layers, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    scale = None
    if kv_dtype == torch.int8:
        scale = torch.zeros((layers, num_pages, page_size),
                            dtype=torch.float32, device=device)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=kv_dtype, device=device),
        v_pages=torch.zeros(shape, dtype=kv_dtype, device=device),
        page_table=torch.zeros((batch, table_width), dtype=torch.int32,
                               device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=scale, v_scale=None if scale is None else scale.clone())


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


def _token_slots(page_table: torch.Tensor, ps: int, s: int,
                 start: torch.Tensor, count: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page ids, offsets) [B,S] for tokens at logical positions
    ``start[b] + t``; tokens with ``t >= count[b]`` (padding) go to the
    null page 0."""
    np_w = page_table.shape[1]
    t = torch.arange(s, device=page_table.device)
    pos = start[:, None].long() + t[None, :]                   # [B,S]
    logical = torch.clamp(pos // ps, max=np_w - 1)
    ids = torch.gather(page_table, 1, logical).long()
    ids = torch.where(t[None, :] < count[:, None], ids, 0)
    return ids, pos % ps


def _scatter_pages_at(pages: torch.Tensor, page_table: torch.Tensor,
                      seq: torch.Tensor, start: torch.Tensor,
                      count: torch.Tensor) -> torch.Tensor:
    """Token-granular page scatter, in place: token t of row b lands at
    logical position ``start[b] + t`` (suffix prefill after a prefix-cache
    hit — the shared prefix's pages are already populated and are never
    rewritten).  Padding tokens (``t >= count[b]``) go to the null page,
    the only place where two writes can collide."""
    ids, offs = _token_slots(page_table, pages.shape[1], seq.shape[1],
                             start, count)
    pages[ids, offs] = seq.to(pages.dtype)
    return pages


def _scatter_scales_at(scales: torch.Tensor, page_table: torch.Tensor,
                       rows: torch.Tensor, start: torch.Tensor,
                       count: torch.Tensor) -> torch.Tensor:
    """Token-granular twin of :func:`_scatter_pages_at` for [B,S]
    per-token scales landing in the [P, ps] scale pool."""
    ids, offs = _token_slots(page_table, scales.shape[1], rows.shape[1],
                             start, count)
    scales[ids, offs] = rows.to(scales.dtype)
    return scales


def _gather_ctx(cache: PagedKVCache, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense [B, NP*ps, KVH, Dh] view of every page each row's table
    lists, dequantized when the cache stores int8 codes."""
    b, np_w = cache.page_table.shape
    ps, kvh, dh = cache.k_pages.shape[1:]
    pt = cache.page_table.long()
    k_g, v_g = cache.k_pages[pt], cache.v_pages[pt]   # [B,NP,ps,KVH,Dh]
    if cache.quantized:
        k_g = dequantize_gathered(k_g, cache.k_scale[pt], dtype)
        v_g = dequantize_gathered(v_g, cache.v_scale[pt], dtype)
    return (k_g.reshape(b, np_w * ps, kvh, dh).to(dtype),
            v_g.reshape(b, np_w * ps, kvh, dh).to(dtype))


def _suffix_prefill_attend(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                           cache: PagedKVCache, prefix_len: torch.Tensor,
                           lengths: torch.Tensor):
    """Prefill of a DIVERGENT SUFFIX against an already-resident prefix.

    Query token i of row b sits at absolute position ``prefix_len[b]+i``:
    it attends every resident prefix key (gathered from the row's pages,
    dequantized if int8) plus the causal span of the suffix itself.  The
    JAX package runs this as plain array code, not a Pallas kernel, and so
    does the port, on both devices.  Returns (attn out, k_suffix,
    v_suffix)."""
    b, s, _ = x.shape
    t = torch.arange(s, device=x.device)
    positions = prefix_len[:, None] + t[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    k_ctx, v_ctx = _gather_ctx(cache, q.dtype)
    ctx_w = k_ctx.shape[1]
    # joint mask over [ctx | suffix] keys: ctx key j real iff j < prefix;
    # suffix key u visible iff u <= i (causal) and u < suffix length
    ctx_ok = (torch.arange(ctx_w, device=x.device)[None, :]
              < prefix_len[:, None])[:, None, :].expand(b, s, ctx_w)
    suf_ok = ((t[None, :] <= t[:, None])[None]
              & (t[None, None, :] < lengths[:, None, None]))
    mask = torch.cat([ctx_ok, suf_ok], dim=-1)               # [B,S,ctx+S]
    k_all = torch.cat([k_ctx, k], dim=1)
    v_all = torch.cat([v_ctx, v], dim=1)
    scores = _gqa_scores(q, k_all).float()
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_out(probs, v_all), k, v


def prefill_into_paged_cache(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                             cache: PagedKVCache,
                             lengths: Optional[torch.Tensor] = None,
                             prefix_len: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, PagedKVCache]:
    """:func:`prefill_into_cache` with the K/V landing in the pages each
    row's table already lists (in place).  int8 caches quantize each token
    row on the way in (one f32 scale per token).

    ``prefix_len`` [B] switches to SUFFIX mode (prefix-cache hit): ``x``
    holds only the divergent suffix, queries run at absolute positions
    ``prefix_len + i`` against resident-prefix + suffix keys, and the
    scatter is token-granular from ``prefix_len`` on, so the shared prefix
    pages are never rewritten."""
    b, s, _ = x.shape
    suffix_len = _new_lengths(lengths, b, s, x.device)
    if prefix_len is None:
        out, k, v = _prefill_qkv_attend(p, x, cfg, lengths)
        new_len = suffix_len
        start = torch.zeros((b,), dtype=torch.int32, device=x.device)
    else:
        out, k, v = _suffix_prefill_attend(p, x, cfg, cache, prefix_len,
                                           suffix_len)
        new_len = prefix_len + suffix_len
        start = prefix_len
    if cache.quantized:
        k_codes, k_sc = quantize_kv_rows(k)
        v_codes, v_sc = quantize_kv_rows(v)
        pt = cache.page_table
        _scatter_pages_at(cache.k_pages, pt, k_codes, start, suffix_len)
        _scatter_pages_at(cache.v_pages, pt, v_codes, start, suffix_len)
        _scatter_scales_at(cache.k_scale, pt, k_sc, start, suffix_len)
        _scatter_scales_at(cache.v_scale, pt, v_sc, start, suffix_len)
    elif prefix_len is None:
        _scatter_pages(cache.k_pages, cache.page_table, k)
        _scatter_pages(cache.v_pages, cache.page_table, v)
    else:
        _scatter_pages_at(cache.k_pages, cache.page_table, k, start,
                          suffix_len)
        _scatter_pages_at(cache.v_pages, cache.page_table, v, start,
                          suffix_len)
    y = _out_proj(p, out)
    return y, cache._replace(length=new_len.to(torch.int32))


def paged_decode_attention_token(p: Attention, x: torch.Tensor,
                                 cfg: AttnConfig, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 length: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """One-token decode against READ-ONLY pages (one layer's pool).

    Attention reads only the pages each row's table lists, through the
    paged kernel (its int8 variant when ``k_scale``/``v_scale`` are
    given); the new token's K/V ``[B,1,KVH,Dh]`` are returned UNQUANTIZED
    for the caller to write into its page."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, length[:, None])
    kvh, dh = cfg.num_kv_heads, cfg.head_dim
    q4 = q.reshape(b, kvh, cfg.num_heads // kvh, dh)
    k_new, v_new = k.reshape(b, kvh, dh), v.reshape(b, kvh, dh)
    if k_scale is not None:
        out = paged_decode_attention_q8_grouped(
            q4, k_pages, v_pages, k_scale, v_scale, page_table, length,
            k_new, v_new)
    else:
        out = paged_decode_attention_grouped(
            q4, k_pages, v_pages, page_table, length, k_new, v_new)
    return _out_proj(p, out.reshape(b, 1, cfg.num_heads, dh)), k, v
