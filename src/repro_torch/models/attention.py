"""GQA attention: projections (RoPE or M-RoPE), prefill, decode.

Port of ``repro/models/attention.py`` for serving: dense and paged KV
caches, int8 pages with per-token scales, the suffix prefill behind the
prefix cache, and the cache-free :func:`attention` forward the
encoder-decoder's encoder runs.  A config with ``mrope_sections`` (the
vlm family) rotates q and k with M-RoPE wherever the caller passes the
three position streams ``positions3`` (prefill), and with 1-D RoPE
otherwise (decode), as the JAX package does.  Weight layouts are the JAX
package's (``wq`` ``[d,H,Dh]``, ``wk``/``wv`` ``[d,KVH,Dh]``, ``wo`` ``[H,Dh,d]``, biases
``[H|KVH,Dh]``), so the parameter bridge needs no transposes.  KV caches
are stored ``[B, S, KVH, Dh]`` (dense) or as a page pool
``[P, page_size, KVH, Dh]`` (paged), as in the JAX package.

Unlike JAX's immutable arrays, cache tensors are updated IN PLACE: prefill
writes its K/V into the cache buffers it is given, and decode writes one
token per row.  The functions still return the cache (with its new
``length``) so call sites read like the JAX package's.

Under tensor parallelism the serving functions take ``tp``, the rank's
model axis (the config then holds the rank's head counts): ``wo``'s
partial sums and an int8 row's amax reduce over it.

Prefill attention and paged decode go through the kernel registry
(:mod:`repro_torch.kernels.registry`), as in the JAX package: the
``attention`` family picks kernel #1 (``cuda_flash``) for CUDA tensors
and, on the CPU, the reference's non-TPU choice (``full`` up to
``chunk_threshold``, then the flash kernel's plain version); the
``paged_decode`` family picks kernel #2 or #3 (int8 pages) for CUDA
tensors and their plain versions on the CPU.  A pin (``use_impl``,
``REPRO_IMPL``, ``ServeConfig.impls``) overrides either choice.  A
prefix-cache hit prefills its suffix with plain ops, as the JAX package
does.  Dense decode has no kernel in the JAX package either; it is plain
PyTorch.

**Training** (``repro/models/attention.py:137-406``).  :func:`attention`
under grad (autograd on and an input that needs a gradient) asks the
registry (``differentiable=True``).  On the card, for bf16 at a head dim
the training kernels build (64, 80, 128), it takes ``cuda_flash_train``:
the hand-written flash forward and backward of
``kernels/flash_attention_train.py`` as a ``torch.autograd.Function``
(the logsumexp saved, P recomputed in the backward, no ``[., S, S]``
tensor), which the JAX package does not have.  A pin to
``cuda_flash_train`` takes them wherever it is set; a pin to any other
impl (``cuda_flash``, ``torch_flash``, ``full``, from ``use_impl``,
``REPRO_IMPL`` or ``REPRO_ATTN_IMPL``, typically set for serving) only
keeps the kernels out, so that a serving pin never fails a training
step.  Every call the kernels do not take (the CPU, fp32, another head
dim, such a pin) follows the reference's train path, as it did before
the kernels existed: ``_full_attention_offset`` up to
``chunk_threshold`` queries, ``_chunked_attention`` above, each with
``softmax_mode`` ``naive`` (mask, fp32 softmax, cast) or ``fused``
(scale folded into q, additive mask, unnormalised probs in the compute
dtype) as plain code,
or ``kernel``: the registry with ``differentiable=True``, which picks
``torch_flash``, the flash core as a ``torch.autograd.Function``
(:class:`_FlashCore`: an online-softmax forward that saves the
logsumexp, a backward that recomputes each tile and never saves the
``[., Sq, Sk]`` stack).  Kernel #1 (``cuda_flash``) carries no gradient
(it is loaded through ``ctypes``), so the registry never selects it
under grad and refuses a pin to it.  Without grad, :func:`attention`
keeps its registry route (the encoder's serving forward).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import registry
from repro_torch.models.layers import (apply_mrope, apply_rope, cast,
                                      truncated_normal_)

__all__ = ["AttnConfig", "Attention", "KVCache", "KVLayout", "init_kv_cache",
           "prefill_into_cache", "decode_attention", "PagedKVCache",
           "init_paged_kv_cache", "prefill_into_paged_cache",
           "paged_decode_attention_token", "KV_QUANT_EPS",
           "quantize_kv_rows", "dequantize_gathered", "full_attention",
           "attention", "flash_attention_train", "attn_specs",
           "relay_kv", "split_attend"]

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


def attn_specs(cfg: AttnConfig) -> dict:
    """Logical axes of each attention weight (the reference's
    ``attn_specs``): heads split over ``model``, d_model over ``data``."""
    s = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias:
        s["bq"] = ("heads", "head_dim")
        s["bk"] = ("kv_heads", "head_dim")
        s["bv"] = ("kv_heads", "head_dim")
    return s


# ---------------------------------------------------------------------------
# projections + rope
# ---------------------------------------------------------------------------

def _project_qkv(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor,
                 positions3: Optional[torch.Tensor] = None,
                 head_dim: Any = None):
    """x [B,S,d] -> q [B,S,H,Dh], k/v [B,S,KVH,Dh], RoPE'd at ``positions``
    [B,S], or M-RoPE'd at ``positions3`` [3,B,S] when the config has
    ``mrope_sections`` and the caller passes them
    (``repro/models/attention.py:108-113``).  ``head_dim``: the axis a
    ``kv_shard="headdim"`` rank's paired cut of the head dim splits over
    (:class:`KVLayout`); RoPE then rotates at the cut's frequencies."""
    b, s, d = x.shape
    dt = x.dtype
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ cast(p.wq, dt).reshape(d, -1)).view(b, s, h, dh)
    k = (x @ cast(p.wk, dt).reshape(d, -1)).view(b, s, kvh, dh)
    v = (x @ cast(p.wv, dt).reshape(d, -1)).view(b, s, kvh, dh)
    if cfg.qkv_bias:
        q = q + cast(p.bq, dt)
        k = k + cast(p.bk, dt)
        v = v + cast(p.bv, dt)
    if not cfg.use_rope:
        return q, k, v
    pairs = None if head_dim is None else (head_dim.size, head_dim.index)
    if cfg.mrope_sections is not None and positions3 is not None:
        if pairs is not None:
            raise ValueError("kv_shard='headdim' is a decode layout: "
                             "M-RoPE's positions come only at prefill")
        q = apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta, pairs)
        k = apply_rope(k, positions, cfg.rope_theta, pairs)
    return q, k, v


def _out_proj(p: Attention, out: torch.Tensor, tp: Any = None,
              sp: bool = False) -> torch.Tensor:
    """[B,S,H,Dh] @ wo [H,Dh,d] -> [B,S,d].  Under tensor parallelism
    (``tp``, the model axis; the config then holds the rank's head
    counts) ``wo`` is row-parallel: this rank's heads give a partial sum,
    reduced over the axis here (``wo`` has no bias to add after it), or
    under sequence parallelism (``sp``) reduce-scattered over the
    sequence."""
    b, s, h, dh = out.shape
    y = out.reshape(b, s, h * dh) @ cast(p.wo, out.dtype).reshape(h * dh,
                                                                  -1)
    if tp is None:
        return y
    return tp.reduce_scatter(y, 1) if sp else tp.all_reduce(y)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor,
                scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,Sq,H,Dh], k: [B,Sk,KVH,Dh] -> scores [B,KVH,G,Sq,Sk] (q's
    dtype), times ``scale`` (divided by ``sqrt(Dh)`` by default)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]                  # [B,KVH,1,Dh,Sk]
    if scale is not None:
        return (qg @ kt) * scale
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


class KVLayout(NamedTuple):
    """How a rank holds its dense caches (and the encdec memory) where
    they follow the reference's decode-state layout (``LM.state_pspecs``)
    instead of the engine's kv-head split; None fields are whole.

    * ``seq``: the axes the cache's sequence dim is cut over (a
      :class:`repro_torch.launch.mesh.DataAxis` of them, major to minor):
      the rank holds positions ``[index * S_l, (index + 1) * S_l)``, attends
      them and combines its partial softmax (max, then the sum of the
      rescaled sums and weighted values: two all-reduces, the split-K
      combine of ``csrc/paged_split.cuh``) over the axes;
    * ``heads``: the model axis the rank's weights split heads over while
      its cache holds every kv head (``kv_heads`` finds ``model`` taken by
      ``cache_seq``): the new q/k/v are gathered over it before attending
      and the output cut back to the rank's heads for the row-parallel
      ``wo``;
    * ``head_dim``: the model axis the head dim splits over
      (``kv_shard="headdim"``): the rank holds a paired cut of every head
      (block ``index`` of each half, so RoPE's pairs stay on the rank),
      its scores are partial dot products all-reduced over the axis and
      its output is its head-dim slice, ``wo`` row-parallel over it."""

    seq: Any = None
    heads: Any = None
    head_dim: Any = None

    def dh_full(self, dh: int) -> int:
        """The whole head dim of a rank's ``dh``."""
        return dh * (self.head_dim.size if self.head_dim is not None else 1)

    def lo(self, s_local: int) -> int:
        """The first position of this rank's sequence slice."""
        return self.seq.index * s_local if self.seq is not None else 0


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


def _full_attention_offset(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, q_offset: int, causal: bool,
                           kv_len: Optional[torch.Tensor],
                           softmax_mode: str = "naive") -> torch.Tensor:
    """Masked softmax over materialized scores for queries at key
    positions ``q_offset + i`` (``repro/models/attention.py``'s
    ``_full_attention_offset``): ``naive`` takes probabilities in fp32,
    cast to q's dtype before the PV product; ``fused`` and ``kernel`` go
    to :func:`_fused_attention_offset` and the registry's
    differentiable impl."""
    if softmax_mode == "fused":
        return _fused_attention_offset(q, k, v, q_offset, causal, kv_len)
    if softmax_mode == "kernel":
        impl = registry.select("attention", sq=q.shape[1], sk=k.shape[1],
                               dh=q.shape[-1], causal=causal,
                               backend=q.device.type, differentiable=True)
        return registry.run("attention", q, k, v, impl=impl,
                            q_offset=q_offset, causal=causal, kv_len=kv_len,
                            differentiable=True)
    sq, sk = q.shape[1], k.shape[1]
    scores = _gqa_scores(q, k).float()                     # [B,KVH,G,Sq,Sk]
    kpos = torch.arange(sk, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        scores = torch.where(kpos[None, :] <= qpos[:, None], scores, NEG_INF)
    if kv_len is not None:
        ok = kpos[None, :] < kv_len[:, None]               # [B,Sk]
        scores = torch.where(ok[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_out(probs, v)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_offset: int = 0, causal: bool = True,
                   kv_len: Optional[torch.Tensor] = None,
                   chunk_size: int = 512, chunk_threshold: int = 2048
                   ) -> torch.Tensor:
    """The registry's ``full`` attention: q [B,Sq,H,Dh], k/v
    [B,Sk,KVH,Dh] -> [B,Sq,H,Dh].  Above ``chunk_threshold`` queries (and
    ``q_offset == 0``) it runs in query chunks of ``chunk_size`` against
    the full keys, the reference's ``_chunked_attention`` memory guard."""
    sq = q.shape[1]
    if sq <= chunk_threshold or q_offset != 0:
        return _full_attention_offset(q, k, v, q_offset, causal, kv_len)
    return torch.cat([_full_attention_offset(q[:, i:i + chunk_size], k, v,
                                             i, causal, kv_len)
                      for i in range(0, sq, chunk_size)], dim=1)


def _kv_len_ok(kv_len: torch.Tensor, sk: int) -> torch.Tensor:
    """Per-row key validity [B,1,1,1,Sk]: key j is real iff j < len_b."""
    kpos = torch.arange(sk, device=kv_len.device)
    return (kpos[None, :] < kv_len[:, None])[:, None, None, None, :]


def _fused_attention_offset(qc: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, q_offset: int,
                            causal: bool = True,
                            kv_len: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The reference's traffic-lean ``fused`` softmax: 1/sqrt(dh) folded
    into q, the masks added to the scores, the max detached, the
    unnormalised probabilities stored in q's dtype, fp32 sums, and
    1/denominator applied to the PV output."""
    b, sq, h, dh = qc.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qs = qc * torch.tensor(1.0 / math.sqrt(dh), dtype=qc.dtype)
    qg = qs.reshape(b, sq, kvh, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    masked = scores
    if causal:
        qpos = torch.arange(sq, device=qc.device) + q_offset
        ok = torch.arange(sk, device=qc.device)[None, :] <= qpos[:, None]
        masked = masked + torch.where(ok, 0.0, NEG_INF)
    if kv_len is not None:
        masked = masked + torch.where(_kv_len_ok(kv_len, sk), 0.0, NEG_INF)
    m = masked.amax(dim=-1, keepdim=True).detach()
    pr = torch.exp(masked - m).to(qc.dtype)
    denom = pr.float().sum(dim=-1)                         # [b,kvh,g,sq]
    out = torch.einsum("bkgqs,bskd->bqkgd", pr.float(), v.float())
    out = out / torch.clamp(denom.permute(0, 3, 1, 2), min=1e-37)[..., None]
    return out.to(qc.dtype).reshape(b, sq, h, v.shape[-1])


def _tile_bias(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               kv_len: torch.Tensor) -> torch.Tensor:
    """Additive tile bias [B,1,1,sq|1,bk]: per-row key validity folded
    together with the causal offset mask."""
    ok = (kpos[None, :] < kv_len[:, None])[:, None, None, None, :]
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])[None, None, None]
    return torch.where(ok, 0.0, NEG_INF)


class _FlashCore(torch.autograd.Function):
    """The reference's ``_flash_core`` custom VJP
    (``repro/models/attention.py:261-352``).  Layouts: ``qs`` [b,sq,kvh,
    g,dh] (already scaled by 1/sqrt(dh)); ``k``/``v`` [b,sk,kvh,dh] with
    sk a multiple of ``k_chunk``; the output [b,kvh,g,sq,dh].  Products
    accumulate in fp32; the probabilities meet V in q's dtype."""

    @staticmethod
    def _tiles(qs, k, v, qpos, kv_len, causal, k_chunk):
        for i in range(k.shape[1] // k_chunk):
            lo = i * k_chunk
            kc, vc = k[:, lo:lo + k_chunk], v[:, lo:lo + k_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qs.float(), kc.float())
            kpos = torch.arange(lo, lo + k_chunk, device=qs.device)
            yield kc, vc, s + _tile_bias(qpos, kpos, causal, kv_len)

    @staticmethod
    def forward(ctx, qs, k, v, qpos, kv_len, causal: bool, k_chunk: int):
        b, sq, kvh, g, dh = qs.shape
        f32 = dict(dtype=torch.float32, device=qs.device)
        acc = torch.zeros((b, kvh, g, sq, v.shape[-1]), **f32)
        m = torch.full((b, kvh, g, sq), NEG_INF, **f32)
        ll = torch.zeros((b, kvh, g, sq), **f32)
        for _, vc, s in _FlashCore._tiles(qs, k, v, qpos, kv_len, causal,
                                          k_chunk):
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            # fully masked rows: zero, so they output 0 exactly
            p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
            ll = ll * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(qs.dtype).float(),
                              vc.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        l_safe = torch.clamp(ll, min=1e-37)
        out = (acc / l_safe[..., None]).to(qs.dtype)
        lse = m + torch.log(l_safe)                  # logsumexp residual
        ctx.save_for_backward(qs, k, v, qpos, kv_len, out, lse)
        ctx.causal, ctx.k_chunk = causal, k_chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        qs, k, v, qpos, kv_len, out, lse = ctx.saved_tensors
        dout32 = dout.float()
        d_row = (dout32 * out.float()).sum(dim=-1)   # [b,kvh,g,sq]
        q32 = qs.float()
        dq = torch.zeros_like(q32)
        dks, dvs = [], []
        for kc, vc, s in _FlashCore._tiles(qs, k, v, qpos, kv_len,
                                           ctx.causal, ctx.k_chunk):
            p = torch.exp(s - lse[..., None])        # normalised
            p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
            dp = torch.einsum("bkgqd,bskd->bkgqs", dout32, vc.float())
            dvs.append(torch.einsum("bkgqs,bkgqd->bskd", p, dout32))
            ds = p * (dp - d_row[..., None])
            dq = dq + torch.einsum("bkgqs,bskd->bqkgd", ds, kc.float())
            dks.append(torch.einsum("bkgqs,bqkgd->bskd", ds, q32))
        return (dq.to(qs.dtype), torch.cat(dks, dim=1).to(k.dtype),
                torch.cat(dvs, dim=1).to(v.dtype), None, None, None, None)


def flash_attention_train(qc: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, q_offset: int = 0,
                          causal: bool = True, k_chunk: int = 1024,
                          kv_len: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The reference's ``_flash_attention_offset``: flash attention for
    queries at ``q_offset + i`` through :class:`_FlashCore`, keys padded
    to a ``k_chunk`` multiple (the padding masked by ``kv_len``, which
    defaults to every key).  q [B,Sq,H,Dh], k/v [B,Sk,KVH,Dh] ->
    [B,Sq,H,Dh]."""
    b, sq, h, dh = qc.shape
    sk, kvh = k.shape[1], k.shape[2]
    k_chunk = min(k_chunk, max(sk, 128))
    pad = (-sk) % k_chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qs = (qc * torch.tensor(1.0 / math.sqrt(dh), dtype=qc.dtype)
          ).reshape(b, sq, kvh, h // kvh, dh)
    qpos = torch.arange(sq, device=qc.device) + q_offset
    kv_len = (torch.full((b,), sk, dtype=torch.int32, device=qc.device)
              if kv_len is None
              else torch.broadcast_to(kv_len.to(torch.int32), (b,)))
    out = _FlashCore.apply(qs, k, v, qpos, kv_len, causal, k_chunk)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, v.shape[-1])


def _chunked_attention(q, k, v, chunk: int, causal: bool = True,
                       softmax_mode: str = "naive", kv_len=None
                       ) -> torch.Tensor:
    """Q-chunked attention: each chunk of ``chunk`` queries against the
    full keys, so [B,KVH,G,chunk,Sk] is live at once (the reference's
    scan, as a loop)."""
    b, sq, h, dh = q.shape
    pad = (-sq) % chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    outs = [_full_attention_offset(q[:, i:i + chunk], k, v, i, causal,
                                   kv_len, softmax_mode)
            for i in range(0, q.shape[1], chunk)]
    return torch.cat(outs, dim=1)[:, :sq]


def _prefill_qkv_attend(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                        lengths: Optional[torch.Tensor] = None,
                        positions3: Optional[torch.Tensor] = None):
    """The cache-agnostic half of prefill: project q/k/v and run the
    registry's prefill attention (ragged ``lengths`` masked inside it).
    Returns (attn out [B,S,H,Dh], k, v)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions, positions3)
    out = registry.run("attention", q, k, v, q_offset=0, causal=cfg.causal,
                       kv_len=lengths, chunk_size=cfg.chunk_size,
                       chunk_threshold=cfg.chunk_threshold)
    return out, k, v


def _train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg: AttnConfig) -> torch.Tensor:
    """:func:`attention`'s core under grad (see the module note): the
    training kernels where a pin names them or, unpinned, the registry's
    heuristic picks them; else the reference's train path with
    ``cfg.softmax_mode``, which any other pin keeps as well."""
    impl = registry.override_for("attention")
    if impl is None:
        impl = registry.select("attention", **registry.call_facts(
            "attention", q, k, v, causal=cfg.causal, differentiable=True))
    if impl == "cuda_flash_train":
        return registry.run("attention", q, k, v, impl=impl,
                            causal=cfg.causal, differentiable=True)
    if q.shape[1] > cfg.chunk_threshold:
        return _chunked_attention(q, k, v, cfg.chunk_size, cfg.causal,
                                  cfg.softmax_mode)
    return _full_attention_offset(q, k, v, 0, cfg.causal, None,
                                  cfg.softmax_mode)


def attention(p: Attention, x: torch.Tensor, cfg: AttnConfig, *,
              positions3: Optional[torch.Tensor] = None,
              tp: Any = None, sp: bool = False) -> torch.Tensor:
    """Self-attention over x [B,S,d] -> [B,S,d] with no cache, RoPE'd at
    ``arange(S)`` (M-RoPE at ``positions3`` [3,B,S] for the vlm family;
    causal as ``cfg.causal`` says): the training block's and the
    encoder's forward (``repro/models/attention.py:389-406``).

    Under grad it is the training kernels on the card in bf16, else the
    reference's train path (see the module note: ``_full_attention_offset``
    or ``_chunked_attention`` with ``cfg.softmax_mode``).  Without grad it
    goes through the registry's
    ``attention`` family, as a serving prefill does: kernel #1 on the
    card (``causal=False`` for the encoder), the reference's plain choice
    on the CPU.  Under tensor parallelism (``tp``; the config holds the
    rank's heads) ``x`` enters through ``tp.copy_in`` and ``wo``'s partial
    sums reduce over the axis; under sequence parallelism (``sp``) ``x``
    is this rank's slice of the sequence, gathered into the heads
    (``tp.gather_seq``), and the output reduce-scattered back to it."""
    if tp is not None:
        x = tp.gather_seq(x, 1) if sp else tp.copy_in(x)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions, positions3)
    if registry.needs_grad(q, k, v):
        out = _train_attention(q, k, v, cfg)
    else:
        out = registry.run("attention", q, k, v, q_offset=0,
                           causal=cfg.causal, kv_len=None,
                           chunk_size=cfg.chunk_size,
                           chunk_threshold=cfg.chunk_threshold)
    return _out_proj(p, out, tp, sp)


def _new_lengths(lengths: Optional[torch.Tensor], b: int, s: int,
                 device: torch.device) -> torch.Tensor:
    if lengths is not None:
        return lengths
    return torch.full((b,), s, dtype=torch.int32, device=device)


def prefill_into_cache(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                       cache: KVCache,
                       lengths: Optional[torch.Tensor] = None,
                       positions3: Optional[torch.Tensor] = None,
                       tp: Any = None, kv: Optional[KVLayout] = None
                       ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill attention that also writes this segment's K/V into the
    cache (in place, at positions ``[0, S)``).  ``lengths`` [B] int32 marks
    each row's real prompt length: pad keys are masked out of every
    softmax and the cache records the true lengths.  ``positions3``
    [3,B,S] are M-RoPE's position streams (the vlm family).  Under a
    :class:`KVLayout` the attention runs as without one (this rank's
    heads) and the K/V are re-laid into the rank's cut of the cache
    (:func:`relay_kv`); ``kv_shard="headdim"`` is a decode layout and
    prefills nothing."""
    b, s, _ = x.shape
    if kv is not None and kv.head_dim is not None:
        raise ValueError("kv_shard='headdim' is a decode layout: prefill "
                         "under the serving layout, then cut the state")
    out, k, v = _prefill_qkv_attend(p, x, cfg, lengths, positions3)
    if kv is None:
        cache.k[:, :s] = k.to(cache.k.dtype)
        cache.v[:, :s] = v.to(cache.v.dtype)
    else:
        n = cache.k.shape[1]
        cache.k.copy_(relay_kv(k, kv, n).to(cache.k.dtype))
        cache.v.copy_(relay_kv(v, kv, n).to(cache.v.dtype))
    y = _out_proj(p, out, tp)
    return y, cache._replace(length=_new_lengths(lengths, b, s, x.device))


def decode_attention(p: Attention, x: torch.Tensor, cfg: AttnConfig,
                     cache: KVCache, tp: Any = None,
                     kv: Optional[KVLayout] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: x [B,1,d]; row b holds ``length[b]`` past tokens.

    The new token's K/V are written in place at each row's own index
    ``length[b]``; attention spans the whole buffer with positions past
    ``length[b]`` masked (one softmax, the JAX package's dense path).  A
    row already at the buffer's end (an idle scheduler slot, or a
    segment's overshoot) drops its write, as a JAX scatter out of bounds
    does.  Under a :class:`KVLayout` the cache is this rank's cut of the
    reference's decode-state layout: the new token's K/V are written only
    by the rank whose slice holds position ``length[b]`` (and by none at
    the buffer's end), the rank attends its positions ``<= length[b]``
    and the partial softmaxes combine over ``kv.seq``
    (:func:`split_attend`)."""
    kv = kv or KVLayout()
    length = cache.length
    q, k, v = _project_qkv(p, x, cfg, length[:, None],
                           head_dim=kv.head_dim)
    q, k, v = _gather_heads(kv, q, k, v)
    s = cache.k.shape[1]
    lo = kv.lo(s)
    _write_token(cache, k, v, length, lo)
    pos = torch.arange(s, device=x.device)
    valid = ((pos + lo if lo else pos)[None, :]
             <= length[:, None])                     # includes the new token
    out = split_attend(q, cache.k, cache.v, valid, kv)
    out = _own_heads(kv, out, cfg.num_heads)
    return _out_proj(p, out, tp), cache._replace(length=length + 1)


def _write_token(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, lo: int = 0) -> None:
    """Write the new token's K/V [B,1,KVH,Dh] at each row's position
    ``length[b]``, index ``length[b] - lo`` of this cache's buffer (``lo``
    the buffer's first position), in place: a row whose index lies
    outside the buffer (another rank's slice, or past the end) drops its
    write.  At ``lo == 0`` no index falls below the buffer, and the write
    costs what the unsplit cache's does."""
    rows = torch.arange(k.shape[0], device=k.device)
    s = cache.k.shape[1]
    loc = length - lo if lo else length
    idx = loc.clamp(0, s - 1).long()
    own = loc < s
    if lo:
        own = own & (loc >= 0)
    own = own[:, None, None]
    cache.k[rows, idx] = torch.where(own, k[:, 0].to(cache.k.dtype),
                                     cache.k[rows, idx])
    cache.v[rows, idx] = torch.where(own, v[:, 0].to(cache.v.dtype),
                                     cache.v[rows, idx])


def split_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: Optional[torch.Tensor], kv: KVLayout
                 ) -> torch.Tensor:
    """Attention of q [B,Sq,H,Dh] over this rank's keys k/v [B,Sk,KVH,Dh]
    under ``kv`` (``valid`` [B,Sk] masks keys, None: all real): the
    scores' head-dim partial sums all-reduced over ``kv.head_dim``, then a
    softmax over the keys of every rank of ``kv.seq`` from this rank's
    partial max, sum and weighted values, combined in fp32 by one max and
    one sum all-reduce.  Every query must have a real key on some rank.
    Returns [B,Sq,H,Dh] in q's dtype."""
    if kv.head_dim is None:
        scores = _gqa_scores(q, k.to(q.dtype)).float()       # [B,KVH,G,Sq,Sk]
    else:
        scores = kv.head_dim.all_reduce(
            _gqa_scores(q, k.to(q.dtype), 1.0).float())
        scores = scores * (1.0 / math.sqrt(kv.dh_full(q.shape[-1])))
    if valid is not None:
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    if kv.seq is None:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return _gqa_out(probs, v.to(q.dtype))
    mx = kv.seq.all_reduce(scores.amax(-1, keepdim=True), op="max")
    e = torch.exp(scores - mx)
    if valid is not None:
        e = torch.where(valid[:, None, None, None, :], e, 0.0)
    num = _gqa_out(e, v.float())                             # [B,Sq,H,Dh]
    b, kvh, g, sq, _ = e.shape
    den = e.sum(-1).permute(0, 3, 1, 2).reshape(b, sq, kvh * g, 1)
    both = kv.seq.all_reduce(torch.cat([num, den], dim=-1))
    return (both[..., :-1] / both[..., -1:]).to(q.dtype)


def _gather_heads(kv: KVLayout, *ts: torch.Tensor):
    """Every head of a rank's q/k/v when its weights split heads and its
    cache holds them all (``kv.heads``); the tensors themselves else."""
    if kv.heads is None:
        return ts
    return tuple(kv.heads.all_gather(t, dim=2) for t in ts)


def _own_heads(kv: KVLayout, out: torch.Tensor, h: int) -> torch.Tensor:
    """This rank's ``h`` heads of a gathered output (for ``wo``)."""
    if kv.heads is None:
        return out
    return out.narrow(2, kv.heads.index * h, h)


def relay_kv(t: torch.Tensor, kv: Optional[KVLayout],
             s_local: int) -> torch.Tensor:
    """A prefill's K or V [B,S,KVH,Dh] in the engine's layout (this rank's
    kv heads) re-laid into this rank's cut of the decode-state layout:
    gathered over ``kv.heads`` (a declared all-gather), then cut to the
    rank's ``s_local`` positions of the sequence (zeros past ``S``)."""
    if kv is None:
        return t
    (t,) = _gather_heads(kv, t)
    lo = kv.lo(s_local)
    part = t[:, lo:lo + s_local]
    if part.shape[1] < s_local:
        pad = t.new_zeros((t.shape[0], s_local - part.shape[1])
                          + tuple(t.shape[2:]))
        part = torch.cat([part, pad], dim=1)
    return part


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


def quantize_kv_rows(seq: torch.Tensor, tp: Any = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token-row int8: seq [..., KVH, Dh] -> (codes int8,
    scale f32 [...]) with scale = amax over the trailing [KVH, Dh] / 127.
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
    codes equal the JAX package's bit for bit.  Under tensor parallelism
    (``tp``, the model axis) a rank holds only its kv heads of the row:
    the amax is maxed over the axis, so the scale is the whole row's and
    every rank's codes are the unsharded codes of its heads."""
    f = seq.float()
    amax = f.abs().amax(dim=(-2, -1))
    if tp is not None:
        amax = tp.all_reduce(amax, op="max")
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
                           lengths: torch.Tensor,
                           positions3: Optional[torch.Tensor] = None):
    """Prefill of a DIVERGENT SUFFIX against an already-resident prefix.

    Query token i of row b sits at absolute position ``prefix_len[b]+i``:
    it attends every resident prefix key (gathered from the row's pages,
    dequantized if int8) plus the causal span of the suffix itself.  The
    JAX package runs this as plain array code, not a Pallas kernel, and so
    does the port, on both devices.  ``positions3`` (the vlm family) are
    the suffix's own M-RoPE streams: the caller computes them from the
    suffix tokens alone, so they restart at 0, as the JAX package's do
    (``repro/models/lm.py:478``).  Returns (attn out, k_suffix,
    v_suffix)."""
    b, s, _ = x.shape
    t = torch.arange(s, device=x.device)
    positions = prefix_len[:, None] + t[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, positions3)
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
                             prefix_len: Optional[torch.Tensor] = None,
                             positions3: Optional[torch.Tensor] = None,
                             tp: Any = None
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
        out, k, v = _prefill_qkv_attend(p, x, cfg, lengths, positions3)
        new_len = suffix_len
        start = torch.zeros((b,), dtype=torch.int32, device=x.device)
    else:
        out, k, v = _suffix_prefill_attend(p, x, cfg, cache, prefix_len,
                                           suffix_len, positions3)
        new_len = prefix_len + suffix_len
        start = prefix_len
    if cache.quantized:
        k_codes, k_sc = quantize_kv_rows(k, tp)
        v_codes, v_sc = quantize_kv_rows(v, tp)
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
    y = _out_proj(p, out, tp)
    return y, cache._replace(length=new_len.to(torch.int32))


def paged_decode_attention_token(p: Attention, x: torch.Tensor,
                                 cfg: AttnConfig, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 length: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None,
                                 tp: Any = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """One-token decode against READ-ONLY pages (one layer's pool).

    Attention reads only the pages each row's table lists, through the
    registry's ``paged_decode`` family (its int8 impls when
    ``k_scale``/``v_scale`` are given); the new token's K/V
    ``[B,1,KVH,Dh]`` are returned UNQUANTIZED for the caller to write
    into its page."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, length[:, None])
    kvh, dh = cfg.num_kv_heads, cfg.head_dim
    q4 = q.reshape(b, kvh, cfg.num_heads // kvh, dh)
    k_new, v_new = k.reshape(b, kvh, dh), v.reshape(b, kvh, dh)
    kw = {} if k_scale is None else dict(k_scale=k_scale, v_scale=v_scale)
    out = registry.run("paged_decode", q4, k_pages, v_pages, page_table,
                       length, k_new, v_new, **kw)
    return _out_proj(p, out.reshape(b, 1, cfg.num_heads, dh), tp), k, v
