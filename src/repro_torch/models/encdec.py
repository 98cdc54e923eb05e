"""Encoder-decoder blocks (seamless-m4t-medium, arXiv:2308.11596).

Port of ``repro/models/encdec.py`` for serving.  Backbone only: the
speech frontend is a stub, and the caller passes precomputed frame
embeddings ``[B, S_src, D]`` as the encoder's input.  Encoder blocks run
bidirectional self-attention and a GELU FFN; decoder blocks run causal
self-attention into a dense KV cache, cross-attention over the encoder's
memory and a GELU FFN; every norm is a LayerNorm.

Cross-attention carries no RoPE (positions live in the self-attention)
and ignores the cross block's biases, as the JAX package does: the
memory's K/V are projected once at prefill (:func:`cross_memory`) and
every query attends all of them with a plain softmax and no mask
(:func:`_cross_attend`, ``repro/models/encdec.py:123-141``; no Pallas
kernel there either).  The encoder's self-attention goes through the
registry's ``attention`` family (kernel #1 with ``causal=False`` on the
card), where the JAX package runs plain array code: the route departs,
the result does not.

**Tensor parallelism** (``CrossAttnBlockConfig.tp``; the rank's config
holds its heads, and ``d_ff / m`` under ``tp_mlp`` where the axis
divides it).  Self-attention, cross-attention and the memory K/V split
by heads (every rank projects its kv heads of the memory from the whole
encoder output), the GELU MLP over ``d_ff`` (``w_up``, ``b_up`` column-
parallel, ``w_down`` row-parallel); the row-parallel output bias
``b_down`` is added once, after the reduce.  Under autograd every
replicated tensor enters a split region through ``copy_in``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import AttnConfig, KVCache
from repro_torch.models.layers import (cast, gelu_mlp, layer_norm,
                                      truncated_normal_)
from repro_torch.models.transformer import LayerNorm

__all__ = ["CrossAttnBlockConfig", "GeluMLP", "EncoderBlock", "DecoderBlock",
           "cross_config", "cross_memory", "apply_encoder_block",
           "apply_decoder_block", "apply_decoder_block_prefill",
           "apply_decoder_block_decode", "encoder_block_specs",
           "decoder_block_specs", "memory_specs"]


class CrossAttnBlockConfig(NamedTuple):
    attn: AttnConfig              # self-attention config (causal: decoder)
    d_ff: int
    norm_eps: float = 1e-5
    # tensor parallel (the rank's view): the model axis the heads split
    # over, and the one d_ff splits over (None when it stays whole)
    tp: Optional[Any] = None
    tp_mlp: Optional[Any] = None
    # the decode-state layouts of the self-attention caches and of the
    # cross-attention memory (``attention.KVLayout``s, each from its own
    # leaf's spec; None: the engine's kv-head split)
    kv: Optional[Any] = None
    mem_kv: Optional[Any] = None


def _ln_specs() -> dict:
    return {"scale": ("act_embed",), "bias": ("act_embed",)}


def _mlp_specs() -> dict:
    return {"w_up": ("embed", "ff"), "b_up": ("ff",),
            "w_down": ("ff", "embed"), "b_down": ("act_embed",)}


def encoder_block_specs(cfg: CrossAttnBlockConfig) -> dict:
    """Logical axes of one encoder block's weights (the reference's
    ``encoder_block_specs``, ``repro/models/encdec.py:63-72``)."""
    return {"ln1": _ln_specs(), "attn": attn_mod.attn_specs(cfg.attn),
            "ln2": _ln_specs(), "mlp": _mlp_specs()}


def decoder_block_specs(cfg: CrossAttnBlockConfig) -> dict:
    """Logical axes of one decoder block's weights (the reference's
    ``decoder_block_specs``, ``repro/models/encdec.py:110-121``)."""
    return {"ln1": _ln_specs(), "attn": attn_mod.attn_specs(cfg.attn),
            "ln_cross": _ln_specs(),
            "cross": attn_mod.attn_specs(cfg.attn),
            "ln2": _ln_specs(), "mlp": _mlp_specs()}


def memory_specs() -> tuple:
    """Logical axes of the cross memory's K and V (``repro/models/
    encdec.py:131-133``)."""
    return (("batch", "seq", "kv_heads", "head_dim"),
            ("batch", "seq", "kv_heads", "head_dim"))


def cross_config(cfg: CrossAttnBlockConfig) -> AttnConfig:
    """The cross-attention's config: not causal, no RoPE."""
    return cfg.attn._replace(causal=False, use_rope=False)


class GeluMLP(nn.Module):
    """``w_up`` [d, f], ``b_up`` [f], ``w_down`` [f, d], ``b_down`` [d]."""

    def __init__(self, d: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.w_up = param(d, d_ff)
        self.b_up = param(d_ff)
        self.w_down = param(d_ff, d)
        self.b_down = param(d)

    def init(self, generator: Optional[torch.Generator]) -> None:
        """Truncated normals with std 1/sqrt(d) and 1/sqrt(d_ff); zero
        biases."""
        d, d_ff = self.w_up.shape
        truncated_normal_(self.w_up, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.w_down, 1.0 / math.sqrt(d_ff), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_mlp(x, self.w_up, self.b_up, self.w_down, self.b_down)


class EncoderBlock(nn.Module):
    """``init_encoder_block``'s tree: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: CrossAttnBlockConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d = cfg.attn.d_model
        self.ln1 = LayerNorm(d, dtype, device)
        self.attn = attn_mod.Attention(cfg.attn, dtype, device)
        self.ln2 = LayerNorm(d, dtype, device)
        self.mlp = GeluMLP(d, cfg.d_ff, dtype, device)

    def init(self, generator: Optional[torch.Generator]) -> None:
        self.attn.init(generator)
        self.mlp.init(generator)


class DecoderBlock(nn.Module):
    """``init_decoder_block``'s tree: ``ln1``, ``attn``, ``ln_cross``,
    ``cross``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: CrossAttnBlockConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d = cfg.attn.d_model
        self.ln1 = LayerNorm(d, dtype, device)
        self.attn = attn_mod.Attention(cfg.attn, dtype, device)
        self.ln_cross = LayerNorm(d, dtype, device)
        self.cross = attn_mod.Attention(cross_config(cfg), dtype, device)
        self.ln2 = LayerNorm(d, dtype, device)
        self.mlp = GeluMLP(d, cfg.d_ff, dtype, device)

    def init(self, generator: Optional[torch.Generator]) -> None:
        self.attn.init(generator)
        self.cross.init(generator)
        self.mlp.init(generator)


def _ln(x: torch.Tensor, ln: LayerNorm, cfg: CrossAttnBlockConfig
        ) -> torch.Tensor:
    return layer_norm(x, ln.scale, ln.bias, cfg.norm_eps)


def _mlp(p: GeluMLP, x: torch.Tensor, cfg: CrossAttnBlockConfig
         ) -> torch.Tensor:
    """The GELU MLP; column- then row-parallel under ``cfg.tp_mlp``, its
    output bias added once after the reduce."""
    tp = cfg.tp_mlp
    if tp is None:
        return p(x)
    y = gelu_mlp(tp.copy_in(x), p.w_up, p.b_up, p.w_down, None)
    return tp.all_reduce(y) + cast(p.b_down, y.dtype)


def apply_encoder_block(p: EncoderBlock, x: torch.Tensor,
                        cfg: CrossAttnBlockConfig) -> torch.Tensor:
    """One encoder block over x [B,S,d] (``cfg.attn.causal`` is False for
    the encoder)."""
    h = x + attn_mod.attention(p.attn, _ln(x, p.ln1, cfg), cfg.attn,
                               tp=cfg.tp)
    return h + _mlp(p.mlp, _ln(h, p.ln2, cfg), cfg)


def cross_memory(p_cross: attn_mod.Attention, enc_out: torch.Tensor,
                 cfg: AttnConfig, tp: Any = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder memory's K/V [B,S_src,KVH,Dh] for one decoder layer,
    computed once a sequence (cached for decode); on a model axis this
    rank's kv heads, from the whole encoder output."""
    if tp is not None:
        enc_out = tp.copy_in(enc_out)
    b, s, d = enc_out.shape
    shape = (b, s, cfg.num_kv_heads, cfg.head_dim)
    dt = enc_out.dtype
    return ((enc_out @ cast(p_cross.wk, dt).reshape(d, -1)).view(shape),
            (enc_out @ cast(p_cross.wv, dt).reshape(d, -1)).view(shape))


def _cross_attend(p_cross: attn_mod.Attention, x: torch.Tensor,
                  mem_k: torch.Tensor, mem_v: torch.Tensor,
                  cfg: AttnConfig, tp: Any = None,
                  kv: Optional[attn_mod.KVLayout] = None) -> torch.Tensor:
    """Queries of x [B,S,d] over every memory position: no RoPE, no mask,
    no bias; on a model axis this rank's heads, ``wo`` row-parallel.
    Under a :class:`~repro_torch.models.attention.KVLayout` the memory is
    this rank's cut of it (a decode step's state): the queries attend it
    and the partials combine (:func:`~repro_torch.models.attention.
    split_attend`)."""
    if tp is not None:
        x = tp.copy_in(x)
    b, s, d = x.shape
    q = (x @ cast(p_cross.wq, x.dtype).reshape(d, -1)).view(
        b, s, cfg.num_heads, cfg.head_dim)
    kv = kv or attn_mod.KVLayout()
    (q,) = attn_mod._gather_heads(kv, q)
    out = attn_mod._own_heads(
        kv, attn_mod.split_attend(q, mem_k, mem_v, None, kv), cfg.num_heads)
    return attn_mod._out_proj(p_cross, out, tp)


def _decoder_tail(p: DecoderBlock, h: torch.Tensor, mem_k: torch.Tensor,
                  mem_v: torch.Tensor, cfg: CrossAttnBlockConfig,
                  kv: Optional[attn_mod.KVLayout] = None) -> torch.Tensor:
    """The cross-attention and FFN halves of a decoder block (``kv``: the
    layout of a decode state's memory)."""
    h = h + _cross_attend(p.cross, _ln(h, p.ln_cross, cfg), mem_k, mem_v,
                          cfg.attn, cfg.tp, kv)
    return h + _mlp(p.mlp, _ln(h, p.ln2, cfg), cfg)


def apply_decoder_block(p: DecoderBlock, x: torch.Tensor,
                        mem_k: torch.Tensor, mem_v: torch.Tensor,
                        cfg: CrossAttnBlockConfig) -> torch.Tensor:
    """One decoder block over x [B,S,d] with no cache (the forward)."""
    h = x + attn_mod.attention(p.attn, _ln(x, p.ln1, cfg), cfg.attn,
                               tp=cfg.tp)
    return _decoder_tail(p, h, mem_k, mem_v, cfg)


def apply_decoder_block_prefill(p: DecoderBlock, x: torch.Tensor,
                                mem_k: torch.Tensor, mem_v: torch.Tensor,
                                cache: KVCache, cfg: CrossAttnBlockConfig
                                ) -> Tuple[torch.Tensor, KVCache]:
    """One decoder block's prefill, its self-attention K/V written into
    ``cache`` (one layer's view, in place; ``LM._encdec_prefill``'s
    ``dec_one``, ``repro/models/lm.py:567-583``)."""
    a, new_cache = attn_mod.prefill_into_cache(
        p.attn, _ln(x, p.ln1, cfg), cfg.attn, cache, tp=cfg.tp, kv=cfg.kv)
    return _decoder_tail(p, x + a, mem_k, mem_v, cfg), new_cache


def apply_decoder_block_decode(p: DecoderBlock, x: torch.Tensor,
                               mem_k: torch.Tensor, mem_v: torch.Tensor,
                               cache: KVCache, cfg: CrossAttnBlockConfig
                               ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode of a decoder block over its dense cache."""
    a, new_cache = attn_mod.decode_attention(
        p.attn, _ln(x, p.ln1, cfg), cfg.attn, cache, tp=cfg.tp, kv=cfg.kv)
    return _decoder_tail(p, x + a, mem_k, mem_v, cfg, cfg.mem_kv), new_cache
