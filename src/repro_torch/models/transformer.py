"""Pre-norm transformer blocks and the decode-time stack, dense family.

Port of ``repro/models/transformer.py`` for serving: one :class:`Block`
module per layer (the JAX package stacks them on a leading layers axis and
scans; here a Python loop walks an ``nn.ModuleList``), the prefill block,
the dense decode block, and the paged decode stack.  The MoE MLP and the
training-time ``apply_stack`` wait for later slices.

KV caches carry a leading layers axis; each layer reads and writes its own
slice IN PLACE (the JAX package threads the stacked cache through a scan
carry and relies on while-loop aliasing for the same effect).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import (AttnConfig, KVCache, PagedKVCache)
from repro_torch.models.layers import rms_norm, swiglu, truncated_normal_

__all__ = ["BlockConfig", "Block", "apply_block_prefill",
           "apply_block_decode", "apply_stack_decode"]


class BlockConfig(NamedTuple):
    attn: AttnConfig
    d_ff: int
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    mlp: str = "swiglu"          # swiglu | moe
    moe: Optional[object] = None
    norm_eps: float = 1e-6


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)


class SwiGLU(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.w_gate = param(d, d_ff)
        self.w_up = param(d, d_ff)
        self.w_down = param(d_ff, d)


class Block(nn.Module):
    """One pre-norm block's weights (``init_block``'s tree, swiglu MLP)."""

    def __init__(self, cfg: BlockConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        if cfg.norm != "rmsnorm" or cfg.mlp != "swiglu":
            raise NotImplementedError(
                f"norm={cfg.norm!r} mlp={cfg.mlp!r} blocks are not ported "
                f"yet (ROADMAP.md, queue 1 item 12: other families)")
        d = cfg.attn.d_model
        self.ln1 = RMSNorm(d, dtype, device)
        self.attn = attn_mod.Attention(cfg.attn, dtype, device)
        self.ln2 = RMSNorm(d, dtype, device)
        self.mlp = SwiGLU(d, cfg.d_ff, dtype, device)

    def init(self, generator: Optional[torch.Generator]) -> None:
        """``init_block``'s distributions (norm scales stay 1)."""
        self.attn.init(generator)
        d, d_ff = self.mlp.w_gate.shape
        truncated_normal_(self.mlp.w_gate, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.mlp.w_up, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.mlp.w_down, 1.0 / math.sqrt(d_ff), generator)


def _norm(x: torch.Tensor, ln: RMSNorm, cfg: BlockConfig) -> torch.Tensor:
    return rms_norm(x, ln.scale, cfg.norm_eps)


def _block_mlp(p: Block, h: torch.Tensor, cfg: BlockConfig) -> torch.Tensor:
    """The post-attention MLP half of a block."""
    mp = p.mlp
    return swiglu(_norm(h, p.ln2, cfg), mp.w_gate, mp.w_up, mp.w_down)


def apply_block_prefill(p: Block, x: torch.Tensor, cfg: BlockConfig,
                        cache: Union[KVCache, PagedKVCache], *,
                        lengths: Optional[torch.Tensor] = None,
                        prefix_len: Optional[torch.Tensor] = None):
    """Prefill one block into a dense or paged cache (one layer's view);
    the attention compute is identical, only the K/V landing zone
    differs.  ``prefix_len`` [B] (paged only) marks a resident shared
    prefix: ``x`` is the divergent suffix."""
    paged = isinstance(cache, PagedKVCache)
    if prefix_len is not None and not paged:
        raise ValueError("prefix_len requires a paged KV cache "
                         "(dense prefill has no resident prefix)")
    if paged:
        a, new_cache = attn_mod.prefill_into_paged_cache(
            p.attn, _norm(x, p.ln1, cfg), cfg.attn, cache, lengths=lengths,
            prefix_len=prefix_len)
    else:
        a, new_cache = attn_mod.prefill_into_cache(
            p.attn, _norm(x, p.ln1, cfg), cfg.attn, cache, lengths=lengths)
    h = x + a
    return h + _block_mlp(p, h, cfg), new_cache


def apply_block_decode(p: Block, x: torch.Tensor, cfg: BlockConfig,
                       cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Dense one-token decode of one block (``decode_attention``)."""
    a, new_cache = attn_mod.decode_attention(p.attn, _norm(x, p.ln1, cfg),
                                             cfg.attn, cache)
    h = x + a
    return h + _block_mlp(p, h, cfg), new_cache


def apply_stack_decode(blocks: nn.ModuleList, x: torch.Tensor,
                       cfg: BlockConfig,
                       caches: Union[KVCache, PagedKVCache], *,
                       block_fn: Callable = apply_block_decode):
    """Run every block over a stacked cache (leading layers axis); returns
    (y, caches with their new length).

    ``block_fn`` is called as ``block_fn(block, x, cfg, layer_cache)`` on
    each layer's view of the cache (``LM.prefill`` passes
    :func:`apply_block_prefill`).  The default one-token decode over a
    PAGED cache takes its own path: the paged kernel plus a one-slot page
    write per layer."""
    if isinstance(caches, PagedKVCache) and block_fn is apply_block_decode:
        return _apply_stack_decode_paged(blocks, x, cfg, caches)
    layer_view = (_paged_layer if isinstance(caches, PagedKVCache)
                  else _dense_layer)
    new = caches
    for i, p in enumerate(blocks):
        x, new = block_fn(p, x, cfg, layer_view(caches, i))
    return x, caches._replace(length=new.length)


def _dense_layer(caches: KVCache, i: int) -> KVCache:
    return KVCache(k=caches.k[i], v=caches.v[i], length=caches.length)


def _paged_layer(caches: PagedKVCache, i: int) -> PagedKVCache:
    q8 = caches.quantized
    return PagedKVCache(k_pages=caches.k_pages[i], v_pages=caches.v_pages[i],
                        page_table=caches.page_table, length=caches.length,
                        k_scale=caches.k_scale[i] if q8 else None,
                        v_scale=caches.v_scale[i] if q8 else None)


def _apply_stack_decode_paged(blocks: nn.ModuleList, x: torch.Tensor,
                              cfg: BlockConfig, caches: PagedKVCache
                              ) -> Tuple[torch.Tensor, PagedKVCache]:
    """One-token decode through every block over PAGED caches.

    The page table and lengths are shared by all layers.  Each layer
    attends its read-only pool slice through the paged kernel, then writes
    the new token into ONE page slot: row b's token lands in physical page
    ``pt[b, length[b] // ps]`` at offset ``length[b] % ps`` (the engine
    plans that page before the call).  An int8 cache attends with the
    layer's scales and quantizes the new token's K/V row on the write
    (codes plus one scale per row); the token itself was folded into the
    attention in floating point."""
    b = x.shape[0]
    length, pt = caches.length, caches.page_table
    ps = caches.page_size
    rows = torch.arange(b, device=x.device)
    col = torch.clamp(length // ps, max=pt.shape[1] - 1).long()
    page = pt[rows, col].long()
    off = (length % ps).long()
    for i, p in enumerate(blocks):
        layer = _paged_layer(caches, i)
        a, k_t, v_t = attn_mod.paged_decode_attention_token(
            p.attn, _norm(x, p.ln1, cfg), cfg.attn, layer.k_pages,
            layer.v_pages, pt, length, k_scale=layer.k_scale,
            v_scale=layer.v_scale)
        h = x + a
        x = h + _block_mlp(p, h, cfg)
        k_t, v_t = k_t[:, 0], v_t[:, 0]
        if layer.quantized:
            k_t, k_s = attn_mod.quantize_kv_rows(k_t)
            v_t, v_s = attn_mod.quantize_kv_rows(v_t)
            layer.k_scale[page, off] = k_s
            layer.v_scale[page, off] = v_s
        layer.k_pages[page, off] = k_t.to(layer.k_pages.dtype)
        layer.v_pages[page, off] = v_t.to(layer.v_pages.dtype)
    return x, caches._replace(length=length + 1)
