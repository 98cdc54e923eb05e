"""The causal LM: config, weights, prefill and decode, dense family.

Port of ``repro/models/lm.py``.  :class:`LMConfig` carries every field of
the JAX config so later slices port their configs verbatim; :class:`LM`
implements ``family="dense"`` serving (embed -> transformer blocks -> norm
-> LM head).  Weights are stored once in the compute dtype; the JAX package
keeps fp32 masters and casts at every use, which gives the same numbers.

``LM`` runs on ``cuda`` unless it is built with ``device="cpu"``; with no
GPU and no explicit request it raises (:func:`repro_torch.device.
resolve_device`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.attention import AttnConfig
from repro_torch.models.layers import rms_norm, truncated_normal_
from repro_torch.models.transformer import BlockConfig

__all__ = ["LMConfig", "LM"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                  # dense | moe | vlm | xlstm | hybrid | encdec
    vocab: int
    d_model: int
    n_layers: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    # --- moe ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff_shared: int = 0
    # --- vlm ---
    mrope_sections: Tuple[int, int, int] = ()
    n_patches: int = 0           # patch positions at sequence start (stub)
    patch_grid: Tuple[int, int] = (16, 16)
    # --- hybrid (zamba2) ---
    ssm_state: int = 64
    ssm_head_dim: int = 64
    attn_every: int = 6
    # --- encdec ---
    enc_layers: int = 0
    src_ratio: int = 4           # S_src = S // src_ratio (audio downsampling)
    # --- scan/kernels ---
    chunk_size: int = 256        # attention q-chunk / ssd chunk
    attn_chunk_threshold: int = 4096
    attn_softmax: str = "naive"  # "naive" (paper-faithful) | "fused" (§Perf)

    # ------------------------------------------------------------ derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def attn_config(self, causal: bool = True) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias, causal=causal,
            rope_theta=self.rope_theta,
            mrope_sections=self.mrope_sections or None,
            chunk_size=self.chunk_size,
            chunk_threshold=self.attn_chunk_threshold,
            softmax_mode=self.attn_softmax)

    def block_config(self) -> BlockConfig:
        """The block config (the MoE config itself is not ported yet)."""
        return BlockConfig(
            attn=self.attn_config(), d_ff=self.d_ff, norm=self.norm,
            mlp="moe" if self.family == "moe" else "swiglu",
            norm_eps=self.norm_eps)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.table = nn.Parameter(torch.zeros((vocab, d), dtype=dtype,
                                              device=device),
                                  requires_grad=False)


class LMHead(nn.Module):
    def __init__(self, d: int, vocab: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((d, vocab), dtype=dtype,
                                          device=device),
                              requires_grad=False)


State = Dict[str, Any]


class LM(nn.Module):
    """The dense causal LM.  Parameter names mirror the JAX params tree
    (``embed.table``, ``final_norm.scale``, ``blocks.{i}.attn.wq``, ...),
    which is what :mod:`repro_torch.bridge` maps onto."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype = torch.bfloat16,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP.md, "
                f"queue 1 item 12); this slice serves family='dense'")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        dev = self.device
        bc = cfg.block_config()
        self.embed = Embed(cfg.vocab, cfg.d_model, dtype, dev)
        self.final_norm = tf_mod.RMSNorm(cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            self.lm_head = LMHead(cfg.d_model, cfg.vocab, dtype, dev)
        self.blocks = nn.ModuleList(tf_mod.Block(bc, dtype, dev)
                                    for _ in range(cfg.n_layers))

    # ================================================================ init
    def init(self, generator: Optional[torch.Generator] = None) -> "LM":
        """Fill the weights in place from ``LM.init``'s distributions
        (truncated normals on +-2 sigma; the embedding at sigma 1).  The
        generator must live on the model's device.  Returns ``self``."""
        cfg = self.cfg
        truncated_normal_(self.embed.table, 1.0, generator)
        if not cfg.tie_embeddings:
            truncated_normal_(self.lm_head.w, 1.0 / math.sqrt(cfg.d_model),
                              generator)
        for blk in self.blocks:
            blk.init(generator)
        return self

    # ============================================================ backbone
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed.table[tokens.long()]

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm.scale, self.cfg.norm_eps)
        w = (self.embed.table.T if self.cfg.tie_embeddings
             else self.lm_head.w)
        return x @ w

    # ============================================================== serve
    def init_decode_state(self, batch_size: int, max_seq: int,
                          page_size: int = 0,
                          num_pages: Optional[int] = None,
                          table_width: Optional[int] = None,
                          kv_dtype: Optional[torch.dtype] = None) -> State:
        """Fresh decode state.  ``page_size > 0`` builds PAGED KV caches: a
        pool of ``num_pages`` pages shared by all rows, addressed through
        per-row page tables of ``table_width`` logical pages (defaults
        provision the dense worst case).  ``kv_dtype`` overrides the page
        storage dtype (``torch.int8`` = quantized pages with per-token
        scales; paged caches only).  Caches carry a leading layers axis."""
        cfg = self.cfg
        ac = cfg.attn_config()
        if kv_dtype is not None and page_size <= 0:
            raise ValueError("kv_dtype needs a paged KV cache "
                             "(page_size > 0)")
        if page_size > 0:
            nppr = -(-max_seq // page_size)
            cache = attn_mod.init_paged_kv_cache(
                batch_size, num_pages or batch_size * nppr + 1,
                table_width or nppr, page_size, ac, self.dtype, self.device,
                layers=cfg.n_layers, kv_dtype=kv_dtype)
        else:
            cache = attn_mod.init_kv_cache(batch_size, max_seq, ac,
                                           self.dtype, self.device,
                                           layers=cfg.n_layers)
        return {"caches": cache}

    def prefill(self, batch: Dict[str, torch.Tensor], state: State
                ) -> Tuple[torch.Tensor, State]:
        """Process the prompt; returns (last-token logits [B,V], state).

        ``batch["lengths"]`` [B] int32 (optional) marks each row's true
        prompt length inside right-padded ``tokens``: pad keys are masked
        out of every softmax, the cache records per-row lengths, and the
        returned logits are each row's LAST REAL token's.
        ``batch["prefix_len"]`` [B] int32 (paged caches) marks a resident
        shared prefix: ``tokens`` are the divergent suffix, prefilled at
        positions ``prefix_len + i`` against the prefix pages."""
        tokens = batch["tokens"]
        lengths = batch.get("lengths")
        x = self._embed(tokens)
        x, caches = tf_mod.apply_stack_decode(
            self.blocks, x, self.cfg.block_config(), state["caches"],
            block_fn=functools.partial(tf_mod.apply_block_prefill,
                                       lengths=lengths,
                                       prefix_len=batch.get("prefix_len")))
        if lengths is not None:
            idx = torch.clamp(lengths.long() - 1, min=0)
            x_last = x[torch.arange(x.shape[0], device=x.device), idx]
        else:
            x_last = x[:, -1]
        return self._head(x_last), {"caches": caches}

    def decode_step(self, tokens: torch.Tensor, state: State
                    ) -> Tuple[torch.Tensor, State]:
        """tokens: [B,1] -> (logits [B,V], new state)."""
        x = self._embed(tokens)
        x, caches = tf_mod.apply_stack_decode(
            self.blocks, x, self.cfg.block_config(), state["caches"])
        return self._head(x)[:, 0], {"caches": caches}
