"""The causal LM: config, weights, prefill and decode, dense and hybrid.

Port of ``repro/models/lm.py``.  :class:`LMConfig` carries every field of
the JAX config so later slices port their configs verbatim; :class:`LM`
implements serving for ``family="dense"`` (embed -> transformer blocks ->
norm -> LM head) and ``family="hybrid"`` (zamba2: Mamba2 blocks with ONE
weight-shared transformer block after every ``attn_every``-th, each
application with its own dense KV cache).  Weights are stored once in the
compute dtype; the JAX package keeps fp32 masters and casts at every use,
which gives the same numbers.  The Mamba2 decay leaves ``A_log``,
``dt_bias`` and ``D`` stay fp32 (:data:`repro_torch.models.ssm.
FP32_LEAVES`), as the JAX package computes with them in fp32.

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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.attention import AttnConfig, KVCache
from repro_torch.models.layers import rms_norm, truncated_normal_
from repro_torch.models.ssm import Mamba2Config
from repro_torch.models.transformer import BlockConfig

__all__ = ["LMConfig", "LM", "PORTED_FAMILIES"]

#: families ``LM`` serves so far (the rest: ROADMAP.md, queue 1 item 12)
PORTED_FAMILIES = ("dense", "hybrid")


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

    def mamba_config(self) -> Mamba2Config:
        return Mamba2Config(d_model=self.d_model, d_state=self.ssm_state,
                            head_dim=self.ssm_head_dim,
                            chunk_size=self.chunk_size,
                            norm_eps=self.norm_eps)


def _hybrid_groups(n_layers: int, every: int):
    """Mamba layer ranges [lo, hi) each followed by the shared block."""
    out = []
    lo = 0
    while lo < n_layers:
        out.append((lo, min(lo + every, n_layers)))
        lo += every
    return out


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
    """The causal LM.  Parameter names mirror the JAX params tree
    (``embed.table``, ``final_norm.scale``, ``blocks.{i}.attn.wq``,
    ``mamba.{i}.in_proj``, ``shared_attn.attn.wq``, ...), which is what
    :mod:`repro_torch.bridge` maps onto."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype = torch.bfloat16,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP.md, "
                f"queue 1 item 12); ported: {PORTED_FAMILIES}")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        dev = self.device
        bc = cfg.block_config()
        self.embed = Embed(cfg.vocab, cfg.d_model, dtype, dev)
        self.final_norm = tf_mod.RMSNorm(cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            self.lm_head = LMHead(cfg.d_model, cfg.vocab, dtype, dev)
        if cfg.family == "hybrid":
            mc = cfg.mamba_config()
            self.mamba = nn.ModuleList(ssm_mod.Mamba2Block(mc, dtype, dev)
                                       for _ in range(cfg.n_layers))
            self.shared_attn = tf_mod.Block(bc, dtype, dev)
        else:
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
        if cfg.family == "hybrid":
            for blk in self.mamba:
                blk.init(generator)
            self.shared_attn.init(generator)
        else:
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
        scales; paged caches only).  Caches carry a leading layers axis.

        The hybrid family's state is ``{"mamba": {"ssd": (C [L,B,H,N,P],
        n [L,B,H,N]), "conv": [L,B,K-1,C']}, "attn_caches": KVCache with
        k/v [G,B,S,KVH,Dh]}``: fp32 recurrent state, KV in the model
        dtype, one cache per shared-block application, and no pages."""
        cfg = self.cfg
        ac = cfg.attn_config()
        if page_size > 0 and cfg.family != "dense":
            raise ValueError(
                f"paged KV caches need an attention-cache family, not "
                f"{cfg.family!r} (recurrent states have no pages to swap)")
        if kv_dtype is not None and page_size <= 0:
            raise ValueError("kv_dtype needs a paged KV cache "
                             "(page_size > 0)")
        if cfg.family == "hybrid":
            groups = _hybrid_groups(cfg.n_layers, cfg.attn_every)
            return {"mamba": ssm_mod.init_mamba2_state(
                        batch_size, cfg.mamba_config(), self.device,
                        layers=cfg.n_layers),
                    "attn_caches": attn_mod.init_kv_cache(
                        batch_size, max_seq, ac, self.dtype, self.device,
                        layers=len(groups))}
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

    def prefill(self, batch: Dict[str, torch.Tensor], state: State,
                all_logits: bool = False) -> Tuple[torch.Tensor, State]:
        """Process the prompt; returns (last-token logits [B,V], state).

        ``batch["lengths"]`` [B] int32 (optional) marks each row's true
        prompt length inside right-padded ``tokens``: pad keys are masked
        out of every softmax, the cache records per-row lengths, and the
        returned logits are each row's LAST REAL token's.
        ``batch["prefix_len"]`` [B] int32 (paged caches) marks a resident
        shared prefix: ``tokens`` are the divergent suffix, prefilled at
        positions ``prefix_len + i`` against the prefix pages.

        The hybrid family cannot mask a pad out of a running recurrent
        state, so it takes neither: every row is prefilled at the full
        width of ``tokens`` (serve equal lengths, or one row at a time).

        ``all_logits=True`` returns the head over every position, [B,S,V],
        instead of the last token's: the verify of speculative decoding
        (every suffix position's next-token distribution from one forward
        pass)."""
        tokens = batch["tokens"]
        lengths = batch.get("lengths")
        x = self._embed(tokens)
        if self.cfg.family == "hybrid":
            if lengths is not None or batch.get("prefix_len") is not None:
                raise ValueError(
                    "the hybrid family prefills equal-length rows: it takes "
                    "no lengths or prefix_len (a recurrent state cannot "
                    "mask a pad)")
            x, new_state = self._hybrid_stack(x, state, prefill=True)
            return self._head(x if all_logits else x[:, -1]), new_state
        x, caches = tf_mod.apply_stack_decode(
            self.blocks, x, self.cfg.block_config(), state["caches"],
            block_fn=functools.partial(tf_mod.apply_block_prefill,
                                       lengths=lengths,
                                       prefix_len=batch.get("prefix_len")))
        if all_logits:
            return self._head(x), {"caches": caches}
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
        if self.cfg.family == "hybrid":
            x, new_state = self._hybrid_stack(x, state, prefill=False)
            return self._head(x)[:, 0], new_state
        x, caches = tf_mod.apply_stack_decode(
            self.blocks, x, self.cfg.block_config(), state["caches"])
        return self._head(x)[:, 0], {"caches": caches}

    def _hybrid_stack(self, x: torch.Tensor, state: State, prefill: bool
                      ) -> Tuple[torch.Tensor, State]:
        """The hybrid backbone over a segment (prefill) or one token: each
        group of Mamba2 layers, then the shared block into the group's own
        KV cache.  The state is updated IN PLACE, layer by layer; the
        returned state carries the caches' new length."""
        cfg = self.cfg
        mc, bc = cfg.mamba_config(), cfg.block_config()
        ms = state["mamba"]
        C, n = ms["ssd"]
        conv = ms["conv"]
        caches: KVCache = state["attn_caches"]
        new = caches
        for gi, (lo, hi) in enumerate(_hybrid_groups(cfg.n_layers,
                                                     cfg.attn_every)):
            for i in range(lo, hi):
                layer = {"ssd": (C[i], n[i]), "conv": conv[i]}
                if prefill:
                    x, st = ssm_mod.apply_mamba2_block(
                        self.mamba[i], x, mc, initial_state=layer,
                        return_state=True)
                else:
                    x, st = ssm_mod.mamba2_decode(self.mamba[i], x, mc,
                                                  layer)
                C[i].copy_(st["ssd"][0])
                n[i].copy_(st["ssd"][1])
                conv[i].copy_(st["conv"])
            view = KVCache(k=caches.k[gi], v=caches.v[gi],
                           length=caches.length)
            block_fn = (tf_mod.apply_block_prefill if prefill
                        else tf_mod.apply_block_decode)
            x, new = block_fn(self.shared_attn, x, bc, view)
        return x, {"mamba": ms,
                   "attn_caches": caches._replace(length=new.length)}
