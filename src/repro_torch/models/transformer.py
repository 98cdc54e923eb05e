"""Pre-norm transformer blocks: the training stack, prefill and decode.

Port of ``repro/models/transformer.py``: one :class:`Block` module per
layer (the JAX package stacks them on a leading layers axis and scans;
here a Python loop walks an ``nn.ModuleList``), RMSNorm or LayerNorm
(stablelm-3b) as ``BlockConfig.norm`` says, a SwiGLU or an MoE MLP
(:mod:`repro_torch.models.moe`) as ``BlockConfig.mlp`` says, the training
block and stack (:func:`apply_block` returns the MoE's aux loss,
:func:`apply_stack` sums it over the layers under the
``FeatureSet.remat_policy``), the prefill block, the dense decode block,
and the paged decode stack.  A sharded LM's :class:`BlockConfig` carries
its model axis (``tp``, ``tp_mlp``) and, for training, its data axis
(``dp``): every block reduces the attention's and the MLP's partial sums
over the model axis, the training block entering each split region
through ``copy_in`` (:class:`repro_torch.launch.mesh.MeshAxis`), and an
MoE block splits its experts over it (:mod:`repro_torch.models.moe`).

**Remat** (:func:`remat`, the reference's ``remat_policy_fn``,
``:183-190``): ``none`` runs a layer as is; ``full`` checkpoints it and
saves nothing (``jax.checkpoint_policies.nothing_saveable``); ``dots``
saves the outputs of ``aten.mm``/``addmm``/``bmm``/``baddbmm``
(``checkpoint_dots``) and ``dots_no_batch`` only those of
``mm``/``addmm`` (``checkpoint_dots_with_no_batch_dims``: the weight
products, not the attention's batched ones), everything else
recomputed; both through ``torch.utils.checkpoint`` with
``use_reentrant=False`` and ``create_selective_checkpoint_contexts``.
Under a profiler the training block's attention is the span
``model.attention`` (:func:`repro_torch.core.marker.span`), its normed
input and its output marked for the backward; a recompute shows as the
span again.

KV caches carry a leading layers axis; each layer reads and writes its own
slice IN PLACE (the JAX package threads the stacked cache through a scan
carry and relies on while-loop aliasing for the same effect).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core.features import FeatureSet
from repro_torch.core.marker import span
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import (AttnConfig, KVCache, PagedKVCache)
from repro_torch.models.layers import (layer_norm, rms_norm, swiglu,
                                      truncated_normal_)

__all__ = ["BlockConfig", "Block", "RMSNorm", "LayerNorm", "make_norm",
           "apply_norm", "apply_block", "apply_stack", "apply_layers",
           "remat", "apply_block_prefill", "apply_block_decode",
           "apply_stack_decode", "block_specs", "stacked_specs"]


class BlockConfig(NamedTuple):
    attn: AttnConfig
    d_ff: int
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    mlp: str = "swiglu"          # swiglu | moe
    moe: Optional[object] = None
    norm_eps: float = 1e-6
    # tensor parallel (a sharded LM's view): the model axis the heads
    # split over (``attn`` then holds the rank's head counts), and the one
    # ``d_ff`` splits over (then ``d_ff`` is the rank's; None when the MLP
    # is replicated because the axis does not divide it)
    tp: Optional[object] = None
    tp_mlp: Optional[object] = None
    # the data axis a training batch splits over (the MoE's capacity and
    # aux loss are the global batch's); None when serving
    dp: Optional[object] = None
    # how the rank holds its dense KV cache where it follows the
    # reference's decode-state layout (an ``attention.KVLayout``); None:
    # the engine's kv-head split
    kv: Optional[object] = None
    # sequence parallelism (``act_seq -> model``): the training blocks
    # take and give this rank's slice of the sequence
    sp: bool = False


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)


class LayerNorm(nn.Module):
    """``layernorm_init``'s leaves: ``scale`` (ones) and ``bias`` (zeros)."""

    def __init__(self, d: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                                 requires_grad=False)


def make_norm(kind: str, d: int, dtype: torch.dtype,
              device: torch.device) -> nn.Module:
    """The norm module of ``kind`` (``rmsnorm`` | ``layernorm``)."""
    if kind == "rmsnorm":
        return RMSNorm(d, dtype, device)
    if kind == "layernorm":
        return LayerNorm(d, dtype, device)
    raise ValueError(f"unknown norm {kind!r} (rmsnorm | layernorm)")


def apply_norm(x: torch.Tensor, ln: nn.Module, eps: float,
               sp: Optional[object] = None) -> torch.Tensor:
    """``ln`` over ``x``: LayerNorm when it carries a bias, else RMSNorm.
    Under sequence parallelism ``x`` is this rank's slice of the
    sequence, and the norm's leaves enter through ``sp.copy_in`` (the
    model axis): their gradients sum over the ranks' slices."""
    wrap = (lambda w: w) if sp is None else sp.copy_in
    if isinstance(ln, LayerNorm):
        return layer_norm(x, wrap(ln.scale), wrap(ln.bias), eps)
    return rms_norm(x, wrap(ln.scale), eps)


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
    """One pre-norm block's weights (``init_block``'s tree: RMSNorm or
    LayerNorm; a swiglu ``mlp`` or, for ``mlp="moe"``, a ``moe``)."""

    def __init__(self, cfg: BlockConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d = cfg.attn.d_model
        self.ln1 = make_norm(cfg.norm, d, dtype, device)
        self.attn = attn_mod.Attention(cfg.attn, dtype, device)
        self.ln2 = make_norm(cfg.norm, d, dtype, device)
        if cfg.mlp == "moe":
            self.moe = moe_mod.MoE(cfg.moe, dtype, device, tp=cfg.tp)
        else:
            self.mlp = SwiGLU(d, cfg.d_ff, dtype, device)

    def init(self, generator: Optional[torch.Generator]) -> None:
        """``init_block``'s distributions (norm scales stay 1)."""
        self.attn.init(generator)
        if hasattr(self, "moe"):
            self.moe.init(generator)
            return
        d, d_ff = self.mlp.w_gate.shape
        truncated_normal_(self.mlp.w_gate, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.mlp.w_up, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.mlp.w_down, 1.0 / math.sqrt(d_ff), generator)


def block_specs(cfg: BlockConfig) -> dict:
    """Logical axes of one block's weights (the reference's
    ``block_specs``, ``repro/models/transformer.py:74``)."""
    norm_spec = ({"scale": ("act_embed",)} if cfg.norm == "rmsnorm"
                 else {"scale": ("act_embed",), "bias": ("act_embed",)})
    s = {"ln1": dict(norm_spec), "attn": attn_mod.attn_specs(cfg.attn),
         "ln2": dict(norm_spec)}
    if cfg.mlp == "moe":
        s["moe"] = moe_mod.moe_specs(cfg.moe)
    else:
        s["mlp"] = {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
                    "w_down": ("ff", "embed")}
    return s


def stacked_specs(one: dict) -> dict:
    """Prepend the 'layers' logical axis to every leaf spec (the JAX
    package's stacked weights; the port's blocks are one module a layer,
    so ``LM.param_specs`` uses :func:`block_specs` per layer)."""
    return {k: stacked_specs(v) if isinstance(v, dict)
            else ("layers",) + tuple(v) for k, v in one.items()}


def _norm(x: torch.Tensor, ln: nn.Module, cfg: BlockConfig) -> torch.Tensor:
    return apply_norm(x, ln, cfg.norm_eps)


def _block_mlp(p: Block, h: torch.Tensor, cfg: BlockConfig) -> torch.Tensor:
    """The post-attention MLP half of a block (an MoE's aux loss dropped:
    prefill and decode never train).  Under tensor parallelism
    (``cfg.tp_mlp``) gate/up are column-parallel and down row-parallel: the
    rank's ``d_ff`` block gives a partial sum, reduced over the model axis
    (the SwiGLU has no bias to add after it)."""
    if cfg.mlp == "moe":
        return moe_mod.moe_mlp(p.moe, _norm(h, p.ln2, cfg), cfg.moe,
                               tp=cfg.tp)[0]
    mp = p.mlp
    y = swiglu(_norm(h, p.ln2, cfg), mp.w_gate, mp.w_up, mp.w_down)
    return y if cfg.tp_mlp is None else cfg.tp_mlp.all_reduce(y)


def apply_block(p: Block, x: torch.Tensor, cfg: BlockConfig, *,
                positions3: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm block, the training path (no cache): returns (y, aux
    loss), the aux an fp32 scalar (zero unless the MLP is an MoE).  Under
    tensor parallelism the attention and a split MLP take their input
    through ``copy_in`` and reduce their partial sums; under sequence
    parallelism (``cfg.sp``) :func:`_apply_block_sp`."""
    if cfg.sp:
        return _apply_block_sp(p, x, cfg, positions3)
    xn = _norm(x, p.ln1, cfg)
    with span("model.attention") as s:
        a = s.output(attn_mod.attention(p.attn, s.input(xn), cfg.attn,
                                        positions3=positions3, tp=cfg.tp))
    h = x + a
    if cfg.mlp == "moe":
        m, aux = moe_mod.moe_mlp(p.moe, _norm(h, p.ln2, cfg), cfg.moe,
                                 tp=cfg.tp, dp=cfg.dp)
    else:
        mp, tp = p.mlp, cfg.tp_mlp
        hn = _norm(h, p.ln2, cfg)
        m = swiglu(hn if tp is None else tp.copy_in(hn), mp.w_gate,
                   mp.w_up, mp.w_down)
        m = m if tp is None else tp.all_reduce(m)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return h + m, aux


def _apply_block_sp(p: Block, x: torch.Tensor, cfg: BlockConfig,
                    positions3: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training block under sequence parallelism (``act_seq ->
    model``, ``repro/models/transformer.py:99-113``): ``x`` and the output
    are this rank's slice of the sequence, and so are the residual and
    the norms (their leaves' gradients summed over the model axis).  The
    attention and a split SwiGLU gather the sequence into their
    column-parallel products and reduce-scatter their row-parallel ones;
    the MoE sees the whole sequence (its capacity and aux loss are the
    call's tokens: gathered with ``all_gather``, whose backward keeps
    this rank's slice of the gradient the MoE makes whole) and
    reduce-scatters its output; a SwiGLU the axis does not split runs on
    the slice, its weights through ``copy_in``."""
    tp = cfg.tp
    xn = apply_norm(x, p.ln1, cfg.norm_eps, tp)
    with span("model.attention") as s:
        a = s.output(attn_mod.attention(p.attn, s.input(xn), cfg.attn,
                                        positions3=positions3, tp=tp,
                                        sp=True))
    h = x + a
    hn = apply_norm(h, p.ln2, cfg.norm_eps, tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.mlp == "moe":
        m, aux = moe_mod.moe_mlp(p.moe, tp.all_gather(hn, 1), cfg.moe,
                                 tp=tp, dp=cfg.dp, sp=True)
    elif cfg.tp_mlp is not None:
        mp = p.mlp
        m = tp.reduce_scatter(swiglu(tp.gather_seq(hn, 1), mp.w_gate,
                                     mp.w_up, mp.w_down), 1)
    else:
        mp = p.mlp
        m = swiglu(hn, tp.copy_in(mp.w_gate), tp.copy_in(mp.w_up),
                   tp.copy_in(mp.w_down))
    return h + m, aux


#: the ops whose outputs a selective remat policy saves
_DOTS = {"dots": ("mm", "addmm", "bmm", "baddbmm"),
         "dots_no_batch": ("mm", "addmm")}


def _save_policy(names: Tuple[str, ...]):
    ops = tuple(getattr(torch.ops.aten, n).default for n in names)

    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def remat(fn: Callable, features: FeatureSet) -> Callable:
    """``fn`` under ``features.remat_policy`` (see the module note)."""
    policy = features.remat_policy
    if policy == "none":
        return fn
    kw = {}
    if policy in _DOTS:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            _save_policy(_DOTS[policy]))
    elif policy != "full":
        raise ValueError(f"unknown remat_policy {policy!r}")
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def apply_layers(layers, x: torch.Tensor, fn: Callable,
                 features: FeatureSet) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``fn(layer, h) -> (h', aux)`` over ``layers`` in order, each
    under :func:`remat`; returns (h, summed aux) (the reference's
    ``_scan_stack_generic``)."""
    one = remat(fn, features)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in layers:
        x, a = one(layer, x)
        aux = aux + a
    return x, aux


def apply_stack(blocks: nn.ModuleList, x: torch.Tensor, cfg: BlockConfig,
                features: FeatureSet, *,
                positions3: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every block's training path in turn; returns (y, summed aux)."""
    return apply_layers(
        blocks, x, lambda p, h: apply_block(p, h, cfg,
                                            positions3=positions3),
        features)


def apply_block_prefill(p: Block, x: torch.Tensor, cfg: BlockConfig,
                        cache: Union[KVCache, PagedKVCache], *,
                        lengths: Optional[torch.Tensor] = None,
                        prefix_len: Optional[torch.Tensor] = None,
                        positions3: Optional[torch.Tensor] = None):
    """Prefill one block into a dense or paged cache (one layer's view);
    the attention compute is identical, only the K/V landing zone
    differs.  ``prefix_len`` [B] (paged only) marks a resident shared
    prefix: ``x`` is the divergent suffix.  ``positions3`` [3,B,S] are
    the vlm family's M-RoPE position streams."""
    paged = isinstance(cache, PagedKVCache)
    if prefix_len is not None and not paged:
        raise ValueError("prefix_len requires a paged KV cache "
                         "(dense prefill has no resident prefix)")
    if paged:
        a, new_cache = attn_mod.prefill_into_paged_cache(
            p.attn, _norm(x, p.ln1, cfg), cfg.attn, cache, lengths=lengths,
            prefix_len=prefix_len, positions3=positions3, tp=cfg.tp)
    else:
        a, new_cache = attn_mod.prefill_into_cache(
            p.attn, _norm(x, p.ln1, cfg), cfg.attn, cache, lengths=lengths,
            positions3=positions3, tp=cfg.tp, kv=cfg.kv)
    h = x + a
    return h + _block_mlp(p, h, cfg), new_cache


def apply_block_decode(p: Block, x: torch.Tensor, cfg: BlockConfig,
                       cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Dense one-token decode of one block (``decode_attention``)."""
    a, new_cache = attn_mod.decode_attention(p.attn, _norm(x, p.ln1, cfg),
                                             cfg.attn, cache, tp=cfg.tp,
                                             kv=cfg.kv)
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
    :func:`apply_block_prefill` with its ragged ``lengths``, ``prefix_len``
    and, for the vlm family, ``positions3`` bound).  The default one-token
    decode over a PAGED cache takes its own path: the paged kernel plus a
    one-slot page write per layer."""
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
            v_scale=layer.v_scale, tp=cfg.tp)
        h = x + a
        x = h + _block_mlp(p, h, cfg)
        k_t, v_t = k_t[:, 0], v_t[:, 0]
        if layer.quantized:
            k_t, k_s = attn_mod.quantize_kv_rows(k_t, cfg.tp)
            v_t, v_s = attn_mod.quantize_kv_rows(v_t, cfg.tp)
            layer.k_scale[page, off] = k_s
            layer.v_scale[page, off] = v_s
        layer.k_pages[page, off] = k_t.to(layer.k_pages.dtype)
        layer.v_pages[page, off] = v_t.to(layer.v_pages.dtype)
    return x, caches._replace(length=length + 1)
