"""The causal LM: config, weights, prefill and decode for every family:
dense, moe, vlm, hybrid, xlstm, encdec.

Port of ``repro/models/lm.py``.  :class:`LMConfig` carries every field of
the JAX config, so configs port verbatim; :class:`LM` implements serving
for ``family="dense"`` (embed -> transformer blocks -> norm -> LM head,
RMSNorm or LayerNorm), ``family="moe"`` (the same with MoE MLP blocks,
:mod:`repro_torch.models.moe`), ``family="vlm"`` (dense blocks with
M-RoPE; ``batch["patch_embeds"]`` [B, n, d] from the vision stub replace
the first n token embeddings, and prefill rotates q/k at the three
position streams of :meth:`LM._vlm_positions3`), ``family="hybrid"``
(zamba2: Mamba2 blocks with ONE weight-shared transformer block after
every ``attn_every``-th, each application with its own dense KV cache),
``family="xlstm"`` (``n_layers // 2`` mLSTM/sLSTM block pairs, recurrent
state only) and ``family="encdec"`` (the frontend stub's
``batch["src_embeds"]`` [B, S_src, d] through the encoder blocks and a
LayerNorm, then decoder blocks with cross-attention over per-layer memory
K/V computed once at prefill, :mod:`repro_torch.models.encdec`; dense KV
only).

**Weights and dtypes.**  The JAX package keeps fp32 masters and casts
them to the compute dtype at every use.  ``LM(cfg, dtype)`` stores each
weight once, in ``param_dtype`` (the compute dtype ``dtype`` unless
given), and casts at every use through :func:`repro_torch.models.layers.
cast`, which is the tensor itself when the dtypes match: a serving model
(``param_dtype == dtype``) gains no launch, and a training model
(``param_dtype=torch.float32``, bf16 compute) computes as the reference
does, its gradients returning to the fp32 masters.  qwen2's TIED
embedding is cast separately at the gather and at the head, so its two
gradients sum in fp32 as the reference's do.  Parameters are built
frozen (``requires_grad=False``); ``lm.requires_grad_(True)`` (which
:func:`repro_torch.train.step.init_train_state` calls) makes every one
trainable.  The Mamba2 decay leaves ``A_log``, ``dt_bias`` and ``D``
(:data:`repro_torch.models.ssm.FP32_LEAVES`), the xLSTM gate leaves
(:data:`repro_torch.models.xlstm.FP32_LEAVES`) and the MoE router and
shared gate (:data:`repro_torch.models.moe.FP32_LEAVES`) stay fp32, as
the JAX package computes with them in fp32.

``LM`` runs on ``cuda`` unless it is built with ``device="cpu"``; with no
GPU and no explicit request it raises (:func:`repro_torch.device.
resolve_device`).

**Training** (``repro/models/lm.py:275-368``).  :meth:`LM.forward` and
:meth:`LM.loss` run the backbone of every family without caches:
``dense``/``moe``/``vlm`` through :func:`~repro_torch.models.transformer.
apply_stack` (M-RoPE positions for vlm, the MoE aux loss summed), the
``hybrid`` through each group's Mamba2 blocks and the shared block,
``xlstm`` through its mLSTM/sLSTM pairs, ``encdec`` through the encoder,
its final LayerNorm and the decoder with each layer's cross memory.
The per-layer loops run under ``features.remat_policy``
(:func:`~repro_torch.models.transformer.remat`); ``scan_layers`` and
``scan_unroll`` are XLA's and only reported.  The loss is the
reference's: logsumexp minus the gold logit in fp32, labels ``< 0``
masked, the mean over ``max(sum(w), 1)`` real labels, plus the aux
loss.

**Declared traffic.**  The JAX package reads a step's bytes and FLOPs
from its compiled artifact.  Here the kernels declare their own launches
(:mod:`repro_torch.core.events`) and :meth:`LM.prefill` /
:meth:`LM.decode_step` declare, once a call, the plain PyTorch work no
kernel declares (:meth:`LM._declare_ops`): every weight read once (the
embedding only as the gathered rows, the head's ``[d, V]`` once), the
GEMM FLOPs (an MoE layer's experts over their ``[E, cap, D]`` buffers,
which it writes and reads, its router in fp32 and its shared expert over
every row), the K/V written into the cache, the dense engine's masked
decode over its WHOLE ``[B, Smax, KVH, Dh]`` K and V buffers whatever the
rows hold, the prefix-cache suffix prefill's gather of the table's pages,
and the recurrent families' state (read and written).  So an event collection around
a step counts the whole step, as the artifact does.  :meth:`LM.loss`
declares a training step's model (:meth:`LM._declare_train`): three
times its forward's FLOPs (PaLM's count: the GEMMs over every token,
the head, each self-attention's full ``S x S`` and the MoE's capacity),
four with ``remat_policy="full"`` (the recomputed forward), every
weight read three times and its gradient written once; activations are
not counted.

**Tensor parallelism** (``LM(..., tp=axis)``; every family).  The JAX
package shards one LM's arrays over a mesh and lets GSPMD partition its
programs.  The port builds, on each rank of the mesh, an LM of the rank's
blocks: ``tp`` is the rank's model axis
(:class:`repro_torch.launch.mesh.ModelAxis`), the heads of ``wq``/``wk``/
``wv`` (and ``bq``/``bk``/``bv``) and of ``wo`` split over it, and so do
``d_ff``, ``vocab``, the MoE's experts and its shared expert's width
where they divide (the divisibility guard of
:func:`~repro_torch.models.layers.logical_to_mesh`; the heads always do,
as the LM refuses a head count the axis does not divide).  The rank's
configs carry its head counts (:meth:`LM.block_config`,
:meth:`LM.mamba_config`, :meth:`LM.xlstm_config`, :meth:`LM.encdec_config`),
so the kernels get local tensors (#1 and #2/#3 at ``num_kv_heads / m`` kv
heads, G unchanged; #5 at ``H / m`` heads); the reduces after each
row-parallel product, the vocab-parallel lookup and the gathered logits
(so sampling and kernel #4 see whole rows) are the communication.
M-RoPE's sections split ``head_dim``, which no rule shards, so they
survive the head split.  The hybrid's Mamba2 blocks split by heads (the
gated RMSNorm's sum of squares reduced over the axis) and its one shared
block as a transformer block, at each of its applications; the xlstm's
mLSTM by heads and its sLSTM only in its FFN (the recurrence stays whole
on every rank, :mod:`repro_torch.models.xlstm`); the encdec's encoder,
decoder, cross-attention and memory by heads.  Where a rank's layout
departs from the derived spec's contiguous cut (Mamba2's concatenated
``in_proj``, the mLSTM's heads), :meth:`LM.model_splits` says how, and
the engine and the trainer cut and join those leaves by it.  ``cfg``
stays the whole model's config.  :meth:`LM.param_specs` names every
weight's logical axes (``repro/models/lm.py:207-237``).

**Training on a mesh.**  The collectives carry gradients in Megatron's
pattern (:class:`repro_torch.launch.mesh.MeshAxis`): every replicated
tensor that feeds a split region enters it through ``copy_in``, so a
replicated leaf (a norm scale, a bias the axis does not split, the
router) gets its whole gradient on every rank.  ``dp`` is the data axis
(:class:`repro_torch.launch.mesh.DataAxis`) the batch rows split over:
:meth:`LM.loss` is the reference's ``sum(nll) / ntok`` over the GLOBAL
batch (both sums reduced over ``dp``; a mean of the ranks' means differs
whenever labels hold -1), and the MoE's capacity and aux loss are the
global batch's.  Under a split vocab the loss never gathers the logits:
the cross entropy is vocab-parallel (the row max, the sum of
exponentials and the gold logit, each reduced over ``model``), where a
gather would make 2.5 GB of fp32 logits a rank at 8 x 512 tokens and
vocab 151936.  ``generate`` keeps its gathered logits.

**Sequence parallelism** (``act_seq -> model`` in the LM's rules, a model
axis of more than one rank; ``repro/models/transformer.py:99-113``,
``repro/models/lm.py:346-355``).  The training forward cuts the
embeddings (after the vlm family's patch merge; M-RoPE's positions are
the whole sequence's) to this rank's slice of the sequence, and the
transformer blocks keep it there: the residual and the norms on the slice
(the norms' leaves through ``copy_in``, so their gradients sum over the
ranks' slices), an all-gather over the sequence into the attention's and
a split SwiGLU's column-parallel products, a reduce-scatter out of
``wo`` and ``w_down`` (:meth:`~repro_torch.launch.mesh.MeshAxis.
gather_seq`, :meth:`~repro_torch.launch.mesh.MeshAxis.reduce_scatter`).
The MoE sees the whole sequence (its capacity and aux loss are the call's
tokens) and reduce-scatters its output; the hybrid's Mamba2 groups run on
the gathered sequence between its shared blocks, the xlstm and encdec
backbones on the whole sequence (the reference constrains only their
embedding output and logits).  The final norm runs on the slice, and the
head on the gathered sequence, so the vocab-parallel loss is unchanged:
the reference's logits ``("batch", "act_seq", "vocab")`` hold the same
bytes a rank with the vocab whole.

**The decode state's layout** (``LM(..., mesh=)``; ``repro/models/lm.py:
434-449``, ``repro/launch/dryrun.py:115-124``).  :meth:`LM.state_specs`
names every state leaf's axes by its rank, as the reference does, and
:meth:`LM.state_pspecs` maps them onto a mesh: a KV cache's sequence takes
the axes the batch leaves free (``cache_seq -> ("data", "model")``), so
``kv_heads`` finds ``model`` taken and stays whole.  An LM given the mesh
decodes (and prefills into) this rank's cut of such a state
(:meth:`LM.cut_state`, which keeps the layout on the LM) under rules that
name the axes the state was cut by (:meth:`LM.state_rules`: the
divisibility guard makes the layout depend on the whole sizes, which a
rank's slice does not show).  The caches and the encdec memory each
follow their own leaf's spec (the guard may cut a memory of
``max_seq // src_ratio`` positions by kv heads where it cuts the caches
by positions), and the memory holds the state's ``S_src`` positions, so
a prefill under the layout takes a source of that length only.  A rank
gathers its heads' new q/k/v over the model axis, attends its slice of
the positions and combines the partial softmaxes over the sequence's axes
(:class:`~repro_torch.models.attention.KVLayout`); only the rank that
holds position ``length[b]`` writes the new token.  Under
``kv_shard="headdim"``'s rules (``head_dim -> model``, heads whole) the
attention's weights and the cache hold a paired cut of the head dim, the
scores reduce over the model axis and ``wo`` is row-parallel over the
head dim.  The recurrent states (Mamba2's, the mLSTM's) are re-laid from
the reference's cut into the heads the blocks compute and back around a
step (:meth:`LM._relaid`).  The engines pass no mesh and keep their
kv-head split, as the reference's do (``repro/serve/engine.py:378-388``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Tuple, Union)

import torch
from torch import nn

from repro_torch.core import events
from repro_torch.core.features import FeatureSet, default_features
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import (AttnConfig, KVCache, KVLayout,
                                         PagedKVCache)
from repro_torch.models.layers import (DEFAULT_RULES, ModelSplit,
                                      ShardingRules, cast, contract_split,
                                      embed_lookup, expand_split, fit_spec,
                                      layer_norm, logical_to_mesh,
                                      split_spec, spec_tree_to_pspecs,
                                      truncated_normal_)
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import Mamba2Config
from repro_torch.models.transformer import BlockConfig
from repro_torch.models.xlstm import XLSTMConfig

__all__ = ["LMConfig", "LM", "PORTED_FAMILIES"]

#: the families ``LM`` serves: all of the JAX package's
PORTED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "xlstm", "encdec")

#: families whose state is a KV cache that pages (``repro.models.lm``'s
#: ``("dense", "moe", "vlm")``; encdec's decoder cache is dense only)
KV_FAMILIES = ("dense", "moe", "vlm")

#: weights a token multiplies once a step (2 FLOPs an element): the
#: attention projections, the MLP, the Mamba2 projections and conv, and
#: the xLSTM projections, gates, sLSTM recurrence and FFN
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "in_proj", "conv_w", "out_proj", "w_gates", "r_gates",
                  "w_ff_gate", "w_ff_up", "w_ff_down")


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
    def sub_quadratic(self) -> bool:
        """Whether long_500k decode is O(1)-state (xlstm/hybrid)."""
        return self.family in ("xlstm", "hybrid")

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

    def moe_config(self) -> MoEConfig:
        return MoEConfig(
            d_model=self.d_model, d_ff_expert=self.d_ff,
            num_experts=self.moe_experts, top_k=self.moe_top_k,
            num_shared_experts=self.moe_shared_experts,
            d_ff_shared=self.moe_d_ff_shared)

    def block_config(self) -> BlockConfig:
        return BlockConfig(
            attn=self.attn_config(), d_ff=self.d_ff, norm=self.norm,
            mlp="moe" if self.family == "moe" else "swiglu",
            moe=self.moe_config() if self.family == "moe" else None,
            norm_eps=self.norm_eps)

    def encdec_config(self) -> encdec_mod.CrossAttnBlockConfig:
        return encdec_mod.CrossAttnBlockConfig(
            attn=self.attn_config(), d_ff=self.d_ff, norm_eps=self.norm_eps)

    def xlstm_config(self) -> XLSTMConfig:
        return XLSTMConfig(d_model=self.d_model, num_heads=self.num_heads,
                           chunk_size=self.chunk_size, norm_eps=self.norm_eps)

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


def _split_heads(cfg: LMConfig, headdim: bool = False) -> Dict[str, int]:
    """The head counts a model axis must divide, by family; under
    ``kv_shard="headdim"`` (``headdim``) the attention splits each half
    of the head dim instead of its heads."""
    if cfg.family == "xlstm":
        return {"num_heads": cfg.num_heads}
    out = ({"head_dim / 2": cfg.resolved_head_dim // 2} if headdim
           else {"num_kv_heads": cfg.num_kv_heads})
    if cfg.family == "hybrid":
        out["ssm heads"] = cfg.mamba_config().num_heads
    return out


#: attention leaves a ``kv_shard="headdim"`` rank cuts on the head dim,
#: and that dim
HEADDIM_LEAVES = {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "bq": 1, "bk": 1,
                  "bv": 1}


def _state_leaf_axes(ndim: int) -> Tuple[Optional[str], ...]:
    """The reference's logical axes of a decode-state leaf, by its rank
    (``repro/models/lm.py:434-449``)."""
    if ndim == 5:
        return ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    if ndim == 4:
        return ("layers", "batch", "heads", None)
    if ndim == 3:
        return ("layers", "batch", None)
    if ndim == 2:
        return ("layers", "batch")
    return (None,) * ndim


def _map_state(fn: Callable, state: Any, *others: Any) -> Any:
    """``fn(leaf, kind, *other_leaves)`` over every tensor of a decode
    state (dicts, tuples and cache tuples; ``others`` trees of the same
    structure), the same structure back.  ``kind`` is ``"kv"`` for a KV
    buffer (a cache's ``k``/``v``, the encdec memory), ``"shared"`` for a
    leaf the port holds once for every layer where the reference stacks
    it (a cache's ``length``, a page table) and ``"state"`` else."""
    def walk(t, kind, *o):
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            return fn(t, kind, *o)
        if isinstance(t, (KVCache, PagedKVCache)):
            kinds = {"k": "kv", "v": "kv", "k_pages": "kv",
                     "v_pages": "kv", "length": "shared",
                     "page_table": "shared"}
            return type(t)(*[walk(v, kinds.get(f, "state"),
                                  *(x[i] for x in o))
                             for i, (f, v) in enumerate(zip(t._fields, t))])
        if isinstance(t, Mapping):
            return {k: walk(v, "kv" if k in ("mem_k", "mem_v") else kind,
                            *(x[k] for x in o)) for k, v in t.items()}
        return type(t)(walk(v, kind, *(x[i] for x in o))
                       for i, v in enumerate(t))
    return walk(state, "state", *others)


def _names(entry: Any) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _paired_cut(x: torch.Tensor, dim: int, m: int, r: int) -> torch.Tensor:
    """Block ``r`` of ``m`` of each half of ``dim``, side by side: a
    ``kv_shard="headdim"`` rank's cut of the head dim (RoPE pairs dim
    ``i`` with ``i + Dh/2``, so a contiguous cut would hold one half)."""
    return torch.cat([h.chunk(m, dim)[r] for h in x.chunk(2, dim)], dim=dim)


def _flat(tree: Dict[str, Any], prefix: str = ""):
    """(dotted path, leaf) of a nested spec tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


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


class StateCut(NamedTuple):
    """The decode-state layout an LM with a mesh holds its states in (set
    by :meth:`LM.cut_state`): the whole state's mesh specs
    (:meth:`LM.state_pspecs`), the KV caches' and the encdec memory's
    :class:`~repro_torch.models.attention.KVLayout` (None: attended as the
    engine's layout is), and the memory's whole source length."""

    specs: Any
    kv: Optional[KVLayout]
    mem: Optional[KVLayout]
    s_src: int


class LM(nn.Module):
    """The causal LM.  Parameter names mirror the JAX params tree
    (``embed.table``, ``final_norm.scale``, ``blocks.{i}.attn.wq``,
    ``mamba.{i}.in_proj``, ``shared_attn.attn.wq``, ``mlstm.{i}.wq``,
    ``slstm.{i}.r_gates``, ``encoder.{i}.mlp.w_up``,
    ``decoder.{i}.cross.wq``, ``enc_final_norm.scale``, ...), which is what
    :mod:`repro_torch.bridge` maps onto."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype = torch.bfloat16,
                 device: Optional[Union[str, torch.device]] = None,
                 features: Optional[FeatureSet] = None,
                 param_dtype: Optional[torch.dtype] = None,
                 rules: ShardingRules = DEFAULT_RULES, tp: Any = None,
                 dp: Any = None, mesh: Any = None):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; families: "
                             f"{PORTED_FAMILIES}")
        self.rules = rules
        self.tp = tp
        if tp is not None:
            for what, n in _split_heads(cfg, self._headdim).items():
                if n % tp.size:
                    raise ValueError(
                        f"{what}={n} does not divide over the model axis "
                        f"({tp.size} ranks)")
        self.cfg = cfg
        self.dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.features = features or default_features()
        self.device = resolve_device(device)
        self.dp = dp
        self.mesh = mesh
        self._cut: Optional[StateCut] = None
        dev = self.device
        bc = self.block_config()
        dtype = self.param_dtype
        vocab = self.local_vocab
        self.embed = Embed(vocab, cfg.d_model, dtype, dev)
        self.final_norm = tf_mod.make_norm(cfg.norm, cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            self.lm_head = LMHead(cfg.d_model, vocab, dtype, dev)
        if cfg.family == "xlstm":
            xc = self.xlstm_config()
            n_pairs = cfg.n_layers // 2
            self.mlstm = nn.ModuleList(xlstm_mod.MLSTMBlock(xc, dtype, dev)
                                       for _ in range(n_pairs))
            self.slstm = nn.ModuleList(xlstm_mod.SLSTMBlock(xc, dtype, dev)
                                       for _ in range(n_pairs))
        elif cfg.family == "hybrid":
            mc = self.mamba_config()
            self.mamba = nn.ModuleList(ssm_mod.Mamba2Block(mc, dtype, dev)
                                       for _ in range(cfg.n_layers))
            self.shared_attn = tf_mod.Block(bc, dtype, dev)
        elif cfg.family == "encdec":
            ec = self.encdec_config()
            enc_cfg = ec._replace(attn=ec.attn._replace(causal=False))
            self.encoder = nn.ModuleList(
                encdec_mod.EncoderBlock(enc_cfg, dtype, dev)
                for _ in range(cfg.enc_layers or cfg.n_layers))
            self.decoder = nn.ModuleList(
                encdec_mod.DecoderBlock(ec, dtype, dev)
                for _ in range(cfg.n_layers))
            self.enc_final_norm = tf_mod.LayerNorm(cfg.d_model, dtype, dev)
        else:
            self.blocks = nn.ModuleList(tf_mod.Block(bc, dtype, dev)
                                        for _ in range(cfg.n_layers))

    # ============================================================ sharding
    def _split(self, n: int) -> bool:
        """Whether a dim of size ``n`` splits over the model axis."""
        return self.tp is not None and n % self.tp.size == 0

    def _on_model(self, logical: str) -> bool:
        """Whether the LM's rules map ``logical`` onto the model axis (and
        the LM has one of more than one rank)."""
        return (self.tp is not None and self.tp.size > 1
                and "model" in (self.rules.lookup(logical) or ()))

    @property
    def _headdim(self) -> bool:
        """``kv_shard="headdim"``'s rules (``head_dim -> model``): the
        attention splits each half of the head dim over the model axis
        and keeps every head."""
        return self._on_model("head_dim")

    @property
    def _sp(self) -> bool:
        """Sequence parallelism (``act_seq -> model``): the training
        forward keeps the hidden state between blocks as this rank's
        slice of the sequence."""
        return self._on_model("act_seq")

    @property
    def local_vocab(self) -> int:
        """Vocab rows this rank holds (all of them unless vocab splits)."""
        v = self.cfg.vocab
        return v // self.tp.size if self._split(v) else v

    def block_config(self) -> BlockConfig:
        """The block config this rank computes: the model's, or under
        tensor parallelism its head counts (and a SwiGLU's ``d_ff`` where
        it splits) with the model and data axes attached."""
        bc = self.cfg.block_config()._replace(dp=self.dp, sp=self._sp)
        tp = self.tp
        if tp is None:
            return bc
        m = tp.size
        if self._headdim:
            attn = bc.attn._replace(head_dim=bc.attn.head_dim // m)
        else:
            attn = bc.attn._replace(num_heads=bc.attn.num_heads // m,
                                    num_kv_heads=bc.attn.num_kv_heads // m)
        if bc.mlp == "swiglu" and self._split(bc.d_ff):
            return bc._replace(attn=attn, d_ff=bc.d_ff // m, tp=tp,
                               tp_mlp=tp)
        return bc._replace(attn=attn, tp=tp)

    def mamba_config(self) -> Mamba2Config:
        """The Mamba2 config this rank computes (its heads on a model
        axis)."""
        return self.cfg.mamba_config()._replace(tp=self.tp)

    def xlstm_config(self) -> XLSTMConfig:
        """The xLSTM config this rank computes: the mLSTM's heads on a
        model axis, and the sLSTM's FFN where the axis divides it."""
        xc = self.cfg.xlstm_config()
        return xc._replace(tp=self.tp,
                           tp_ff=self.tp if self._split(xc.d_ff) else None)

    def encdec_config(self) -> encdec_mod.CrossAttnBlockConfig:
        """The encoder/decoder block config this rank computes."""
        bc = self.block_config()
        return self.cfg.encdec_config()._replace(
            attn=bc.attn, d_ff=bc.d_ff, tp=bc.tp,
            tp_mlp=self.tp if bc.tp_mlp is not None else None)

    def param_specs(self) -> Dict[str, Tuple[str, ...]]:
        """Every weight's logical axes, keyed by parameter name (the
        reference's ``param_specs`` tree, ``repro/models/lm.py:207-235``,
        one block's specs a layer where the JAX package stacks them)."""
        cfg = self.cfg
        norm = (("scale",) if cfg.norm == "rmsnorm" else ("scale", "bias"))
        out: Dict[str, Tuple[str, ...]] = {"embed.table": ("vocab", "embed")}
        out.update({f"final_norm.{k}": ("act_embed",) for k in norm})
        if not cfg.tie_embeddings:
            out["lm_head.w"] = ("embed", "vocab")

        def put(prefix: str, tree: Dict[str, Any], n: Optional[int] = None):
            for i in (range(n) if n is not None else (None,)):
                head = prefix if i is None else f"{prefix}.{i}"
                for path, spec in _flat(tree):
                    out[f"{head}.{path}"] = spec

        fam = cfg.family
        if fam in KV_FAMILIES:
            put("blocks", tf_mod.block_specs(cfg.block_config()),
                cfg.n_layers)
        elif fam == "xlstm":
            xc = cfg.xlstm_config()
            put("mlstm", xlstm_mod.mlstm_block_specs(xc), cfg.n_layers // 2)
            put("slstm", xlstm_mod.slstm_block_specs(xc), cfg.n_layers // 2)
        elif fam == "hybrid":
            put("mamba", ssm_mod.mamba2_block_specs(cfg.mamba_config()),
                cfg.n_layers)
            put("shared_attn", tf_mod.block_specs(cfg.block_config()))
        else:                                       # encdec
            ec = cfg.encdec_config()
            put("encoder", encdec_mod.encoder_block_specs(ec),
                cfg.enc_layers or cfg.n_layers)
            put("decoder", encdec_mod.decoder_block_specs(ec), cfg.n_layers)
            out["enc_final_norm.scale"] = ("act_embed",)
            out["enc_final_norm.bias"] = ("act_embed",)
        return out

    def model_splits(self) -> Dict[str, ModelSplit]:
        """The leaves this rank holds other than the derived spec's
        contiguous cut on the model axis (Mamba2's ``in_proj`` and conv,
        the mLSTM's head-split leaves; under ``kv_shard="headdim"`` the
        attention's paired cut of the head dim and Mamba2's head leaves),
        keyed by parameter name; empty without a model axis.  Every other
        leaf is the derived spec's block, or whole where the rank keeps it
        whole (:meth:`rank_pspecs`)."""
        cfg = self.cfg
        out: Dict[str, ModelSplit] = {}
        if self.tp is None:
            return out
        if self._headdim:
            half = cfg.resolved_head_dim // 2
            for name, _ in self.named_parameters():
                mod, _, leaf = name.rpartition(".")
                if mod.endswith((".attn", ".cross")) \
                        and leaf in HEADDIM_LEAVES:
                    out[name] = ModelSplit(HEADDIM_LEAVES[leaf],
                                           ((half, True), (half, True)))
        if cfg.family not in ("hybrid", "xlstm"):
            return out
        if cfg.family == "hybrid":
            one, prefix, n = (ssm_mod.tp_splits(cfg.mamba_config()),
                              "mamba", cfg.n_layers)
            if self._headdim:
                # heads -> None: the Mamba2 blocks still split by heads
                one = dict(one, **{k: ModelSplit(0) for k in
                                   ("A_log", "D", "dt_bias")})
        else:
            one, prefix, n = (xlstm_mod.mlstm_tp_splits(cfg.xlstm_config()),
                              "mlstm", cfg.n_layers // 2)
        out.update({f"{prefix}.{i}.{k}": v for i in range(n)
                    for k, v in one.items()})
        return out

    def rank_pspecs(self, pspecs: Dict[str, Any],
                    full_shapes: Dict[str, Any]) -> Dict[str, Any]:
        """The layout this rank really keeps, from the whole model's
        derived specs ``pspecs``: a leaf of :meth:`model_splits` split on
        its own dim, a leaf the rank holds whole (the MoE router, the
        sLSTM recurrence, a width the axis does not divide) without
        ``model`` (:func:`~repro_torch.models.layers.fit_spec`)."""
        splits = self.model_splits()
        local = dict(self.named_parameters())
        return {k: (split_spec(v, splits[k]) if k in splits
                    else fit_spec(v, full_shapes[k].shape, local[k].shape))
                for k, v in pspecs.items()}

    def expand_splits(self, tree: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Whole leaves with each of :meth:`model_splits` laid out as the
        ranks' blocks side by side (:func:`~repro_torch.models.layers.
        expand_split`), so a contiguous cut by :meth:`rank_pspecs` gives
        this rank its block; :meth:`contract_splits` undoes it."""
        splits, m = self.model_splits(), self.tp.size if self.tp else 1
        return {k: expand_split(v, splits[k], m) if k in splits else v
                for k, v in tree.items()}

    def contract_splits(self, tree: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """The inverse of :meth:`expand_splits`."""
        splits, m = self.model_splits(), self.tp.size if self.tp else 1
        return {k: contract_split(v, splits[k], m) if k in splits else v
                for k, v in tree.items()}

    def param_pspecs(self, mesh: Any, params_shape: Optional[Dict[str, Any]]
                     = None, rules: Optional[ShardingRules] = None
                     ) -> Dict[str, Tuple[Any, ...]]:
        """Every weight's mesh spec on ``mesh``; ``params_shape`` (leaves
        with a ``.shape``, keyed by parameter name; this LM's own
        parameters by default) feeds the divisibility guard."""
        shapes = (dict(self.named_parameters()) if params_shape is None
                  else params_shape)
        return spec_tree_to_pspecs(self.param_specs(), rules or self.rules,
                                   mesh, shapes=shapes)

    def shard_params(self, params: Dict[str, torch.Tensor],
                     mesh: Any = None) -> Optional[Dict[str, torch.Tensor]]:
        """This rank's blocks of the whole weights ``params`` (keyed by
        parameter name) on ``mesh`` (:attr:`mesh` by default) under the
        LM's rules, each cut as the rank holds it (:meth:`rank_pspecs`,
        :meth:`expand_splits`); None off the mesh."""
        from repro_torch.ft.elastic import reshard_tree
        mesh = self.mesh if mesh is None else mesh
        pspecs = self.param_pspecs(mesh, params)
        return reshard_tree(self.expand_splits(params),
                            self.rank_pspecs(pspecs, params), mesh)

    # ================================================ decode-state layout
    def state_specs(self, state: State) -> Any:
        """Logical axes of every decode-state leaf, the state's structure
        back (the reference's ``LM.state_specs``, ``repro/models/lm.py:
        434-449``): by the leaf's rank, a 5-D leaf ``("layers", "batch",
        "cache_seq", "kv_heads", "head_dim")``, a 4-D ``("layers",
        "batch", "heads", None)``, a 3-D ``("layers", "batch", None)``, a
        2-D ``("layers", "batch")``.  So the hybrid's Mamba2 ``C`` and the
        mLSTM's ``C`` take the cache's axes, the conv tail ``[L,B,K-1,C']``
        the heads', and the encdec memory splits along its source
        sequence.  A cache's ``length`` (and page table), which the port
        holds once for every layer where the reference stacks it, takes
        the stacked leaf's axes without ``"layers"``."""
        def axes(x, kind):
            if kind == "shared":
                return _state_leaf_axes(x.dim() + 1)[1:]
            return _state_leaf_axes(x.dim())
        return _map_state(axes, state)

    def state_pspecs(self, state: State, mesh: Any,
                     rules: Optional[ShardingRules] = None) -> Any:
        """Every decode-state leaf's mesh spec on ``mesh``: its
        :meth:`state_specs` axes through ``logical_to_mesh`` with the
        leaf's sizes (the divisibility guard), as the reference's dry run
        cuts a decode or prefill cell's state (``repro/launch/dryrun.py:
        115-124``); ``state`` the whole state (meta tensors will do)."""
        rules = rules or self.rules
        return _map_state(
            lambda x, kind, ax: logical_to_mesh(ax, rules, mesh,
                                                dim_sizes=tuple(x.shape)),
            state, self.state_specs(state))

    def state_rules(self, state: State, mesh: Any,
                    rules: Optional[ShardingRules] = None) -> ShardingRules:
        """``rules`` (the LM's by default) with ``batch`` and ``cache_seq``
        set to the mesh axes the whole ``state``'s KV cache takes them on
        under :meth:`state_pspecs` (the batch from any leaf where the
        family has no cache): the rules a rank's LM decodes its cut of
        that state by.  A rank sees only its slice, and the divisibility
        guard makes the layout depend on the whole sizes (a batch of 8 on
        a data axis of 16 leaves ``data`` to the sequence, one of 128 takes
        it), so the rules carry the layout the state was cut by."""
        rules = rules or self.rules
        specs = self.state_pspecs(state, mesh, rules)
        found: Dict[str, Any] = {}

        def note(x, kind, spec):
            if kind == "kv" and x.dim() == 5 and "cache_seq" not in found:
                found["batch"], found["cache_seq"] = spec[1], spec[2]
            elif x.dim() >= 2 and kind != "shared":
                found.setdefault("batch", spec[1])
        _map_state(note, state, specs)
        return rules.replace(**{k: _names(v) or None
                                for k, v in found.items()})

    def _axis(self, name: str) -> Any:
        """This rank's axis ``name`` of :attr:`mesh`."""
        from repro_torch.launch import mesh as mesh_mod
        return mesh_mod.axis_of(self.mesh, name)

    def _coords(self) -> Tuple[Tuple[str, ...], Tuple[int, ...],
                               Tuple[int, ...]]:
        """(axis names, sizes, this rank's coordinate) of :attr:`mesh`."""
        from repro_torch.launch.mesh import mesh_layout
        names, sizes = mesh_layout(self.mesh)
        return names, sizes, tuple(self._axis(n).index for n in names)

    def cut_state(self, state: State) -> State:
        """This rank's block of a whole decode ``state`` under
        :meth:`state_pspecs` on :attr:`mesh` (the LM's rules): every leaf
        the reference's cut, but a KV buffer's head dim under
        ``kv_shard="headdim"``, which the rank holds as its weights do, a
        paired cut (block ``tp.index`` of each half; the same bytes).  The
        LM keeps the layout (:class:`StateCut`) and decodes and prefills
        into states of this cut from then on."""
        from repro_torch.ft.elastic import local_slice
        names, sizes, coord = self._coords()
        specs = self.state_pspecs(state, self.mesh)
        self._cut = self._layout_of(state, specs)

        def cut(x, kind, spec):
            if kind == "kv" and self._headdim and _names(spec[-1]):
                x = _paired_cut(x, x.dim() - 1, self.tp.size, self.tp.index)
                spec = spec[:-1] + (None,)
            return local_slice(x, spec, names, sizes, coord).contiguous()
        return _map_state(cut, state, specs)

    def _layout_of(self, state: State, specs: Any) -> StateCut:
        """The :class:`StateCut` of a whole ``state`` cut by ``specs``: the
        caches' and the memory's :class:`~repro_torch.models.attention.
        KVLayout` each from its own leaf's spec (the divisibility guard
        may cut them differently)."""
        caches = state.get("caches", state.get("attn_caches"))
        if isinstance(caches, PagedKVCache):
            raise ValueError("the decode-state layout holds dense caches; "
                             "a paged state keeps the engine's layout")
        cspecs = specs.get("caches", specs.get("attn_caches"))
        mem = state.get("mem_k")
        return StateCut(
            specs, None if caches is None else self._kv_layout(cspecs.k),
            None if mem is None else self._kv_layout(specs["mem_k"]),
            0 if mem is None else mem.shape[2])

    def _kv_layout(self, spec: Any) -> Optional[KVLayout]:
        """The :class:`~repro_torch.models.attention.KVLayout` of a KV leaf
        ``[L, B, S, KVH, Dh]`` cut by ``spec``, for this rank's weights:
        the axes its sequence is cut over; the model axis to gather the
        new q/k/v's heads over where the weights split heads and the leaf
        holds every kv head; the head dim's under ``kv_shard="headdim"``.
        None where the rank attends as the engine's layout does."""
        from repro_torch.launch.mesh import DataAxis
        split = self.tp is not None and self.tp.size > 1
        heads_cut = "model" in _names(spec[3])
        if heads_cut and not (split and not self._headdim):
            raise ValueError("the state splits kv heads over the model axis "
                             "but this rank's weights hold every head")
        if self._headdim and "model" not in _names(spec[4]):
            raise ValueError("kv_shard='headdim' weights need the state's "
                             "head dim cut over the model axis")
        seq = [self._axis(a) for a in _names(spec[2])]
        kv = KVLayout(
            seq=DataAxis(seq) if any(a.size > 1 for a in seq) else None,
            heads=self.tp if split and not self._headdim and not heads_cut
            else None,
            head_dim=self.tp if self._headdim else None)
        return kv if any(kv) else None

    def _state_layout(self) -> Optional[StateCut]:
        """The layout of the states this LM decodes (:meth:`cut_state`),
        None without a mesh."""
        if self.mesh is None:
            return None
        if self._cut is None:
            raise ValueError("an LM with a mesh decodes its cut of a whole "
                             "state: cut the state with LM.cut_state first")
        return self._cut

    def _relaid(self, state: Any, specs: Any, cuts: Any,
                to_compute: bool, out: Any = None) -> Any:
        """The recurrent leaves of ``state`` moved between the
        decode-state layout (``specs``, :meth:`state_pspecs`) and the
        compute layout a step uses (``cuts``: per leaf the dim its heads
        split over the model axis and the :class:`~repro_torch.models.
        layers.ModelSplit` parts of a concatenated leaf, or None for a
        leaf the step holds whole).  To the compute layout: gathered over
        every axis the spec cuts (the batch's rows stay this rank's), then
        cut by heads; back: gathered over the model axis, then cut by the
        spec, into ``out``'s leaves in place.  Each gather is a declared
        all-gather."""
        from repro_torch.ft.elastic import gather_slice, local_slice
        names, sizes, coord = self._coords()
        axes = {a: self._axis(a) for a in names}
        tp = self.tp
        m = tp.size if tp is not None else 1

        def move(x, kind, spec, cut, *dst):
            dim, parts = cut if cut is not None else (None, None)
            if to_compute:
                full = gather_slice(x, spec, axes, skip=_names(spec[1]))
                if dim is None or m == 1:
                    return full
                if parts:
                    full = expand_split(full, ModelSplit(dim, parts), m)
                return full.chunk(m, dim)[tp.index].contiguous()
            full = x
            if dim is not None and m > 1:
                full = tp.all_gather(x, dim)
                if parts:
                    full = contract_split(full, ModelSplit(dim, parts), m)
            spec = tuple(None if i == 1 else e for i, e in enumerate(spec))
            dst[0].copy_(local_slice(full, spec, names, sizes, coord))
            return dst[0]
        others = (specs, cuts) if out is None else (specs, cuts, out)
        return _map_state(move, state, *others)

    def _recurrent_cuts(self) -> Any:
        """:meth:`_relaid`'s compute cuts of the recurrent state: the
        hybrid's SSD ``C``/``n`` by heads (dim 2) and its conv tail by its
        channels (dim 3, ``[x | B | C]`` with B and C whole); the mLSTM's
        ``C``/``n`` by heads; the sLSTM's whole."""
        if self.cfg.family == "hybrid":
            xbc = ssm_mod.tp_splits(self.cfg.mamba_config())["conv_b"].parts
            return {"ssd": ((2, None), (2, None)), "conv": (3, xbc)}
        return {"mlstm": ((2, None), (2, None)),
                "slstm": (None, None, None)}

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
        if cfg.family == "xlstm":
            for blk in (*self.mlstm, *self.slstm):
                blk.init(generator)
        elif cfg.family == "hybrid":
            for blk in self.mamba:
                blk.init(generator)
            self.shared_attn.init(generator)
        elif cfg.family == "encdec":
            for blk in (*self.encoder, *self.decoder):
                blk.init(generator)
        else:
            for blk in self.blocks:
                blk.init(generator)
        return self

    # ============================================================ backbone
    def _embed(self, tokens: torch.Tensor,
               patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings; for the vlm family ``patch_embeds`` [B, n, d]
        replace the first n (``repro/models/lm.py:242-250``)."""
        axis = self.tp if self._split(self.cfg.vocab) else None
        x = cast(embed_lookup(self.embed.table, tokens, axis), self.dtype)
        if self.cfg.family == "vlm" and patch_embeds is not None:
            n = patch_embeds.shape[1]
            if tokens.shape[1] < n:
                raise ValueError(
                    f"patch_embeds cover {n} positions but the prompts are "
                    f"{tokens.shape[1]} tokens: a vlm prompt holds its "
                    f"patch positions first")
            x = torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)
        return x

    def _embed_seq(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The training forward's embeddings: under sequence parallelism
        this rank's slice of the sequence, cut after the vlm family's
        patch merge (the M-RoPE positions are the whole sequence's, read
        from the tokens)."""
        x = self._embed(batch["tokens"], batch.get("patch_embeds"))
        return self.tp.split(x, 1) if self._sp else x

    def _vlm_positions3(self, tokens: torch.Tensor) -> torch.Tensor:
        """M-RoPE position streams [3,B,S] (``repro/models/lm.py:260-273``):
        the first ``n_patches`` positions take (0, h, w) on the patch
        grid, text continues 1-D from the grid's edge.  Computed from the
        width of ``tokens`` alone, so a suffix prefill restarts at 0."""
        cfg = self.cfg
        b, s = tokens.shape
        gh, gw = cfg.patch_grid
        gw = max(gw, 1)
        idx = torch.arange(s, device=tokens.device)
        is_text = idx >= cfg.n_patches
        t = torch.where(is_text, idx - cfg.n_patches + max(gh, gw), 0)
        h = torch.where(is_text, t, idx // gw)
        w = torch.where(is_text, t, idx % gw)
        return torch.stack([t, h, w])[:, None, :].expand(3, b, s)

    def _head(self, x: torch.Tensor, gather: bool = True) -> torch.Tensor:
        """Logits of the final hidden states; under a split vocab this
        rank's columns, gathered into whole rows unless ``gather`` is
        False (the vocab-parallel loss)."""
        sp = self.tp if self._sp else None
        x = tf_mod.apply_norm(x, self.final_norm, self.cfg.norm_eps, sp)
        w = (self.embed.table.T if self.cfg.tie_embeddings
             else self.lm_head.w)
        split = self._split(self.cfg.vocab)
        if sp is not None:
            # the sequence gathered: the head's rows are every position's
            x = sp.gather_seq(x, 1) if split else sp.all_gather(x, 1)
        elif split:
            x = self.tp.copy_in(x)
        logits = x @ cast(w, x.dtype)
        if split and gather:
            # the vocab-parallel head: gather whole rows, as GSPMD's
            # replicated logits are, so sampling sees every column
            logits = self.tp.all_gather(logits, dim=-1)
        return logits

    def _nll(self, logits: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        """logsumexp minus the gold logit per position, fp32; ``logits``
        this rank's vocab columns under a split vocab, where the row max,
        the sum of exponentials and the gold logit each reduce over the
        model axis (the max carries no gradient: it only shifts)."""
        labels = labels.clamp(min=0).long()
        if not self._split(self.cfg.vocab):
            gold = logits.gather(-1, labels[..., None])[..., 0]
            return torch.logsumexp(logits, dim=-1) - gold
        tp, n = self.tp, logits.shape[-1]
        mx = tp.all_reduce(logits.detach().amax(-1), op="max")
        lse = tp.all_reduce((logits - mx[..., None]).exp().sum(-1)).log() + mx
        local = labels - tp.index * n
        hit = (local >= 0) & (local < n)
        gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
        return lse - tp.all_reduce(gold * hit)

    # ============================================================== train
    def _backbone(self, x: torch.Tensor, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token embeddings -> final hidden states, no caches.  Returns
        (h, aux loss).  Under sequence parallelism ``x`` and ``h`` are this
        rank's slice of the sequence: the transformer blocks keep it
        between and inside them (:func:`~repro_torch.models.transformer.
        apply_block`), the hybrid's Mamba2 groups run on the gathered
        sequence between its shared blocks, and the xlstm and encdec
        backbones on the gathered sequence (the reference constrains only
        their embedding output and logits)."""
        cfg, feats = self.cfg, self.features
        fam = cfg.family
        sp = self.tp if self._sp else None
        if sp is not None and fam in ("xlstm", "encdec"):
            h, aux = self._backbone_whole(sp.all_gather(x, 1), batch)
            return sp.split(h, 1), aux
        if fam in KV_FAMILIES:
            pos3 = (self._vlm_positions3(batch["tokens"]) if fam == "vlm"
                    else None)
            return tf_mod.apply_stack(self.blocks, x, self.block_config(),
                                      feats, positions3=pos3)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if fam == "hybrid":
            mc, bc = self.mamba_config(), self.block_config()
            aux = zero
            for lo, hi in _hybrid_groups(cfg.n_layers, cfg.attn_every):
                x = x if sp is None else sp.all_gather(x, 1)
                x, a = tf_mod.apply_layers(
                    self.mamba[lo:hi], x,
                    lambda p, h: (ssm_mod.apply_mamba2_block(p, h, mc), zero),
                    feats)
                x = x if sp is None else sp.split(x, 1)
                x, a2 = tf_mod.apply_block(self.shared_attn, x, bc)
                aux = aux + a + a2
            return x, aux
        return self._backbone_whole(x, batch)

    def _backbone_whole(self, x: torch.Tensor,
                        batch: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The xlstm and encdec backbones over the whole sequence."""
        cfg, feats = self.cfg, self.features
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "xlstm":
            xc = self.xlstm_config()

            def pair(ms, h):
                h = xlstm_mod.apply_mlstm_block(ms[0], h, xc)
                return xlstm_mod.apply_slstm_block(ms[1], h, xc), zero

            return tf_mod.apply_layers(list(zip(self.mlstm, self.slstm)), x,
                                       pair, feats)
        ec = self.encdec_config()                    # encdec
        enc_cfg = ec._replace(attn=ec.attn._replace(causal=False))
        mem, _ = tf_mod.apply_layers(
            self.encoder, batch["src_embeds"].to(self.dtype),
            lambda p, h: (encdec_mod.apply_encoder_block(p, h, enc_cfg),
                          zero), feats)
        ln = self.enc_final_norm
        mem = layer_norm(mem, ln.scale, ln.bias, cfg.norm_eps)

        def dec_one(p, h):
            mk, mv = encdec_mod.cross_memory(p.cross, mem, ec.attn,
                                             ec.tp)
            return encdec_mod.apply_decoder_block(p, h, mk, mv, ec), zero

        x, _ = tf_mod.apply_layers(self.decoder, x, dec_one, feats)
        return x, zero

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits [B,S,V] over every position of ``batch["tokens"]`` (the
        vlm family's ``patch_embeds`` and the encdec family's
        ``src_embeds`` as in :meth:`prefill`)."""
        h, _ = self._backbone(self._embed_seq(batch), batch)
        return self._head(h)

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, {"ce", "aux", "ntok"}): the mean next-token cross
        entropy over labels ``>= 0`` (fp32) plus the aux loss; under a
        data axis the mean over the global batch (see the module
        note)."""
        if events.active():
            self._declare_train(batch)
        h, aux = self._backbone(self._embed_seq(batch), batch)
        logits = self._head(h, gather=False).float()
        labels = batch["labels"]
        weights = (labels >= 0).float()
        nll = self._nll(logits, labels) * weights
        total, n = nll.sum(), weights.sum()
        if self.dp is not None:
            total, n = self.dp.all_reduce(total), self.dp.all_reduce(n)
        ntok = torch.clamp(n, min=1.0)
        ce = total / ntok
        return ce + aux, {"ce": ce, "aux": aux, "ntok": ntok}

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
        dtype, one cache per shared-block application, and no pages.  The
        xlstm family's is ``{"mlstm": (C [P,B,H,dk,dv], n [P,B,H,dk]),
        "slstm": (c, n, h) each [P,B,D]}`` over its P = n_layers // 2
        pairs, fp32, with no KV and no pages.  The encdec family's is
        ``{"caches": KVCache, "mem_k", "mem_v"}``: the decoder's dense
        caches and the cross-attention memory [L,B,S_src,KVH,Dh] with
        ``S_src = max(max_seq // src_ratio, 1)``, which prefill replaces
        by the encoded source's (``repro/models/lm.py:424-431``)."""
        cfg = self.cfg
        ac = self.block_config().attn
        if page_size > 0 and cfg.family not in KV_FAMILIES:
            raise ValueError(
                f"paged KV caches need an attention-cache family, not "
                f"{cfg.family!r} (recurrent states have no pages to swap)")
        if kv_dtype is not None and page_size <= 0:
            raise ValueError("kv_dtype needs a paged KV cache "
                             "(page_size > 0)")
        if cfg.family == "xlstm":
            xc, pairs = self.xlstm_config(), cfg.n_layers // 2
            return {"mlstm": xlstm_mod.init_mlstm_state(
                        batch_size, xc, self.device, layers=pairs),
                    "slstm": xlstm_mod.init_slstm_state(
                        batch_size, xc, self.device, layers=pairs)}
        if cfg.family == "hybrid":
            groups = _hybrid_groups(cfg.n_layers, cfg.attn_every)
            return {"mamba": ssm_mod.init_mamba2_state(
                        batch_size, self.mamba_config(), self.device,
                        layers=cfg.n_layers),
                    "attn_caches": attn_mod.init_kv_cache(
                        batch_size, max_seq, ac, self.dtype, self.device,
                        layers=len(groups))}
        if cfg.family == "encdec":
            s_src = max(max_seq // cfg.src_ratio, 1)
            mem = torch.zeros((cfg.n_layers, batch_size, s_src,
                               ac.num_kv_heads, ac.head_dim),
                              dtype=self.dtype, device=self.device)
            return {"caches": attn_mod.init_kv_cache(
                        batch_size, max_seq, ac, self.dtype, self.device,
                        layers=cfg.n_layers),
                    "mem_k": mem, "mem_v": mem.clone()}
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

        The recurrent families (hybrid, xlstm) cannot mask a pad out of a
        running recurrent state, so they take neither: every row is
        prefilled at the full width of ``tokens`` (serve equal lengths, or
        one row at a time).  Neither does encdec, whose decoder runs pads
        as context in the JAX package (``repro/models/lm.py:509-514``).

        The vlm family takes ``batch["patch_embeds"]`` [B, n, d] (optional:
        the scheduler's admissions serve text only, as the JAX
        scheduler's do); the encdec family needs ``batch["src_embeds"]``
        [B, S_src, d].

        ``all_logits=True`` returns the head over every position, [B,S,V],
        instead of the last token's: the verify of speculative decoding
        (every suffix position's next-token distribution from one forward
        pass)."""
        tokens = batch["tokens"]
        lengths = batch.get("lengths")
        patch_embeds = batch.get("patch_embeds")
        x = self._embed(tokens, patch_embeds)
        fam = self.cfg.family
        if fam in ("hybrid", "xlstm", "encdec"):
            if lengths is not None or batch.get("prefix_len") is not None:
                why = ("its decoder runs pads as context" if fam == "encdec"
                       else "a recurrent state cannot mask a pad")
                raise ValueError(
                    f"the {fam} family prefills equal-length rows: it takes "
                    f"no lengths or prefix_len ({why})")
            layout = self._state_layout()
            if fam == "encdec":
                if "src_embeds" not in batch:
                    raise ValueError(
                        "the encdec family's prefill needs "
                        "batch['src_embeds'] [B, S_src, d_model], the "
                        "frontend stub's frame embeddings")
                src = batch["src_embeds"]
                x, new_state = self._encdec_prefill(x, src, state, layout)
                extra = src.numel()
            else:
                stack = (self._hybrid_stack if fam == "hybrid"
                         else self._xlstm_stack)
                x, new_state = stack(x, state, prefill=True, layout=layout)
                extra = 0
            if events.active():
                self._declare_ops(tokens, new_state, prefill=True,
                                  all_logits=all_logits, extra_elems=extra)
            return self._head(x if all_logits else x[:, -1]), new_state
        pos3 = self._vlm_positions3(tokens) if fam == "vlm" else None
        x, caches = tf_mod.apply_stack_decode(
            self.blocks, x, self._kv_block_config(state), state["caches"],
            block_fn=functools.partial(tf_mod.apply_block_prefill,
                                       lengths=lengths,
                                       prefix_len=batch.get("prefix_len"),
                                       positions3=pos3))
        if events.active():
            self._declare_ops(tokens, state, prefill=True,
                              all_logits=all_logits,
                              suffix="prefix_len" in batch,
                              extra_elems=(0 if patch_embeds is None
                                           else patch_embeds.numel()))
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
        if events.active():
            self._declare_ops(tokens, state, prefill=False)
        x = self._embed(tokens)
        if self.cfg.family in ("hybrid", "xlstm"):
            stack = (self._hybrid_stack if self.cfg.family == "hybrid"
                     else self._xlstm_stack)
            x, new_state = stack(x, state, prefill=False,
                                 layout=self._state_layout())
            return self._head(x)[:, 0], new_state
        if self.cfg.family == "encdec":
            x, new_state = self._encdec_decode(x, state,
                                               self._state_layout())
            return self._head(x)[:, 0], new_state
        x, caches = tf_mod.apply_stack_decode(
            self.blocks, x, self._kv_block_config(state), state["caches"])
        return self._head(x)[:, 0], {"caches": caches}

    def _kv_block_config(self, state: State) -> BlockConfig:
        """:meth:`block_config` with the caches' layout of ``state``
        (:meth:`_state_layout`; the engine's kv-head split without a
        mesh)."""
        layout = self._state_layout()
        bc = self.block_config()
        return bc if layout is None else bc._replace(kv=layout.kv)

    # ============================================================== sizes
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def num_active_params(self) -> int:
        """Per-token active params (MoE: routed top-k only)."""
        n = self.num_params()
        cfg = self.cfg
        if cfg.family != "moe":
            return n
        per_layer_all = (3 * cfg.d_model * cfg.d_ff * cfg.moe_experts
                         + cfg.d_model * cfg.moe_experts)
        n_dense = n - cfg.n_layers * per_layer_all
        return n_dense + cfg.n_layers * moe_mod.count_active_params(
            cfg.moe_config())

    # ===================================================== declared traffic
    @functools.cached_property
    def _weight_model(self) -> Tuple[int, int, int]:
        """(matmul elements a token multiplies, bytes of every weight but
        the embedding, bytes of the head's [d, V]), the encdec family's
        source weights left out (:meth:`_source_weights`).  The hybrid
        family's shared block counts once a step in bytes and once an
        application in FLOPs; an MoE layer's leaves count in bytes only
        (their FLOPs follow the capacity, :meth:`_moe_ops`)."""
        apps = (len(_hybrid_groups(self.cfg.n_layers, self.cfg.attn_every))
                if self.cfg.family == "hybrid" else 1)
        elems = nbytes = 0
        for name, p in self.named_parameters():
            if name == "embed.table" or self._source_weight(name):
                continue
            nbytes += p.numel() * p.element_size()
            if (name.rsplit(".", 1)[-1] in MATMUL_WEIGHTS
                    and ".moe." not in name):
                elems += p.numel() * (apps if name.startswith("shared_attn.")
                                      else 1)
        head = (self.cfg.d_model * self.local_vocab
                * self.embed.table.element_size())
        if not self.cfg.tie_embeddings:
            nbytes -= head
        return elems, nbytes, head

    @staticmethod
    def _source_weight(name: str) -> bool:
        """An encdec weight that multiplies source positions, read only at
        prefill: the encoder's, its final norm and the cross-attention's
        memory projections."""
        return (name.startswith(("encoder.", "enc_final_norm."))
                or name.endswith((".cross.wk", ".cross.wv")))

    @functools.cached_property
    def _source_weights(self) -> Tuple[int, int]:
        """(matmul elements a source position multiplies, bytes) of the
        encdec family's :meth:`_source_weight` leaves."""
        elems = nbytes = 0
        for name, p in self.named_parameters():
            if self._source_weight(name):
                nbytes += p.numel() * p.element_size()
                if name.rsplit(".", 1)[-1] in MATMUL_WEIGHTS:
                    elems += p.numel()
        return elems, nbytes

    def _declare_ops(self, tokens: torch.Tensor, state: State, *,
                     prefill: bool, all_logits: bool = False,
                     suffix: bool = False, extra_elems: int = 0) -> None:
        """Declare this call's plain PyTorch work (see the module note):
        no launch, its FLOPs and bytes, from shapes only.  ``extra_elems``
        counts the ``extra_batch`` input read (patch or source
        embeddings).  An encdec step also reads its cross-attention memory
        and multiplies every query against it; its prefill runs the
        source weights over every source position and writes the
        memory."""
        cfg = self.cfg
        b, s = tokens.shape
        isz = self.embed.table.element_size()
        elems, wbytes, hbytes = self._weight_model
        heads = b * s if all_logits else b
        vocab = self.local_vocab
        flops = 2.0 * (b * s * elems + heads * cfg.d_model * vocab)
        arg = (wbytes + hbytes + b * s * (cfg.d_model * isz + 4)
               + extra_elems * isz)
        out = heads * vocab * isz
        g = cfg.num_heads // cfg.num_kv_heads
        if cfg.family == "encdec":
            mem = state["mem_k"]
            s_src, L = mem.shape[2], mem.shape[0]
            mkvh, mdh = mem.shape[-2], mem.shape[-1]
            mem_bytes = 2 * L * b * s_src * mkvh * mdh * mem.element_size()
            flops += 4.0 * L * b * mkvh * g * s * s_src * mdh  # cross-attn
            arg += mem_bytes                            # the memory, read
            if prefill:
                s_elems, s_bytes = self._source_weights
                flops += 2.0 * b * s_src * s_elems
                arg += s_bytes
                out += mem_bytes                        # and written
        if cfg.family == "moe":
            moe_flops, moe_f32, buf = self._moe_ops(b * s)
            flops += moe_flops
            arg += buf                  # the [E, cap, D] buffers, read
            out += buf                  # and written
            events.record_ops(flops=moe_f32, arg_bytes=0, out_bytes=0,
                              f32=True)
        if cfg.family in ("hybrid", "xlstm"):
            rec_state = ((*state["mamba"]["ssd"], state["mamba"]["conv"])
                         if cfg.family == "hybrid"
                         else (*state["mlstm"], *state["slstm"]))
            rec = sum(t.numel() * t.element_size() for t in rec_state)
            arg += rec                  # the recurrent state, read
            out += rec                  # and written back
        if cfg.family == "xlstm":       # no KV cache
            events.record_ops(flops=flops, arg_bytes=arg, out_bytes=out,
                              f32=self.dtype == torch.float32)
            return
        caches = (state["attn_caches"] if cfg.family == "hybrid"
                  else state["caches"])
        # the kv heads and head dim the rank's cache holds (all of them
        # under the decode-state layout's sequence cut, the head-dim cut
        # under kv_shard="headdim")
        kvh, dh = caches[0].shape[-2], caches[0].shape[-1]
        h = kvh * g
        row_kv = kvh * dh * caches[0].element_size()   # one token, K or V
        layers = caches[0].shape[0]
        paged = isinstance(caches, attn_mod.PagedKVCache)
        scale = 4 if paged and caches.quantized else 0
        # a prefill into the decode-state layout writes the rank's whole
        # slice of the sequence (zeros past the prompt)
        written = (caches.k.shape[2] if prefill and not paged
                   and self.mesh is not None else s)
        out += 2 * layers * b * written * (row_kv + scale)  # K/V written
        if prefill and suffix:
            # the plain suffix prefill gathers every page the table lists
            ctx = caches.page_table.shape[1] * caches.page_size
            arg += 2 * layers * b * ctx * (row_kv + scale)
            flops += 4.0 * layers * b * h * s * (ctx + s) * dh
        elif not prefill and not paged:
            # masked dense decode: the whole K and V buffers, every row
            smax = caches.k.shape[2]
            arg += 2 * layers * b * smax * row_kv
            flops += 4.0 * layers * b * h * smax * dh
        events.record_ops(flops=flops, arg_bytes=arg, out_bytes=out,
                          f32=self.dtype == torch.float32)

    def _declare_train(self, batch: Dict[str, torch.Tensor]) -> None:
        """Declare one training step's model over ``batch`` (see the
        module note): no launch, its FLOPs and bytes, from shapes only."""
        cfg = self.cfg
        b, s = batch["tokens"].shape
        t = b * s
        ac = self.block_config().attn
        elems, wbytes, hbytes = self._weight_model
        fwd = 2.0 * (t * elems + t * cfg.d_model * self.local_vocab)
        arg = wbytes + hbytes
        # (query, key) pairs over the self-attention applications
        pairs = s * s * {"xlstm": 0, "hybrid": len(_hybrid_groups(
            cfg.n_layers, cfg.attn_every))}.get(cfg.family, cfg.n_layers)
        if cfg.family == "encdec":                  # + encoder and cross
            src = batch["src_embeds"].shape[1]
            s_elems, s_bytes = self._source_weights
            fwd += 2.0 * b * src * s_elems
            arg += s_bytes
            pairs += ((cfg.enc_layers or cfg.n_layers) * src * src
                      + cfg.n_layers * s * src)
        fwd += 4.0 * b * ac.num_heads * ac.head_dim * pairs
        if cfg.family == "moe":
            fwd += self._moe_ops(t)[0]
        passes = 4.0 if self.features.remat_policy == "full" else 3.0
        isz = self.embed.table.element_size()
        events.record_ops(
            flops=passes * fwd,
            arg_bytes=3 * arg + t * (cfg.d_model * isz + 8),
            out_bytes=arg, f32=self.dtype == torch.float32)

    def _encdec_prefill(self, x: torch.Tensor, src: torch.Tensor,
                        state: State, layout: Any = None
                        ) -> Tuple[torch.Tensor, State]:
        """The encdec prefill (``repro/models/lm.py:548-591``): the source
        through the encoder and its final LayerNorm, each decoder layer's
        memory K/V from it, then the decoder over the target tokens with
        its self-attention K/V written into the dense caches (in place).
        The returned state carries the new memory, re-laid into this
        rank's cut of the decode-state layout under one (``layout``,
        :meth:`_state_layout`); the layout's memory holds the state's
        ``S_src`` positions, so a source of another length is refused
        (padding would add keys the decode cannot mask)."""
        cfg = self.cfg
        kv = mem_kv = None
        if layout is not None:
            if src.shape[1] != layout.s_src:
                raise ValueError(
                    f"the decode-state layout holds a memory of "
                    f"{layout.s_src} source positions (max_seq // "
                    f"src_ratio), not {src.shape[1]}: prefill a source of "
                    f"the state's length, or without a mesh")
            kv, mem_kv = layout.kv, layout.mem
        ec = self.encdec_config()._replace(kv=kv)
        enc_cfg = ec._replace(attn=ec.attn._replace(causal=False))
        mem = src.to(self.dtype)
        for blk in self.encoder:
            mem = encdec_mod.apply_encoder_block(blk, mem, enc_cfg)
        mem = tf_mod.apply_norm(mem, self.enc_final_norm, cfg.norm_eps)
        caches: KVCache = state["caches"]
        new = caches
        mem_k, mem_v = [], []
        for i, blk in enumerate(self.decoder):
            mk, mv = encdec_mod.cross_memory(blk.cross, mem, ec.attn,
                                             ec.tp)
            x, new = encdec_mod.apply_decoder_block_prefill(
                blk, x, mk, mv, tf_mod._dense_layer(caches, i), ec)
            s_src = state["mem_k"].shape[2]
            mem_k.append(attn_mod.relay_kv(mk, mem_kv, s_src))
            mem_v.append(attn_mod.relay_kv(mv, mem_kv, s_src))
        return x, {"caches": caches._replace(length=new.length),
                   "mem_k": torch.stack(mem_k), "mem_v": torch.stack(mem_v)}

    def _encdec_decode(self, x: torch.Tensor, state: State,
                       layout: Any = None) -> Tuple[torch.Tensor, State]:
        """One token through every decoder layer: dense self-attention
        decode, then cross-attention over the layer's memory (this rank's
        cut of both under a ``layout``, :meth:`_state_layout`)."""
        ec = self.encdec_config()
        if layout is not None:
            ec = ec._replace(kv=layout.kv, mem_kv=layout.mem)
        caches: KVCache = state["caches"]
        new = caches
        for i, blk in enumerate(self.decoder):
            x, new = encdec_mod.apply_decoder_block_decode(
                blk, x, state["mem_k"][i], state["mem_v"][i],
                tf_mod._dense_layer(caches, i), ec)
        return x, dict(state, caches=caches._replace(length=new.length))

    def _moe_ops(self, t: int) -> Tuple[float, float, int]:
        """(FLOPs in the compute dtype, FLOPs in fp32, bytes of the
        ``[E, cap, D]`` buffers) of every MoE layer over ``t`` routed
        rows: the experts' three products over E * cap rows (the capacity,
        not the token count), the shared expert over every row, and the
        router and shared gate in fp32."""
        cfg = self.cfg
        mc = cfg.moe_config()
        moe = self.blocks[0].moe                 # this rank's experts
        d, f, e = cfg.d_model, cfg.d_ff, moe.w_gate.shape[0]
        cap = moe_mod._capacity(t, mc)
        flops = 2.0 * 3 * e * cap * d * f
        f32 = 2.0 * t * d * cfg.moe_experts
        if mc.num_shared_experts:
            flops += 2.0 * 3 * t * d * moe.shared_gate.shape[1]
            f32 += 2.0 * t * d
        buf = e * cap * d * self.embed.table.element_size()
        n = cfg.n_layers
        return n * flops, n * f32, n * buf

    def _xlstm_stack(self, x: torch.Tensor, state: State, prefill: bool,
                     layout: Any = None) -> Tuple[torch.Tensor, State]:
        """The xlstm backbone over a segment (prefill) or one token: each
        mLSTM/sLSTM pair in turn, from and into that pair's slice of the
        state.  The state is updated IN PLACE, pair by pair.  Under a
        decode-state ``layout`` (:meth:`_state_layout`) the state is
        re-laid into the compute layout first and cut back after
        (:meth:`_relaid`)."""
        if layout is not None:
            specs, cuts = layout.specs, self._recurrent_cuts()
            comp = self._relaid(state, specs, cuts, True)
            x, comp = self._xlstm_stack(x, comp, prefill)
            self._relaid(comp, specs, cuts, False, out=state)
            return x, state
        xc = self.xlstm_config()
        C, n = state["mlstm"]
        sc = state["slstm"]
        for i, (mp, sp) in enumerate(zip(self.mlstm, self.slstm)):
            m_st = (C[i], n[i])
            s_st = tuple(t[i] for t in sc)
            if prefill:
                x, m_new = xlstm_mod.apply_mlstm_block(
                    mp, x, xc, initial_state=m_st, return_state=True)
                x, s_new = xlstm_mod.apply_slstm_block(
                    sp, x, xc, initial_state=s_st, return_state=True)
            else:
                x, m_new = xlstm_mod.mlstm_decode(mp, x, xc, m_st)
                x, s_new = xlstm_mod.slstm_decode(sp, x, xc, s_st)
            for dst, src in zip((*m_st, *s_st), (*m_new, *s_new)):
                dst.copy_(src)
        return x, state

    def _hybrid_stack(self, x: torch.Tensor, state: State, prefill: bool,
                      layout: Any = None) -> Tuple[torch.Tensor, State]:
        """The hybrid backbone over a segment (prefill) or one token: each
        group of Mamba2 layers, then the shared block into the group's own
        KV cache.  The state is updated IN PLACE, layer by layer; the
        returned state carries the caches' new length.  Under a
        decode-state ``layout`` (:meth:`_state_layout`) the shared block
        attends its cut of the caches, and the Mamba2 state is re-laid
        into the compute layout first and cut back after
        (:meth:`_relaid`)."""
        cfg = self.cfg
        mc, bc = self.mamba_config(), self.block_config()
        ms = state["mamba"]
        if layout is not None:
            specs, cuts = layout.specs["mamba"], self._recurrent_cuts()
            bc = bc._replace(kv=layout.kv)
            held, ms = ms, self._relaid(ms, specs, cuts, True)
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
        if layout is not None:
            ms = self._relaid(ms, specs, cuts, False, out=held)
        return x, {"mamba": ms,
                   "attn_caches": caches._replace(length=new.length)}
