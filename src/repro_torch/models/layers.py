"""Numerics shared by the model zoo: the logical-axis sharding rules,
the tensor-parallel embedding, norms, the SwiGLU and GELU MLPs, RoPE and
M-RoPE, init.

Ported from ``repro/models/layers.py`` (RMSNorm and LayerNorm, both
computed in fp32).

**Sharding** (``repro/models/layers.py:44-184``).  Each model names the
dims of its weights with *logical* axes (``LM.param_specs()``);
:func:`logical_to_mesh` maps one weight's names onto mesh axes through a
:class:`ShardingRules` table, with the reference's divisibility guard
(a dim shards only if its size divides the product of its mesh axes, else
the longest prefix of them that does, else it replicates).  A spec is a
tuple with one entry per dim: a mesh-axis name, a tuple of names, or
None (the entries of the reference's ``PartitionSpec``).  GSPMD turns
those specs into partitioned programs; in the port every rank holds its
block of each weight (:func:`shard_params_tree`) and the model code does
the communication the layout implies: one reduce over ``model`` after
each row-parallel product (``wo``, the MLP's down projection), the
vocab-parallel lookup of :func:`embed_lookup`, and the gathered logits.
So :func:`constrain`, the reference's ``with_sharding_constraint``, only
resolves its spec here: the layout is the code's.

Weights are cast to the activations' dtype at every use (:func:`cast`),
as the reference casts its fp32 masters: a serving model stores them in
the compute dtype already (the cast is then the tensor itself, no
launch), a training model keeps fp32 masters and computes in bf16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ShardingRules", "DEFAULT_RULES", "logical_to_mesh",
           "spec_tree_to_pspecs", "shard_params_tree", "fit_spec",
           "ModelSplit", "split_spec", "expand_split", "contract_split",
           "whole_part_mask", "constrain",
           "embed_lookup", "cast", "truncated_normal_", "rms_norm",
           "layer_norm", "swiglu", "gelu_mlp", "rope_freqs", "apply_rope",
           "apply_mrope"]

#: one weight's mesh layout: per dim a mesh axis, a tuple of them or None
Spec = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# Logical-axis sharding
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> physical mesh axis (or None = replicated).

    The **policy knobs** of the distribution layer:

    * ``batch -> (pod, data)``: DP across pods and the data axis.
    * ``embed -> data``: FSDP — weight matrices sharded on their d_model dim
      over the data axis.
    * ``ff / heads / vocab / experts -> model``: TP / EP.
    * ``act_seq -> model`` when ``sequence_parallel`` (SP).
    """

    rules: Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...]

    def lookup(self, logical: str) -> Optional[Tuple[str, ...]]:
        for name, phys in self.rules:
            if name == logical:
                return phys
        return None

    def replace(self, **kw: Optional[Tuple[str, ...]]) -> "ShardingRules":
        rules = tuple((k, kw.get(k, v)) for k, v in self.rules)
        extra = tuple((k, v) for k, v in kw.items()
                      if k not in dict(self.rules))
        return ShardingRules(rules + extra)


DEFAULT_RULES = ShardingRules(rules=(
    ("batch", ("pod", "data")),
    ("act_seq", None),            # set to ("model",) for sequence parallelism
    ("act_embed", None),
    ("embed", ("data",)),         # FSDP shard of params' d_model dims
    ("ff", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("head_dim", None),
    ("qkv", None),
    ("vocab", ("model",)),
    ("experts", ("model",)),
    ("expert_ff", None),
    ("layers", None),
    ("seq", None),                # data-side sequence dim (inputs)
    # KV-cache sequence: takes whatever mesh axes the batch dim left free
    ("cache_seq", ("data", "model")),
    ("state", None),
    ("conv", None),
    # MoE dispatch tensors: None = let the partitioner propagate
    ("moe_tokens", None),
    ("moe_capacity", None),
))


def _axis_sizes(mesh: Any) -> Dict[str, int]:
    from repro_torch.launch.mesh import mesh_layout
    names, sizes = mesh_layout(mesh)
    return dict(zip(names, sizes))


def logical_to_mesh(logical_axes: Sequence[Optional[str]],
                    rules: ShardingRules, mesh: Any,
                    dim_sizes: Optional[Sequence[int]] = None) -> Spec:
    """Map one array's logical axes to a spec.

    Divisibility guard: a dim is only sharded if its size divides the mesh
    axes product (else replicated, or the longest prefix that divides) —
    this is what lets 14-head and 60-expert configs run on a 16-wide model
    axis without silent padding."""
    sizes = _axis_sizes(mesh)
    used: set = set()
    spec = []
    for i, ax in enumerate(logical_axes):
        phys = rules.lookup(ax) if ax else None
        if not phys:
            spec.append(None)
            continue
        phys = tuple(p for p in phys if p in sizes and p not in used)
        if not phys:
            spec.append(None)
            continue
        total = int(np.prod([sizes[p] for p in phys]))
        if dim_sizes is not None and dim_sizes[i] % total != 0:
            while phys and dim_sizes[i] % int(
                    np.prod([sizes[p] for p in phys])) != 0:
                phys = phys[:-1]
            if not phys:
                spec.append(None)
                continue
        used.update(phys)
        spec.append(phys if len(phys) > 1 else phys[0])
    return tuple(spec)


def spec_tree_to_pspecs(specs: Mapping[str, Any], rules: ShardingRules,
                        mesh: Any, shapes: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, Any]:
    """Map a whole logical-spec tree (nested mappings, tuple leaves) to
    specs; ``shapes`` (the same keys, leaves with a ``.shape``) turns on
    the divisibility guard."""
    def walk(s, shp):
        if isinstance(s, Mapping):
            return {k: walk(v, None if shp is None else shp[k])
                    for k, v in s.items()}
        return logical_to_mesh(s, rules, mesh, dim_sizes=(
            None if shp is None else tuple(shp.shape)))
    return walk(specs, shapes)


def shard_params_tree(params: Mapping[str, Any], specs: Mapping[str, Any],
                      rules: ShardingRules, mesh: Any,
                      device: Optional[torch.device] = None
                      ) -> Optional[Dict[str, Any]]:
    """This rank's block of every weight under its derived spec (the
    reference device_puts the tree with its shardings): full tensors in,
    contiguous local slices on ``device`` out; None off the mesh."""
    from repro_torch.ft.elastic import reshard_tree
    pspecs = spec_tree_to_pspecs(specs, rules, mesh, shapes=params)
    return reshard_tree(params, pspecs, mesh, device)


def fit_spec(spec: Spec, full_shape: Sequence[int],
             local_shape: Sequence[int], axis: str = "model") -> Spec:
    """``spec`` with ``axis`` taken off every dim that a rank's module
    holds whole (its ``local_shape`` equals the full one there): the
    layout a rank's tensor-parallel LM really keeps, where it departs
    from the derived spec (the MoE router, kept whole on every rank of
    the model axis)."""
    out = []
    for entry, full, local in zip(spec, full_shape, local_shape):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if axis in names and local == full:
            names = tuple(a for a in names if a != axis)
        out.append(None if not names else
                   names[0] if len(names) == 1 else names)
    return tuple(out)


class ModelSplit(NamedTuple):
    """How a rank's tensor-parallel module holds one leaf where that
    departs from the derived spec: ``dim`` is the dim split over
    ``model`` (None: the leaf is whole on every rank), made of ``parts``
    concatenated, each ``(size, split)``: a split part gives each rank
    its block, a whole part is on every rank.  Mamba2's ``in_proj``
    columns ``[z | x | B | C | dt]`` hold ``z``, ``x`` and ``dt`` by heads
    and ``B``, ``C`` whole, so a rank keeps ``[z_r | x_r | B | C |
    dt_r]``."""

    dim: Optional[int]
    parts: Tuple[Tuple[int, bool], ...] = ()


def split_spec(spec: Spec, split: ModelSplit) -> Spec:
    """``spec`` with ``model`` moved to ``split.dim`` (or taken off)."""
    out = [tuple(a for a in ((e,) if isinstance(e, str) else (e or ()))
                 if a != "model") for e in spec]
    if split.dim is not None:
        if out[split.dim]:
            raise ValueError(f"dim {split.dim} of {spec} splits over "
                             f"{out[split.dim]} and model both")
        out[split.dim] = ("model",)
    return tuple(None if not e else e[0] if len(e) == 1 else e for e in out)


def _part_pieces(x: torch.Tensor, split: ModelSplit):
    """(piece, split) of each part along ``split.dim``."""
    sizes = [n for n, _ in split.parts] or [x.shape[split.dim]]
    flags = [s for _, s in split.parts] or [True]
    return list(zip(x.split(sizes, dim=split.dim), flags))


def expand_split(full: torch.Tensor, split: ModelSplit, m: int
                 ) -> torch.Tensor:
    """The whole leaf as the ``m`` ranks' blocks side by side along
    ``split.dim`` (each rank's split parts, then its copy of the whole
    ones, in part order), so that a contiguous cut over ``model`` gives
    each rank its block.  The leaf itself when it has one part."""
    if split.dim is None or len(split.parts) <= 1 or m == 1:
        return full
    pieces = _part_pieces(full, split)
    return torch.cat([p.chunk(m, dim=split.dim)[r] if s else p
                      for r in range(m) for p, s in pieces], dim=split.dim)


def contract_split(blocks: torch.Tensor, split: ModelSplit, m: int
                   ) -> torch.Tensor:
    """The inverse of :func:`expand_split`: the ranks' blocks side by
    side back into the whole leaf (a whole part from rank 0's block)."""
    if split.dim is None or len(split.parts) <= 1 or m == 1:
        return blocks
    d = split.dim
    local = ModelSplit(d, tuple((n // m if s else n, s)
                                for n, s in split.parts))
    per = [_part_pieces(b, local)
           for b in blocks.chunk(m, dim=d)]
    out = []
    for j, (_, s) in enumerate(split.parts):
        out.append(torch.cat([per[r][j][0] for r in range(m)], dim=d)
                   if s else per[0][j][0])
    return torch.cat(out, dim=d)


def whole_part_mask(split: ModelSplit, m: int,
                    local_shape: Sequence[int]) -> torch.Tensor:
    """A 0/1 mask over a rank's block of a leaf split into ``parts``: 1
    on its split parts, 0 on its copies of the whole parts (which count
    once over the model axis, at index 0)."""
    flags = torch.cat([torch.full((n // m if s else n,), float(s))
                       for n, s in split.parts])
    shape = [1] * len(local_shape)
    shape[split.dim] = flags.numel()
    return flags.view(shape)


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]],
              rules: ShardingRules, mesh: Any,
              soft: bool = False) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names.  A
    layout hint changes no value, and each rank of the port computes on
    its own block, so ``x`` comes back as it is once its spec resolves
    (no-op without a mesh)."""
    del soft
    if mesh is not None:
        logical_to_mesh(logical_axes, rules, mesh, dim_sizes=tuple(x.shape))
    return x


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 axis: Any = None) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``; with a model ``axis`` the table
    is this rank's vocab block ``[V / m, d]``: tokens outside it take zero
    rows, then one sum over the axis gives every rank every row (exact:
    each row is one rank's value plus zeros)."""
    ids = tokens.long()
    if axis is None:
        return table[ids]
    n = table.shape[0]
    local = ids - axis.index * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    return axis.all_reduce(rows)


def cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` in ``dtype``: the tensor itself when it is already (no copy,
    no launch), else a cast that autograd sees (its gradient returns in
    ``w``'s dtype, so a master's gradients sum in fp32)."""
    return w if w.dtype == dtype else w.to(dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def truncated_normal_(t: torch.Tensor, stddev: float = 0.02,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Fill ``t`` in place from N(0, stddev^2) truncated to +-2 stddev.

    Inverse-CDF sampling in fp32 on ``t``'s device (the generator must live
    there too), then one cast to ``t``'s dtype.  The same distribution as
    ``jax.random.truncated_normal(-2, 2) * stddev``; not the same numbers.
    """
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    u.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    u.erfinv_().mul_(stddev * math.sqrt(2.0)).clamp_(-2.0 * stddev,
                                                     2.0 * stddev)
    with torch.no_grad():
        t.copy_(u)
    return t


# ---------------------------------------------------------------------------
# Forward primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in fp32 (mean, then the variance about it),
    cast back to ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) ), weights cast to x's
    dtype."""
    dt = x.dtype
    return (F.silu(x @ cast(w_gate, dt)) * (x @ cast(w_up, dt))) \
        @ cast(w_down, dt)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             b_up: Optional[torch.Tensor], w_down: torch.Tensor,
             b_down: Optional[torch.Tensor]) -> torch.Tensor:
    """GELU MLP with optional biases: down(gelu(x@up + b_up)) + b_down.
    ``jax.nn.gelu`` defaults to the tanh approximation, so this uses it
    too (the exact erf form differs by ~1e-3)."""
    dt = x.dtype
    h = x @ cast(w_up, dt)
    if b_up is not None:
        h = h + cast(b_up, dt)
    y = F.gelu(h, approximate="tanh") @ cast(w_down, dt)
    if b_down is not None:
        y = y + cast(b_down, dt)
    return y


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim//2], fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               pairs: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Half-split rotary embedding.  x: [..., S, H, Dh]; positions: [..., S]
    integer, per row.  Computed in fp32, cast back to ``x``'s dtype.

    ``pairs=(m, r)``: x's last dim is a rank's paired cut of a head dim
    ``m`` times as wide (``kv_shard="headdim"``): the ``r``-th of ``m``
    blocks of the first half followed by the same block of the second,
    so every dim's rotation partner is on the rank and only the
    frequencies are the block's."""
    dh = x.shape[-1]
    if pairs is None:
        inv = rope_freqs(dh, theta, x.device)                    # [Dh/2]
    else:
        m, r = pairs
        inv = rope_freqs(dh * m, theta, x.device)[r * dh // 2:
                                                  (r + 1) * dh // 2]
    ang = positions[..., None].float() * inv                     # [..., S, Dh/2]
    cos = torch.cos(ang)[..., None, :]                           # broadcast heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, int, int],
                theta: float = 10000.0) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): the head dim's frequency pairs split across the
    (temporal, height, width) position streams.

    x: [..., S, H, Dh]; positions3: [3, ..., S] (t/h/w positions per
    token).  ``sections`` gives the number of frequency pairs per stream,
    ``sum(sections) == Dh // 2``.  Text tokens carry t == h == w, so
    M-RoPE reduces to 1-D RoPE for them.  Computed in fp32, cast back to
    ``x``'s dtype."""
    dh = x.shape[-1]
    assert sum(sections) == dh // 2, (sections, dh)
    inv = rope_freqs(dh, theta, x.device)                        # [Dh/2]
    # each frequency band reads its own stream: the first sections[0]
    # pairs t, the next sections[1] h, the last sections[2] w
    pos = torch.cat([positions3[i][..., None].float().expand(
        *positions3.shape[1:], n) for i, n in enumerate(sections)],
        dim=-1)                                          # [..., S, Dh/2]
    ang = pos * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
