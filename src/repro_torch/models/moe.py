"""Mixture-of-Experts MLP: top-k router, capacity dispatch, shared experts.

Port of ``repro/models/moe.py`` for serving: qwen2-moe-a2.7b (60 routed
experts, top-4, plus one fused shared-expert SwiGLU behind a sigmoid
gate) and qwen3-moe-235b-a22b (128 routed experts, top-8, no shared
expert).

Dispatch is capacity-based scatter/gather, as in the JAX package: each
(token, k) assignment takes the next slot of its expert's ``[cap, D]``
buffer (an exclusive cumsum over the token-major ``[T*K, E]`` assignment
matrix), assignments past ``cap`` are dropped, the three expert products
run as batched matrix products over the ``[E, cap, D]`` buffer, and the
outputs are gathered back and combined with the renormalised gate
weights.  Every routed row takes capacity, pads and idle rows included,
exactly as the reference routes them.  ``cap`` is a Python int from
shapes alone and the dispatch uses no data-dependent shape, so a decode
step through it makes no host sync.

The router and ``shared_coef`` stay fp32 in a bf16 model
(:data:`FP32_LEAVES`) and routing runs in fp32; the gate weights and the
shared gate are cast to the compute dtype before they multiply, as the
JAX package casts them.

**Sharding** (``repro/models/moe.py:61-73``, the rule ``experts ->
model``).  :func:`moe_specs` names the leaves' logical axes.  GSPMD turns
the reference's expert-sharded einsums into all-to-alls; the port is SPMD
over the model axis (``tp``) instead: every rank of a model line holds
the line's tokens and computes the whole routing (router, top-k, capacity
slots, aux loss; the router is small and stays whole on every rank, a
departure from its ``experts -> model`` spec), fills and multiplies only
its ``E / m`` experts' ``[E / m, cap, D]`` buffers, and runs its ``ff``
block of the shared expert; one reduce over ``model`` sums both.  Where
the divisibility guard leaves the experts (or the shared expert) whole,
every rank computes that part whole and adds it after the reduce, never
``m`` times.  Under the data axis (``dp``, training) the capacity is the
global batch's, each rank's slots start after the earlier data ranks'
assignments to the same expert (an exclusive scan of their all-gathered
per-expert counts, the reference's one cumsum over global token order),
and the aux loss's two means are over the global batch, so the same
tokens drop as in the reference.  ``constrain_fn`` is the reference's
GSPMD layout hint: accepted, and it changes no value.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import cast, truncated_normal_

__all__ = ["MoEConfig", "MoE", "Routing", "route", "moe_mlp",
           "moe_specs", "count_active_params", "FP32_LEAVES"]

#: leaves kept in fp32 whatever the model's dtype (``init_moe`` makes both
#: fp32 and the reference computes with them in fp32)
FP32_LEAVES = ("router", "shared_coef")


class MoEConfig(NamedTuple):
    d_model: int
    d_ff_expert: int            # per-expert FFN width
    num_experts: int            # routed experts
    top_k: int
    num_shared_experts: int = 0 # always-on experts (qwen2-moe: 4)
    d_ff_shared: int = 0        # width of the fused shared-expert FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


def _shared_width(cfg: MoEConfig) -> int:
    return cfg.d_ff_shared or cfg.d_ff_expert * cfg.num_shared_experts


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    cap = int(math.ceil(tokens * cfg.top_k * cfg.capacity_factor
                        / cfg.num_experts))
    return max(cap, cfg.top_k)


def _split(n: int, tp) -> int:
    """What a rank of model axis ``tp`` holds of a dim of size ``n``: its
    block where the axis divides ``n``, else all of it (the divisibility
    guard of ``logical_to_mesh``)."""
    return n // tp.size if tp is not None and n % tp.size == 0 else n


def moe_specs(cfg: MoEConfig) -> dict:
    """Logical axes of each MoE leaf (the reference's ``moe_specs``)."""
    s = {
        "router": ("embed", "experts"),
        "w_gate": ("experts", "embed", "expert_ff"),
        "w_up": ("experts", "embed", "expert_ff"),
        "w_down": ("experts", "expert_ff", "embed"),
    }
    if cfg.num_shared_experts:
        s["shared_gate"] = ("embed", "ff")
        s["shared_up"] = ("embed", "ff")
        s["shared_down"] = ("ff", "embed")
        s["shared_coef"] = ("embed", None)
    return s


def _block_cumsum_positions(flat: torch.Tensor, n_blocks: int = 256
                            ) -> torch.Tensor:
    """Exclusive cumsum over the token axis of a ``[T*K, E]`` assignment
    matrix, in blocks: per-block cumsums plus a ``[n_blocks, E]`` pass
    over the block totals (``repro/models/moe.py:82-100``).  The same
    result as the flat cumsum; :func:`moe_mlp` never calls it, as the
    reference's never does."""
    tk, e = flat.shape
    blk = -(-tk // n_blocks)
    fb = F.pad(flat, (0, 0, 0, n_blocks * blk - tk)).reshape(
        n_blocks, blk, e)
    within = fb.cumsum(1) - fb                               # exclusive
    block_tot = fb.sum(1)                                    # [Nblk, E]
    offs = block_tot.cumsum(0) - block_tot                   # exclusive
    pos = within + offs[:, None, :]
    return pos.reshape(n_blocks * blk, e)[:tk]


class MoE(nn.Module):
    """``init_moe``'s leaves under the same names: ``router [d,E]``,
    ``w_gate``/``w_up [E,d,f]``, ``w_down [E,f,d]`` and, with shared
    experts, ``shared_gate``/``shared_up [d,fs]``, ``shared_down [fs,d]``
    and ``shared_coef [d,1]``.  Under a model axis ``tp`` a rank holds
    its ``E / m`` experts and its ``fs / m`` block of the shared expert
    where the axis divides them (the router and ``shared_coef`` whole)."""

    def __init__(self, cfg: MoEConfig, dtype: torch.dtype,
                 device: torch.device, tp=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff_expert
        e = _split(cfg.num_experts, tp)

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.router = param(d, cfg.num_experts, dt=torch.float32)
        self.w_gate = param(e, d, f)
        self.w_up = param(e, d, f)
        self.w_down = param(e, f, d)
        if cfg.num_shared_experts:
            fs = _split(_shared_width(cfg), tp)
            self.shared_gate = param(d, fs)
            self.shared_up = param(d, fs)
            self.shared_down = param(fs, d)
            self.shared_coef = param(d, 1, dt=torch.float32)

    def init(self, generator: Optional[torch.Generator]) -> None:
        """``init_moe``'s distributions: truncated normals with std
        1/sqrt(d), 1/sqrt(f) for ``w_down`` and 1/sqrt(fs) for
        ``shared_down``."""
        d, f = self.w_gate.shape[1], self.w_gate.shape[2]
        for w in (self.router, self.w_gate, self.w_up):
            truncated_normal_(w, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.w_down, 1.0 / math.sqrt(f), generator)
        if hasattr(self, "shared_coef"):
            fs = self.shared_down.shape[0]
            for w in (self.shared_gate, self.shared_up, self.shared_coef):
                truncated_normal_(w, 1.0 / math.sqrt(d), generator)
            truncated_normal_(self.shared_down, 1.0 / math.sqrt(fs),
                              generator)


class Routing(NamedTuple):
    """One call's routing: ``gate [T,K]`` (fp32, renormalised), ``idx
    [T,K]`` the experts, ``pos [T*K]`` each assignment's slot in its
    expert's buffer, ``keep [T*K]`` ``pos < cap``, ``aux`` the Switch
    load-balancing loss and ``cap`` the buffer depth."""
    gate: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    cap: int


def _one_hot(i: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot rows of ``i``, by a scatter (``F.one_hot`` checks its
    classes on the host on some devices)."""
    out = torch.zeros(*i.shape, n, dtype=torch.int64, device=i.device)
    return out.scatter_(-1, i[..., None], 1)


def route(m: MoE, xt: torch.Tensor, cfg: MoEConfig, dp=None) -> Routing:
    """The fp32 router over ``xt [T,D]``: softmax, top-k (the lower index
    first on equal probabilities, as ``jax.lax.top_k``), renormalisation,
    the aux loss and each assignment's capacity slot.  Under a data axis
    ``dp`` the rows are this rank's share of the batch: the capacity, the
    slots and the aux loss are the global batch's (see the module
    note)."""
    t, e, k = xt.shape[0], cfg.num_experts, cfg.top_k
    tg = t * (dp.size if dp is not None else 1)
    cap = _capacity(tg, cfg)
    probs = torch.softmax(xt.float() @ m.router, dim=-1)          # [T,E]
    # a stable descending sort keeps equal probabilities in index order;
    # torch.topk promises no order among ties
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True)
    top1 = _one_hot(idx[:, 0], e).float()
    if dp is None:
        me, ce = probs.mean(0), top1.mean(0)
    else:
        me = dp.all_reduce(probs.sum(0)) / tg
        ce = dp.all_reduce(top1.sum(0)) / tg
    aux = cfg.router_aux_weight * e * (me * ce).sum()
    # token-major, then k: the order in which assignments take slots.
    # The one-hot is laid out [E, T*K] so the cumsum runs along its last
    # dim (a scan over the outer dim walks each column in one thread)
    eid = idx.reshape(t * k)
    flat = torch.zeros(e, t * k, dtype=torch.int64, device=xt.device)
    flat.scatter_(0, eid[None], 1)
    pos = (flat.cumsum(1) - flat).gather(0, eid[None])[0]
    if dp is not None and dp.size > 1:
        # the earlier data ranks' assignments take each expert's first
        # slots: an exclusive scan of their per-expert counts
        counts = dp.all_gather(flat.sum(1)[None], dim=0)          # [D,E]
        pos = pos + counts[:dp.index].sum(0)[eid]
    return Routing(gate, idx, pos, pos < cap, aux.float(), cap)


def moe_mlp(m: MoE, x: torch.Tensor, cfg: MoEConfig, constrain_fn=None,
            *, tp=None, dp=None, sp: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (out [B,S,D], aux loss, fp32 scalar), the semantics of
    ``repro.models.moe.moe_mlp``.  The three expert products are batched
    matrix products over the ``[E, cap, D]`` buffer (this rank's
    ``[E / m, cap, D]`` under a model axis ``tp``; ``dp`` the data axis:
    see the module note).  Under sequence parallelism (``sp``) ``x`` is
    the whole sequence every rank gathered (the capacity and the aux loss
    are the whole call's tokens) and the output is this rank's slice of
    it: the split parts reduce-scattered, a whole part cut."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.num_experts, cfg.top_k
    dt = x.dtype
    cst = constrain_fn or (lambda a, axes: a)
    xt = x.reshape(t, d)
    r = route(m, xt, cfg, dp)
    cap = r.cap
    eid = r.idx.reshape(t * k)
    el = m.w_gate.shape[0]
    split_e = el < e
    split_s = (cfg.num_shared_experts
               and m.shared_gate.shape[1] < _shared_width(cfg))
    # the rank's split parts see the replicated rows through copy_in
    x_in = tp.copy_in(xt) if split_e or split_s else xt
    gate = r.gate.reshape(t * k)
    if split_e:
        lo = tp.index * el
        mine = r.keep & (eid >= lo) & (eid < lo + el)
        w = tp.copy_in(gate) * mine
        slot = torch.where(mine, (eid - lo) * cap + r.pos, 0)
        src = x_in.repeat_interleave(k, dim=0) * mine[:, None].to(dt)
    else:
        # routing weights combine in the compute dtype, as the reference
        # does
        w = gate * r.keep
        # scatter: a dropped assignment adds zeros to its expert's last
        # slot
        slot = eid * cap + torch.where(r.keep, r.pos, cap - 1)    # [T*K]
        src = xt.repeat_interleave(k, dim=0) * r.keep[:, None].to(dt)
    w = w.to(dt)
    src = cst(src, ("moe_tokens", "embed"))
    buf = torch.zeros(el * cap, d, dtype=dt, device=x.device)
    buf.index_add_(0, slot, src)
    buf = cst(buf.view(el, cap, d), ("experts", "moe_capacity", "embed"))
    g = torch.bmm(buf, cast(m.w_gate, dt))
    u = torch.bmm(buf, cast(m.w_up, dt))
    out_buf = cst(torch.bmm(F.silu(g) * u, cast(m.w_down, dt)),
                  ("experts", "moe_capacity", "embed")).view(el * cap, d)
    # gather back and combine with the gate weights
    gathered = cst(out_buf.index_select(0, slot), ("moe_tokens", "embed"))
    out = (gathered * w[:, None]).view(t, k, d).sum(1)
    parts = [(out, split_e)]
    if cfg.num_shared_experts:
        xs = x_in if split_s else xt
        sh = (F.silu(xs @ cast(m.shared_gate, dt))
              * (xs @ cast(m.shared_up, dt))) @ cast(m.shared_down, dt)
        coef = torch.sigmoid(xt.float() @ m.shared_coef)
        if split_s:
            coef = tp.copy_in(coef)
        parts.append((sh * coef.to(dt), split_s))
    parts = [(p.view(b, s, d), split) for p, split in parts]
    return _sum_parts(parts, tp, sp), r.aux


def _sum_parts(parts, tp, sp: bool = False) -> torch.Tensor:
    """The routed and shared outputs, ``(tensor, split)`` pairs of
    ``[B,S,D]``, summed: the split ones are partial sums over the model
    axis, reduced once (reduce-scattered over the sequence under ``sp``);
    a part every rank computes whole is added after the reduce (its
    slice under ``sp``)."""
    partial = [p for p, split in parts if split]
    out = None
    if partial:
        total = sum(partial[1:], partial[0])
        out = tp.reduce_scatter(total, 1) if sp else tp.all_reduce(total)
    for p, split in parts:
        if not split:
            p = tp.split(p, 1) if sp else p
            out = p if out is None else out + p
    return out


def count_active_params(cfg: MoEConfig) -> int:
    """Per-token active params in this MoE layer (for 6*N_active*D)."""
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    active = cfg.top_k * per_expert + cfg.d_model * cfg.num_experts
    if cfg.num_shared_experts:
        active += 3 * cfg.d_model * _shared_width(cfg) + cfg.d_model
    return active
