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
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import cast, truncated_normal_

__all__ = ["MoEConfig", "MoE", "Routing", "route", "moe_mlp",
           "count_active_params", "FP32_LEAVES"]

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


class MoE(nn.Module):
    """``init_moe``'s leaves under the same names: ``router [d,E]``,
    ``w_gate``/``w_up [E,d,f]``, ``w_down [E,f,d]`` and, with shared
    experts, ``shared_gate``/``shared_up [d,fs]``, ``shared_down [fs,d]``
    and ``shared_coef [d,1]``."""

    def __init__(self, cfg: MoEConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.num_experts

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.router = param(d, e, dt=torch.float32)
        self.w_gate = param(e, d, f)
        self.w_up = param(e, d, f)
        self.w_down = param(e, f, d)
        if cfg.num_shared_experts:
            fs = _shared_width(cfg)
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


def route(m: MoE, xt: torch.Tensor, cfg: MoEConfig) -> Routing:
    """The fp32 router over ``xt [T,D]``: softmax, top-k (the lower index
    first on equal probabilities, as ``jax.lax.top_k``), renormalisation,
    the aux loss and each assignment's capacity slot."""
    t, e, k = xt.shape[0], cfg.num_experts, cfg.top_k
    cap = _capacity(t, cfg)
    probs = torch.softmax(xt.float() @ m.router, dim=-1)          # [T,E]
    # a stable descending sort keeps equal probabilities in index order;
    # torch.topk promises no order among ties
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True)
    me = probs.mean(0)
    ce = _one_hot(idx[:, 0], e).float().mean(0)
    aux = cfg.router_aux_weight * e * (me * ce).sum()
    # token-major, then k: the order in which assignments take slots.
    # The one-hot is laid out [E, T*K] so the cumsum runs along its last
    # dim (a scan over the outer dim walks each column in one thread)
    eid = idx.reshape(t * k)
    flat = torch.zeros(e, t * k, dtype=torch.int64, device=xt.device)
    flat.scatter_(0, eid[None], 1)
    pos = (flat.cumsum(1) - flat).gather(0, eid[None])[0]
    return Routing(gate, idx, pos, pos < cap, aux.float(), cap)


def moe_mlp(m: MoE, x: torch.Tensor, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (out [B,S,D], aux loss, fp32 scalar), the semantics of
    ``repro.models.moe.moe_mlp``.  The three expert products are batched
    matrix products over the ``[E, cap, D]`` buffer."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.num_experts, cfg.top_k
    xt = x.reshape(t, d)
    r = route(m, xt, cfg)
    cap = r.cap
    eid = r.idx.reshape(t * k)
    # routing weights combine in the compute dtype, as the reference does
    w = (r.gate.reshape(t * k) * r.keep).to(x.dtype)
    # scatter: a dropped assignment adds zeros to its expert's last slot
    slot = eid * cap + torch.where(r.keep, r.pos, cap - 1)        # [T*K]
    src = xt.repeat_interleave(k, dim=0) * r.keep[:, None].to(x.dtype)
    buf = torch.zeros(e * cap, d, dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, src)
    buf = buf.view(e, cap, d)
    dt = x.dtype
    g = torch.bmm(buf, cast(m.w_gate, dt))
    u = torch.bmm(buf, cast(m.w_up, dt))
    out_buf = torch.bmm(F.silu(g) * u, cast(m.w_down, dt)).view(e * cap, d)
    # gather back and combine with the gate weights
    out = (out_buf.index_select(0, slot) * w[:, None]).view(t, k, d).sum(1)
    if cfg.num_shared_experts:
        sh = (F.silu(xt @ cast(m.shared_gate, dt))
              * (xt @ cast(m.shared_up, dt))) @ cast(m.shared_down, dt)
        coef = torch.sigmoid(xt.float() @ m.shared_coef)
        out = out + sh * coef.to(x.dtype)
    return out.view(b, s, d), r.aux


def count_active_params(cfg: MoEConfig) -> int:
    """Per-token active params in this MoE layer (for 6*N_active*D)."""
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    active = cfg.top_k * per_expert + cfg.d_model * cfg.num_experts
    if cfg.num_shared_experts:
        active += 3 * cfg.d_model * _shared_width(cfg) + cfg.d_model
    return active
