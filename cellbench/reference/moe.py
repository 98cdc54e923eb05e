"""The moe family (Qwen2-MoE): pre-norm blocks of GQA attention with q/k/v
biases and a moe layer, a softmax router over the experts with the top
k, a shared expert behind a sigmoid gate.

As the configuration file states it is run: the top-k weights
renormalised, and a prefill call's (token, expert) assignments taking
capacity slots in token order, ``cap = max(ceil(T * k * cf / E), k)``
for the call's T tokens, the ones past ``cap`` dropped.  A decoded token
is routed alone, with all its k experts, as a batch of one would route
it.  Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from cellbench.reference import model as R

#: the training step routes a whole batch in one call, whose capacity
#: the reference's one row at a time does not follow
TRAINS = False
#: leaves held in float32 in a bfloat16 model
FP32_LEAVES: Tuple[str, ...] = ("router", "shared_coef")


def layer_leaves(cfg: dict, i: int) -> List[tuple]:
    d = cfg["hidden_size"]
    e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
    fs = cfg["shared_expert_intermediate_size"]
    p = f"blocks.{i}."
    out = R.attention_leaves(cfg, p) + [
        (p + "ln2.scale", (d,), "ones"),
        (p + "moe.router", (d, e), "normal"),
        (p + "moe.w_gate", (e, d, f), "normal"),
        (p + "moe.w_up", (e, d, f), "normal"),
        (p + "moe.w_down", (e, f, d), "normal")]
    if fs:
        out += [(p + "moe.shared_gate", (d, fs), "normal"),
                (p + "moe.shared_up", (d, fs), "normal"),
                (p + "moe.shared_down", (fs, d), "normal"),
                (p + "moe.shared_coef", (d, 1), "normal")]
    return out


def mlp_active_params(cfg: dict) -> int:
    """The router, the top-k experts and the shared expert with its gate."""
    d, e, k = (cfg["hidden_size"], cfg["num_experts"],
               cfg["num_experts_per_tok"])
    f, fs = cfg["moe_intermediate_size"], cfg["shared_expert_intermediate_size"]
    return d * e + k * 3 * d * f + (3 * d * fs + d if fs else 0)


def idle_layer_params(cfg: dict) -> int:
    """The experts a token is not routed to."""
    return (3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]
            * (cfg["num_experts"] - cfg["num_experts_per_tok"]))


def lm_kwargs(cfg: dict, base) -> dict:
    """The port's ``LMConfig`` fields for the moe layer.  The port
    renormalises the top-k weights and drops past a capacity factor of
    1.25; a configuration that states otherwise is refused."""
    if not cfg.get("norm_topk_prob"):
        raise ValueError("the port renormalises the top-k gate weights: "
                         "it runs only norm_topk_prob = true")
    if float(cfg.get("moe_capacity_factor", 1.25)) != 1.25:
        raise ValueError("the port's moe capacity factor is 1.25")
    fs = cfg["shared_expert_intermediate_size"]
    return dict(d_ff=cfg["moe_intermediate_size"],
                moe_experts=cfg["num_experts"],
                moe_top_k=cfg["num_experts_per_tok"],
                moe_d_ff_shared=fs,
                moe_shared_experts=(base.moe_shared_experts or 1) if fs else 0)


def prefill_calls(past: int, prompt_len: int) -> List[Tuple[int, int]]:
    """A prefill of a prompt's tokens past ``past`` is one call."""
    return [(past, prompt_len)]


def _keep(idx: torch.Tensor, cfg: dict, calls: Sequence[Tuple[int, int]]
          ) -> torch.Tensor:
    """Which (token, k) assignments survive capacity: within each call
    ``[lo, hi)`` the slots go in token order, then k order; a token in no
    call is routed alone and keeps all k."""
    t, k = idx.shape
    e = cfg["num_experts"]
    cf = float(cfg["moe_capacity_factor"])
    keep = torch.ones((t, k), dtype=torch.bool, device=idx.device)
    for lo, hi in calls:
        n = hi - lo
        cap = max(int(math.ceil(n * k * cf / e)), k)
        eid = idx[lo:hi].reshape(-1)
        onehot = F.one_hot(eid, e)
        pos = (onehot.cumsum(0) - onehot).gather(1, eid[:, None])[:, 0]
        keep[lo:hi] = (pos < cap).view(n, k)
    return keep


def _moe(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, pre: str,
         prec: str, calls: Sequence[Sequence[Tuple[int, int]]],
         lens: Sequence[int]) -> torch.Tensor:
    """The moe layer over the tokens of several sequences, ``x [T, d]``
    their concatenation (``lens`` each one's length, ``calls`` each one's
    prefill calls)."""
    k, e = cfg["num_experts_per_tok"], cfg["num_experts"]
    probs = torch.softmax(R.mm(x, p[pre + "router"], prec), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    if cfg.get("norm_topk_prob"):
        gate = gate / gate.sum(-1, keepdim=True)
    keep, lo = [], 0
    for n, c in zip(lens, calls):
        keep.append(_keep(idx[lo:lo + n], cfg, c))
        lo += n
    gate = gate * torch.cat(keep)
    out = torch.zeros_like(x)
    for ex in range(e):
        tok, slot = torch.nonzero(idx == ex, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = R.swiglu(x[tok], p[pre + "w_gate"][ex], p[pre + "w_up"][ex],
                     p[pre + "w_down"][ex], prec)
        out = out.index_add(0, tok, y * gate[tok, slot, None])
    if cfg.get("shared_expert_intermediate_size"):
        sh = R.swiglu(x, p[pre + "shared_gate"], p[pre + "shared_up"],
                      p[pre + "shared_down"], prec)
        out = out + sh * torch.sigmoid(R.mm(x, p[pre + "shared_coef"], prec))
    return out


def layer_forward(p: Dict[str, torch.Tensor], xs: List[torch.Tensor],
                  cfg: dict, i: int, prec: str,
                  calls: Sequence[Sequence[Tuple[int, int]]]
                  ) -> List[torch.Tensor]:
    pre, eps = f"blocks.{i}.", cfg["rms_norm_eps"]
    xs = [x + R.attention(p, R.rms_norm(x, p[pre + "ln1.scale"], eps), cfg,
                          pre + "attn.", prec) for x in xs]
    lens = [x.shape[0] for x in xs]
    x = torch.cat(xs)
    hn = R.rms_norm(x, p[pre + "ln2.scale"], eps)
    x = x + _moe(p, hn, cfg, pre + "moe.", prec, calls, lens)
    return list(x.split(lens))
