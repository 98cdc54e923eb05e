"""The plain reference: the configurations' forward, loss and gradients
in float32 PyTorch, with no kernel, cache or batching.

This module holds what every family shares (RMSNorm, half-split RoPE,
GQA attention with q/k/v biases, SwiGLU, the head, the loss, AdamW) and
drives a model layer by layer; each family's leaves and layer forward
are in ``reference/<family>.py``, found by the configuration's
``family`` (:func:`cellbench.bench.family`).

It imports nothing of the program and takes nothing the program made:
weights come from :mod:`cellbench.weights`, drawn again from the seed,
and it computes in float32 with TF32 off.  Two controls compute in the
float8 below the bfloat16 the configurations state, each operand rounded
to e4m3 under one scale a tensor before the float32 product, and under
training each gradient leaving it rounded to e5m2: ``prec="fp8_gemm"``
rounds the operands of every linear layer (the GEMMs a float8 program
would run), ``prec="fp8"`` those and the attention's two products too.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cellbench import weights as W
from cellbench.bench import family

__all__ = ["fp32_mode", "mm", "rms_norm", "rope", "causal_attention",
           "attention_leaves", "attention", "swiglu", "layer_forward",
           "head_logits", "serve_logits", "Stream", "PRECS"]

#: the reference's precisions: float32, and the two float8 controls
PRECS = ("fp32", "fp8_gemm", "fp8")

def fp32_mode() -> None:
    """Plain float32 products: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Fp8(torch.autograd.Function):
    """Forward: ``x`` rounded to float8 e4m3 under one scale for the whole
    tensor (the tensorwise scaling of ``torch._scaled_mm``), back in
    float32.  Backward: the incoming gradient rounded to float8 e5m2 the
    same way, as fp8 training keeps its gradients."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


def _q(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` as an operand of a linear layer in precision ``prec``."""
    if prec not in PRECS:
        raise ValueError(f"unknown precision {prec!r}")
    return x if prec == "fp32" else _Fp8.apply(x)


def _qa(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` as an operand of the attention's two products."""
    return _Fp8.apply(x) if prec == "fp8" else x


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """``a [..., K] @ b [K, N]`` in float32, or in a control's float8."""
    return _q(a, prec) @ _q(b, prec)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of ``x [..., S, H, Dh]`` at ``pos [S]``:
    dim ``i`` rotates with dim ``i + Dh/2``."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 1024, prec: str = "fp32") -> torch.Tensor:
    """``q [S, H, Dh]``, ``k``/``v [S, KVH, Dh]`` -> ``[S, H, Dh]``, causal,
    softmax over ``q k / sqrt(Dh)``, in blocks of ``block`` queries."""
    s, h, dh = q.shape
    g = h // k.shape[1]
    kk = _qa(k, prec).repeat_interleave(g, dim=1).transpose(0, 1)  # [H,S,Dh]
    vv = _qa(v, prec).repeat_interleave(g, dim=1).transpose(0, 1)
    qq = _qa(q, prec).transpose(0, 1) / math.sqrt(dh)
    out = []
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        sc = qq[:, lo:hi] @ kk[:, :hi].transpose(1, 2)       # [H, b, hi]
        mask = (torch.arange(hi, device=q.device)[None, :]
                <= torch.arange(lo, hi, device=q.device)[:, None])
        sc = sc.masked_fill(~mask, float("-inf"))
        out.append(_qa(torch.softmax(sc, dim=-1), prec) @ vv[:, :hi])
    return torch.cat(out, dim=1).transpose(0, 1)


def attention_leaves(cfg: dict, pre: str) -> List[W.Leaf]:
    """The attention's leaves under ``pre`` (``blocks.{i}.``): the input
    norm, q/k/v/o (``wq`` is ``[d, H, Dh]``) and the q/k/v biases."""
    d = cfg["hidden_size"]
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // h
    out: List[W.Leaf] = [
        (pre + "ln1.scale", (d,), "ones"),
        (pre + "attn.wq", (d, h, dh), "normal"),
        (pre + "attn.wk", (d, kvh, dh), "normal"),
        (pre + "attn.wv", (d, kvh, dh), "normal"),
        (pre + "attn.wo", (h, dh, d), "normal"),
    ]
    if cfg.get("qkv_bias"):
        out += [(pre + "attn.bq", (h, dh), "normal"),
                (pre + "attn.bk", (kvh, dh), "normal"),
                (pre + "attn.bv", (kvh, dh), "normal")]
    return out


def attention(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
              pre: str, prec: str) -> torch.Tensor:
    """The attention of one sequence ``x [S, d]`` with the leaves under
    ``pre`` (``blocks.{i}.attn.``)."""
    s, d = x.shape
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // h
    q = mm(x, p[pre + "wq"].reshape(d, h * dh), prec).view(s, h, dh)
    k = mm(x, p[pre + "wk"].reshape(d, kvh * dh), prec).view(s, kvh, dh)
    v = mm(x, p[pre + "wv"].reshape(d, kvh * dh), prec).view(s, kvh, dh)
    if cfg.get("qkv_bias"):
        q, k, v = q + p[pre + "bq"], k + p[pre + "bk"], v + p[pre + "bv"]
    pos = torch.arange(s, device=x.device)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    o = causal_attention(q, k, v, prec=prec)
    return mm(o.reshape(s, h * dh), p[pre + "wo"].reshape(h * dh, d), prec)


def swiglu(x, wg, wu, wd, prec):
    return mm(F.silu(mm(x, wg, prec)) * mm(x, wu, prec), wd, prec)


def layer_forward(p: Dict[str, torch.Tensor], xs: List[torch.Tensor],
                  cfg: dict, i: int, prec: str = "fp32",
                  calls: Optional[List[Sequence[Tuple[int, int]]]] = None
                  ) -> List[torch.Tensor]:
    """Layer ``i`` over sequences ``xs``, each ``[S, d]`` (float32), by
    the configuration's family; ``calls`` holds each sequence's prefill
    calls where the family's layer depends on how tokens share a call."""
    return family(cfg).layer_forward(p, xs, cfg, i, prec,
                                     calls or [()] * len(xs))


def head_logits(p: Dict[str, torch.Tensor], emb: torch.Tensor,
                x: torch.Tensor, cfg: dict, prec: str = "fp32"
                ) -> torch.Tensor:
    """Logits of the final hidden states ``x [n, d]``."""
    x = rms_norm(x, p["final_norm.scale"], cfg["rms_norm_eps"])
    w = emb.T if cfg["tie_word_embeddings"] else p["lm_head.w"]
    return mm(x, w, prec)


class Stream:
    """One sequence through the reference: its tokens, the positions
    whose logits are wanted, and the moe calls it was prefilled in."""

    def __init__(self, tokens: Sequence[int], want_from: int,
                 calls: Sequence[Tuple[int, int]] = ()):
        self.tokens = list(tokens)
        self.want_from = int(want_from)
        self.calls = list(calls)


def _float(group: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in group.items()}


@torch.no_grad()
def serve_logits(cfg: dict, seed: int, streams: List[Stream],
                 device: torch.device, dtype: torch.dtype,
                 precs: Sequence[str] = ("fp32",)
                 ) -> Dict[str, List[torch.Tensor]]:
    """For each precision, each stream's logits ``[n, V]`` at positions
    ``want_from ..``: layer by layer over all streams, each layer's
    weights drawn again from the seed in the served ``dtype`` and
    widened to float32."""
    fp32_mode()
    leaf_groups = dict(W.groups(cfg))
    emb = W.draw_group(cfg, seed, "embed", leaf_groups["embed"], device,
                       dtype)["embed.table"].float()
    hs = {pr: [emb[torch.tensor(s.tokens, device=device)] for s in streams]
          for pr in precs}
    for i in range(cfg["num_hidden_layers"]):
        p = _float(W.draw_group(cfg, seed, f"layer.{i}",
                                leaf_groups[f"layer.{i}"], device, dtype))
        for pr in precs:
            hs[pr] = layer_forward(p, hs[pr], cfg, i, pr,
                                   [s.calls for s in streams])
        del p
    head = _float(W.draw_group(cfg, seed, "head", leaf_groups["head"],
                               device, dtype))
    return {pr: [head_logits(head, emb, h[s.want_from:], cfg, pr)
                 for h, s in zip(hs[pr], streams)] for pr in precs}


def train_forward_loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                       labels: torch.Tensor, cfg: dict, ntok: float,
                       prec: str = "fp32") -> torch.Tensor:
    """The summed next-token cross entropy of one row ``tokens [S]`` over
    labels ``>= 0``, divided by ``ntok``, the batch's label count."""
    x = params["embed.table"][tokens.long()]
    for i in range(cfg["num_hidden_layers"]):
        x = layer_forward(params, [x], cfg, i, prec)[0]
    logits = head_logits(params, params["embed.table"], x, cfg, prec)
    ok = labels >= 0
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.clamp(min=0).long()[:, None])[:, 0]
    return (nll * ok).sum() / ntok


def lr_at(step: int, sched: dict) -> float:
    """The schedule's rate at optimizer step ``step`` (0 first): linear
    warmup to ``peak_lr``, then cosine or linear decay to
    ``min_ratio * peak_lr`` at ``total_steps``, or constant."""
    peak, warm = float(sched["peak_lr"]), int(sched["warmup_steps"])
    if step < warm:
        return peak * min(step / max(warm, 1), 1.0)
    frac = min(max((step - warm) / max(int(sched["total_steps"]) - warm, 1),
                   0.0), 1.0)
    mr = float(sched["min_ratio"])
    if sched["kind"] == "cosine":
        return peak * (mr + (1 - mr) * 0.5 * (1 + math.cos(math.pi * frac)))
    if sched["kind"] == "linear":
        return peak * (mr + (1 - mr) * (1 - frac))
    return peak


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay falls on every matrix and on every per-layer leaf (the
    layers are stacked into one leaf of two or more dims in the package
    the port follows), not on the final norm's scale."""
    return p.dim() >= 2 or name.startswith("blocks.")


def train_reference(cfg: dict, seed: int, spec: dict, batches: List[dict],
                    device: torch.device, prec: str = "fp32",
                    rows: Optional[slice] = None) -> dict:
    """``len(batches)`` AdamW steps of the plain model from the seed's
    float32 weights.  Returns each step's loss, the first step's global
    gradient norm before clipping, each leaf's first (clipped) gradient
    (``first_grad``, on the host) and its norm, and each leaf's norm of
    its change over all the steps.  ``rows``
    keeps only those rows of every batch (a fault: part of the batch left
    out, the mean over the rest)."""
    fp32_mode()
    params: Dict[str, torch.Tensor] = {}
    for group in W.draw_all(cfg, seed, device, torch.float32):
        params.update({k: v.clone() for k, v in group.items()})
    p0 = {k: v.clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    ad, sched = spec["adamw"], spec["schedule"]
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    vv = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"loss": [], "grad_norm": None, "grad_leaf": None}
    for t, batch in enumerate(batches):
        toks, labels = batch["tokens"], batch["labels"]
        if rows is not None:
            toks, labels = toks[rows], labels[rows]
        ntok = float((labels >= 0).sum().clamp(min=1))
        for prm in params.values():
            prm.grad = None
        loss = 0.0
        for r in range(toks.shape[0]):
            lr_ = train_forward_loss(params, toks[r], labels[r], cfg, ntok,
                                     prec)
            lr_.backward()
            loss += float(lr_.detach())
        out["loss"].append(loss)
        with torch.no_grad():
            g = {k: prm.grad for k, prm in params.items()}
            gnorm = math.sqrt(sum(float(x.double().square().sum())
                                  for x in g.values()))
            scale = min(float(ad["clip_norm"]) / max(gnorm, 1e-12), 1.0)
            if t == 0:
                out["grad_norm"] = gnorm
                out["grad_leaf"] = {k: float(x.double().norm()) * scale
                                    for k, x in g.items()}
                out["first_grad"] = {k: (x * scale).to("cpu", copy=True)
                                     for k, x in g.items()}
            step = t + 1
            b1, b2 = float(ad["b1"]), float(ad["b2"])
            lr = lr_at(t, sched)
            for k, prm in params.items():
                gk = g[k] * scale
                m[k].mul_(b1).add_(gk, alpha=1 - b1)
                vv[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
                u = (m[k] / (1 - b1 ** step)) / (
                    (vv[k] / (1 - b2 ** step)).sqrt() + float(ad["eps"]))
                if ad["weight_decay"] and decays(k, prm):
                    u = u + float(ad["weight_decay"]) * prm
                prm.sub_(lr * u)
    with torch.no_grad():
        out["change_leaf"] = {k: float((params[k] - p0[k]).double().norm())
                              for k in params}
    return out
