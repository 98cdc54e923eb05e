"""Numerics shared by the model zoo: norms, the SwiGLU and GELU MLPs,
RoPE and M-RoPE, init.

Ported from ``repro/models/layers.py:186-303`` (RMSNorm and LayerNorm,
both computed in fp32).  The sharding rules of the
JAX module wait for the mesh slice.

Weights are cast to the activations' dtype at every use (:func:`cast`),
as the reference casts its fp32 masters: a serving model stores them in
the compute dtype already (the cast is then the tensor itself, no
launch), a training model keeps fp32 masters and computes in bf16.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["cast", "truncated_normal_", "rms_norm", "layer_norm", "swiglu",
           "gelu_mlp", "rope_freqs", "apply_rope", "apply_mrope"]


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
               theta: float = 10000.0) -> torch.Tensor:
    """Half-split rotary embedding.  x: [..., S, H, Dh]; positions: [..., S]
    integer, per row.  Computed in fp32, cast back to ``x``'s dtype."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                        # [Dh/2]
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
