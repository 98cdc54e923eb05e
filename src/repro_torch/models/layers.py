"""Numerics shared by the model zoo: norms, the SwiGLU MLP, RoPE, init.

Ported from ``repro/models/layers.py:186-275``.  The sharding rules of the
JAX module wait for the mesh slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["truncated_normal_", "rms_norm", "swiglu", "rope_freqs",
           "apply_rope"]


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


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) ).  Weights in compute dtype."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


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
