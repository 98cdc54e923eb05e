"""Mamba2 (SSD) blocks — the zamba2-1.2b backbone (arXiv:2411.15242).

Port of ``repro/models/ssm.py``.  The SSD recurrence per head (state N,
head dim P)::

    h_t = exp(-dt_t * exp(A_log)) h_{t-1} + dt_t * (B_t x_t^T)
    y_t = C_t @ h_t + D * x_t

is gated linear attention with q=C, k=B, v=dt*x, log_f=-dt*exp(A_log),
log_i=0 — evaluated through the kernel registry's ``ssd_scan`` family
(kernel #5 for CUDA tensors, the chunked plain twin for CPU tensors; a
pin overrides either), with the segment's carried state.  C and B are shared by the heads of a group; the port hands the kernel a
view broadcast over heads instead of a repeated copy.

Block layout follows Mamba2: in_proj -> (z, x, B, C, dt); short causal
conv1d over (x,B,C); SSD; gated RMSNorm(y * silu(z)); out_proj.

**Tensor parallelism** (a config whose ``tp`` field holds the rank's
model axis; it gives its own sizes: ``num_heads / m`` heads, ``d_inner /
m`` channels).  A rank holds the ``z``, ``x`` and ``dt`` columns of its
heads in ``in_proj`` and the ``B`` and ``C`` columns whole (one group:
they feed every head), the matching ``conv_w``/``conv_b`` channels, and
``A_log``, ``D``, ``dt_bias``, ``ln_gate`` and ``out_proj``'s rows by
heads (:func:`tp_splits`, the layout ``LM.model_splits`` reports; the
derived spec ``("embed", "ff")`` would cut the concatenated columns
contiguously).  The gated RMSNorm normalises the whole ``d_inner``: one
sum of squares reduced over the axis before the scale; ``out_proj`` is
row-parallel, one reduce.  Under autograd the split columns take the
normed input through ``copy_in`` and ``B``/``C`` the input itself, then
enter the heads' scan through ``copy_in`` after the (replicated) conv,
so every replicated weight gets its whole gradient.

Decode state per layer: SSD state (C [B,H,N,P], n [B,H,N]) + conv tail
[B, K-1, conv_channels], fp32 — O(1) in sequence length.  ``A_log``,
``dt_bias`` and ``D`` stay fp32 in a bf16 model (:data:`FP32_LEAVES`):
rounding the decay to bf16 would change every step and compound over the
sequence; the other weights live in the compute dtype, as the JAX package
casts them at use.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import registry
from repro_torch.models.layers import (ModelSplit, rms_norm,
                                      truncated_normal_)
from repro_torch.models.linear_scan import decode_step_linear_attention
from repro_torch.models.transformer import RMSNorm

__all__ = ["Mamba2Config", "Mamba2Block", "apply_mamba2_block",
           "mamba2_decode", "init_mamba2_state", "FP32_LEAVES",
           "mamba2_block_specs", "tp_splits"]

#: leaves kept in fp32 whatever the model dtype
FP32_LEAVES = ("A_log", "dt_bias", "D")

MambaState = Dict[str, object]   # {"ssd": (C, n), "conv": tail}


class Mamba2Config(NamedTuple):
    d_model: int
    d_state: int = 64            # N
    head_dim: int = 64           # P
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk_size: int = 128
    norm_eps: float = 1e-6
    dt_min: float = 0.001
    dt_max: float = 0.1
    #: the model axis the heads split over (None: unsharded); the sizes
    #: below are then this rank's
    tp: Optional[Any] = None

    @property
    def d_inner_full(self) -> int:
        return self.expand * self.d_model

    @property
    def d_inner(self) -> int:
        return self.d_inner_full // (self.tp.size if self.tp else 1)

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def in_proj_out(self) -> int:
        # z, x, B, C, dt
        return (2 * self.d_inner + 2 * self.n_groups * self.d_state
                + self.num_heads)


class Mamba2Block(nn.Module):
    """One Mamba2 block's weights, named as ``init_mamba2_block``'s tree."""

    def __init__(self, cfg: Mamba2Config, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=device),
                                requires_grad=False)

        d, h = cfg.d_model, cfg.num_heads
        self.ln = RMSNorm(d, dtype, device)
        self.in_proj = param(d, cfg.in_proj_out)
        self.conv_w = param(cfg.conv_kernel, cfg.conv_channels)
        self.conv_b = param(cfg.conv_channels)
        self.A_log = param(h, dt=torch.float32)
        self.D = param(h, dt=torch.float32)
        self.dt_bias = param(h, dt=torch.float32)
        self.ln_gate = RMSNorm(cfg.d_inner, dtype, device)
        self.out_proj = param(cfg.d_inner, d)

    def init(self, generator: Optional[torch.Generator]) -> None:
        """``init_mamba2_block``'s distributions: truncated normals, A from
        log(linspace(1, 16)), D = 1, and the dt bias as the inverse
        softplus of dt drawn log-uniform in [dt_min, dt_max]."""
        cfg = self.cfg
        d = cfg.d_model
        truncated_normal_(self.in_proj, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.conv_w, 0.5, generator)
        truncated_normal_(self.out_proj, 1.0 / math.sqrt(cfg.d_inner_full),
                          generator)
        dev = self.A_log.device
        u = torch.rand((cfg.num_heads,), generator=generator, device=dev)
        dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                       + math.log(cfg.dt_min))
        with torch.no_grad():
            self.conv_b.zero_()
            self.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, cfg.num_heads, device=dev)))
            self.D.fill_(1.0)
            self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))


def mamba2_block_specs(cfg: Mamba2Config) -> dict:
    """Logical axes of one block's weights (the reference's
    ``mamba2_block_specs``, ``repro/models/ssm.py:94-105``)."""
    del cfg
    return {
        "ln": {"scale": ("act_embed",)},
        "in_proj": ("embed", "ff"),
        "conv_w": ("conv", "ff"),
        "conv_b": ("ff",),
        "A_log": ("heads",),
        "D": ("heads",),
        "dt_bias": ("heads",),
        "ln_gate": {"scale": ("ff",)},
        "out_proj": ("ff", "embed"),
    }


def tp_splits(cfg: Mamba2Config) -> Dict[str, ModelSplit]:
    """The leaves a rank holds other than the derived spec's contiguous
    cut, keyed by their name in the block (see the module note);
    ``cfg`` the whole model's config."""
    di, gn, h = cfg.d_inner, cfg.n_groups * cfg.d_state, cfg.num_heads
    xbc = ((di, True), (gn, False), (gn, False))
    return {"in_proj": ModelSplit(1, ((di, True),) + xbc + ((h, True),)),
            "conv_w": ModelSplit(1, xbc), "conv_b": ModelSplit(0, xbc)}


def _project(p: "Mamba2Block", xn: torch.Tensor, cfg: Mamba2Config
             ) -> torch.Tensor:
    """``xn @ in_proj`` (this rank's columns).  Under autograd on a model
    axis the split columns take ``xn`` through ``copy_in`` and the whole
    ``B``/``C`` columns ``xn`` itself (see the module note)."""
    w = p.in_proj.to(xn.dtype)
    tp = cfg.tp
    if tp is None or tp.size == 1 or not registry.needs_grad(xn, w):
        return xn @ w
    lo = 2 * cfg.d_inner
    hi = lo + 2 * cfg.n_groups * cfg.d_state
    proj = tp.copy_in(xn) @ w
    return torch.cat([proj[..., :lo], xn @ w[:, lo:hi], proj[..., hi:]],
                     dim=-1)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, p: "Mamba2Block",
                cfg: Mamba2Config) -> torch.Tensor:
    """RMSNorm(y * silu(z)) over the whole ``d_inner``: on a model axis
    the sum of squares of this rank's channels reduces over it first
    (forward and backward sums: the variance feeds every rank's
    channels)."""
    g = y * F.silu(z)
    tp = cfg.tp
    if tp is None or tp.size == 1:
        return rms_norm(g, p.ln_gate.scale, cfg.norm_eps)
    g32 = g.float()
    ss = tp.copy_in(tp.all_reduce(g32.square().sum(dim=-1, keepdim=True)))
    var = ss / cfg.d_inner_full
    return (g32 * torch.rsqrt(var + cfg.norm_eps)
            * p.ln_gate.scale.float()).to(g.dtype)


def _out(p: "Mamba2Block", x_in: torch.Tensor, y: torch.Tensor,
         cfg: Mamba2Config) -> torch.Tensor:
    """The residual plus ``out_proj`` (row-parallel on a model axis)."""
    o = y @ p.out_proj.to(x_in.dtype)
    return x_in + (o if cfg.tp is None else cfg.tp.all_reduce(o))


def _split_proj(proj: torch.Tensor, cfg: Mamba2Config):
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * gn]
    dt = proj[..., di + di + 2 * gn:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d.  xbc: [B,S,C]; w: [K,C].  tail: [B,K-1,C]
    carries state across segments (decode)."""
    k = w.shape[0]
    w = w.to(xbc.dtype)
    if tail is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[-1]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = tail.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                  # [B, S+K-1, C]
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(k))
    return F.silu(out + b.to(xbc.dtype))


def _conv_tail(xbc_pre: torch.Tensor, tail: Optional[torch.Tensor],
               k: int) -> torch.Tensor:
    """The last K-1 conv inputs after this segment, fp32.  A segment
    shorter than K-1 keeps the older inputs of ``tail`` in front."""
    kk = k - 1
    if xbc_pre.shape[1] < kk:
        prev = (torch.zeros((xbc_pre.shape[0], kk, xbc_pre.shape[-1]),
                            dtype=torch.float32, device=xbc_pre.device)
                if tail is None else tail.float())
        return torch.cat([prev, xbc_pre.float()], dim=1)[:, -kk:]
    return xbc_pre[:, -kk:].float()


def _ssd_qkv(xbc: torch.Tensor, dt_pre: torch.Tensor, p: Mamba2Block,
             cfg: Mamba2Config):
    """xbc (post-conv) [B,S,C'] -> (q=C, k=B, v=dt*x, log_f, x) per head.
    q and k repeat each group's C and B over its heads (a broadcast view
    when there is one group)."""
    b, s, _ = xbc.shape
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    h, g = cfg.num_heads, cfg.n_groups
    x = xbc[..., :di].reshape(b, s, h, cfg.head_dim)
    Bmat = xbc[..., di:di + gn].reshape(b, s, g, 1, cfg.d_state)
    Cmat = xbc[..., di + gn:].reshape(b, s, g, 1, cfg.d_state)
    if cfg.tp is not None:                       # whole, into the heads
        Bmat, Cmat = cfg.tp.copy_in(Bmat), cfg.tp.copy_in(Cmat)
    rep = (b, s, g, h // g, cfg.d_state)
    k = Bmat.expand(rep).reshape(b, s, h, cfg.d_state)          # [B,S,H,N]
    q = Cmat.expand(rep).reshape(b, s, h, cfg.d_state)
    dt = F.softplus(dt_pre.float() + p.dt_bias)                  # [B,S,H]
    log_f = -dt * torch.exp(p.A_log)                             # <= 0
    v = x * dt[..., None].to(x.dtype)                            # i_t = dt
    return q, k, v, log_f, x


def apply_mamba2_block(p: Mamba2Block, x_in: torch.Tensor,
                       cfg: Mamba2Config,
                       initial_state: Optional[MambaState] = None,
                       return_state: bool = False):
    """Prefill one block over x_in [B,S,D]; with ``return_state`` also the
    state after the segment ({"ssd": (C, n), "conv": tail})."""
    xn = rms_norm(x_in, p.ln.scale, cfg.norm_eps)
    z, xbc_pre, dt_pre = _split_proj(_project(p, xn, cfg), cfg)
    tail = initial_state["conv"] if initial_state is not None else None
    xbc = _causal_conv(xbc_pre, p.conv_w, p.conv_b, tail=tail)
    q, k, v, log_f, xh = _ssd_qkv(xbc, dt_pre, p, cfg)
    ssd0 = initial_state["ssd"] if initial_state is not None else None
    y, ssd = registry.run("ssd_scan", q, k, v, log_f,
                          torch.zeros_like(log_f), chunk=cfg.chunk_size,
                          normalize=False, initial_state=ssd0)
    y = y + xh * p.D.to(y.dtype)[None, None, :, None]           # skip
    b, s = x_in.shape[:2]
    y = y.reshape(b, s, cfg.d_inner)
    out = _out(p, x_in, _gated_norm(y, z, p, cfg), cfg)
    if not return_state:
        return out
    return out, {"ssd": ssd,
                 "conv": _conv_tail(xbc_pre, tail, cfg.conv_kernel)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_mamba2_state(batch: int, cfg: Mamba2Config, device: torch.device,
                      layers: int) -> MambaState:
    """Zeroed fp32 state with a leading layers axis."""
    def z(*shape):
        return torch.zeros((layers, batch) + shape, dtype=torch.float32,
                           device=device)

    return {"ssd": (z(cfg.num_heads, cfg.d_state, cfg.head_dim),
                    z(cfg.num_heads, cfg.d_state)),
            "conv": z(cfg.conv_kernel - 1, cfg.conv_channels)}


def mamba2_decode(p: Mamba2Block, x_in: torch.Tensor, cfg: Mamba2Config,
                  state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """One token: x_in [B,1,D] -> (out, new state).  Plain ops on every
    device, as in the JAX package (no kernel)."""
    xn = rms_norm(x_in, p.ln.scale, cfg.norm_eps)
    z, xbc, dt_pre = _split_proj(_project(p, xn, cfg), cfg)
    new_conv = torch.cat([state["conv"][:, 1:], xbc.float()], dim=1)
    xbc = _causal_conv(xbc, p.conv_w, p.conv_b, tail=state["conv"])
    q, k, v, log_f, xh = _ssd_qkv(xbc, dt_pre, p, cfg)
    y, new_ssd = decode_step_linear_attention(
        q[:, 0], k[:, 0], v[:, 0], log_f[:, 0],
        torch.zeros_like(log_f[:, 0]), state["ssd"], normalize=False)
    y = y[:, None] + xh * p.D.to(y.dtype)[None, None, :, None]
    b = x_in.shape[0]
    y = y.reshape(b, 1, cfg.d_inner)
    return (_out(p, x_in, _gated_norm(y, z, p, cfg), cfg),
            {"ssd": new_ssd, "conv": new_conv})
