"""xLSTM blocks (arXiv:2405.04517): mLSTM (chunk-parallel) + sLSTM (recurrent).

Port of ``repro/models/xlstm.py``.  xlstm-350m is 24 alternating blocks
(12 mLSTM/sLSTM pairs), d_model 1024, 4 heads, no separate FFN: the
projections live inside the blocks.

* **mLSTM**: a matrix memory C per head with scalar input/forget gates and
  a normalizer, evaluated as normalized chunked gated linear attention
  through the kernel registry's ``ssd_scan`` family
  (``registry.run("ssd_scan", ..., normalize=True)``): CUDA tensors launch
  kernel #5 (``csrc/ssd_scan.cu``, dk = dv = 512 at xlstm-350m), CPU
  tensors run the chunked plain twin.  The serving prefill carries the
  slot's state into the call, so on the card it is a kernel launch even
  where the JAX package, handed a zero ``initial_state``, takes its jnp
  body (``repro/models/linear_scan.py:87-93``): a departure in route, not
  in result.  Up-projection factor 2, output gating with SiLU(z),
  down-projection.
* **sLSTM**: a scalar memory with a per-head block-diagonal recurrence R,
  inherently sequential: a plain PyTorch loop over time (the JAX package's
  ``lax.scan``; it has no TPU kernel, so none is owed here), then a gated
  FFN of factor 4/3.

Input gates go through log-sigmoid (the reference's documented
simplification), so every exponent is <= 0.  The gate weights and biases
of both blocks and the sLSTM recurrence (:data:`FP32_LEAVES`) stay fp32 in
a bf16 model, as the reference initializes them, and the gates are
computed in fp32.  Decode state per pair: mLSTM (C [B,H,dk,dv], n
[B,H,dk]) and sLSTM (c, n, h each [B,D]), fp32.

**Tensor parallelism** (a config whose ``tp`` and ``tp_ff`` fields hold
the rank's model axis).
The mLSTM splits by heads: a rank holds ``wq``/``wk``/``wv`` and
``w_gates``/``b_gates`` for its heads, ``w_up``'s ``z`` columns of them
and ``w_down``'s rows of them (one reduce after it); ``w_up``'s ``xm``
half stays whole on every rank, since every head reads the whole ``xm``
(:func:`mlstm_tp_splits`; the derived spec ``("ff", "heads", ...)``
cuts ``wq``'s input dim instead, which would need ``xm`` gathered over
the axis).  The sLSTM's recurrence mixes heads across its gates (the
reference reshapes ``[B, H, 4 dh]`` to ``[B, 4D]`` before splitting i,
z, f, o), so split by heads every step would exchange ``h``: ``w_gates``,
``r_gates``, ``b_gates`` and its state stay whole on every rank as
replicated work, and only its FFN splits (``w_ff_gate``/``w_ff_up``
column-parallel, ``w_ff_down`` row-parallel).  Under autograd every
replicated tensor enters a split region through ``copy_in``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import registry
from repro_torch.models.layers import (ModelSplit, rms_norm,
                                      truncated_normal_)
from repro_torch.models.linear_scan import decode_step_linear_attention
from repro_torch.models.transformer import RMSNorm

__all__ = ["XLSTMConfig", "FP32_LEAVES", "MLSTMBlock", "SLSTMBlock",
           "apply_mlstm_block", "mlstm_decode", "apply_slstm_block",
           "slstm_decode", "init_mlstm_state", "init_slstm_state",
           "mlstm_block_specs", "slstm_block_specs", "mlstm_tp_splits"]

#: leaves kept in fp32 whatever the model dtype (the reference inits them
#: fp32 and computes the gates in fp32)
FP32_LEAVES = ("w_gates", "b_gates", "r_gates")

MState = Tuple[torch.Tensor, torch.Tensor]
SState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class XLSTMConfig(NamedTuple):
    d_model: int
    num_heads: int
    proj_factor: float = 2.0      # mLSTM up-projection
    ff_factor: float = 4.0 / 3.0  # sLSTM post-FFN
    chunk_size: int = 128
    norm_eps: float = 1e-6
    #: the model axes the mLSTM's heads and the sLSTM's FFN split over
    #: (None: unsharded; ``tp_ff`` None also where the axis does not
    #: divide the FFN); ``num_heads`` and the sizes below stay the whole
    #: model's
    tp: Optional[Any] = None
    tp_ff: Optional[Any] = None

    @property
    def local_heads(self) -> int:
        """The mLSTM heads this rank computes."""
        return self.num_heads // (self.tp.size if self.tp else 1)

    @property
    def local_ff(self) -> int:
        """The sLSTM FFN width this rank holds."""
        return self.d_ff // (self.tp_ff.size if self.tp_ff else 1)

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.num_heads

    @property
    def d_ff(self) -> int:
        """``d_model * ff_factor`` rounded up to a multiple of 128."""
        raw = int(self.d_model * self.ff_factor)
        return ((raw + 127) // 128) * 128


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class MLSTMBlock(nn.Module):
    """``init_mlstm_block``'s tree: ``ln``, ``w_up``, ``wq``, ``wk``,
    ``wv``, ``w_gates``, ``b_gates``, ``w_down``."""

    def __init__(self, cfg: XLSTMConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, di, h, dh = cfg.d_model, cfg.d_inner, cfg.local_heads, \
            cfg.head_dim
        f32 = torch.float32
        self.ln = RMSNorm(d, dtype, device)
        self.w_up = _param((d, di + h * dh), dtype, device)
        self.wq = _param((di, h, dh), dtype, device)
        self.wk = _param((di, h, dh), dtype, device)
        self.wv = _param((di, h, dh), dtype, device)
        self.w_gates = _param((di, 2 * h), f32, device)
        self.b_gates = _param((2 * h,), f32, device)
        self.w_down = _param((h * dh, d), dtype, device)

    def init(self, generator: Optional[torch.Generator]) -> None:
        d = self.w_up.shape[0]
        di, h = self.wq.shape[0], self.b_gates.shape[0] // 2
        truncated_normal_(self.w_up, 1.0 / math.sqrt(d), generator)
        for w in (self.wq, self.wk, self.wv, self.w_gates, self.w_down):
            truncated_normal_(w, 1.0 / math.sqrt(di), generator)
        with torch.no_grad():                # input gate 0, forget gate 3
            self.b_gates[:h] = 0.0
            self.b_gates[h:] = 3.0


class SLSTMBlock(nn.Module):
    """``init_slstm_block``'s tree: ``ln``, ``w_gates``, ``r_gates``,
    ``b_gates``, ``ln_ff``, ``w_ff_gate``, ``w_ff_up``, ``w_ff_down``."""

    def __init__(self, cfg: XLSTMConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        d, h, f = cfg.d_model, cfg.num_heads, cfg.local_ff
        dh = d // h
        f32 = torch.float32
        self.ln = RMSNorm(d, dtype, device)
        self.w_gates = _param((d, 4 * d), f32, device)
        self.r_gates = _param((h, dh, 4 * dh), f32, device)
        self.b_gates = _param((4 * d,), f32, device)
        self.ln_ff = RMSNorm(d, dtype, device)
        self.w_ff_gate = _param((d, f), dtype, device)
        self.w_ff_up = _param((d, f), dtype, device)
        self.w_ff_down = _param((f, d), dtype, device)

    def init(self, generator: Optional[torch.Generator]) -> None:
        d = self.w_gates.shape[0]
        dh, f = self.r_gates.shape[1], self.w_ff_gate.shape[1]
        truncated_normal_(self.w_gates, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.r_gates, 1.0 / math.sqrt(dh), generator)
        truncated_normal_(self.w_ff_gate, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.w_ff_up, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.w_ff_down, 1.0 / math.sqrt(f), generator)
        with torch.no_grad():                # i, z 0; forget 3; o 0
            self.b_gates.zero_()
            self.b_gates[2 * d:3 * d] = 3.0


def mlstm_block_specs(cfg: XLSTMConfig) -> dict:
    """Logical axes of one mLSTM block's weights (the reference's
    ``mlstm_block_specs``, ``repro/models/xlstm.py:90-100``)."""
    del cfg
    return {
        "ln": {"scale": ("act_embed",)},
        "w_up": ("embed", "ff"),
        "wq": ("ff", "heads", "head_dim"),
        "wk": ("ff", "heads", "head_dim"),
        "wv": ("ff", "heads", "head_dim"),
        "w_gates": ("ff", "heads"),
        "b_gates": ("heads",),
        "w_down": ("ff", "embed"),
    }


def slstm_block_specs(cfg: XLSTMConfig) -> dict:
    """Logical axes of one sLSTM block's weights (the reference's
    ``slstm_block_specs``, ``repro/models/xlstm.py:179-189``)."""
    del cfg
    return {
        "ln": {"scale": ("act_embed",)},
        "w_gates": ("embed", "ff"),
        "r_gates": ("heads", "head_dim", None),
        "b_gates": ("ff",),
        "ln_ff": {"scale": ("act_embed",)},
        "w_ff_gate": ("embed", "ff"),
        "w_ff_up": ("embed", "ff"),
        "w_ff_down": ("ff", "embed"),
    }


def mlstm_tp_splits(cfg: XLSTMConfig) -> dict:
    """The mLSTM leaves a rank holds other than the derived spec's
    contiguous cut (see the module note); ``cfg`` the whole model's."""
    di, h = cfg.d_inner, cfg.num_heads
    heads = ModelSplit(1, ((h, True),))
    gates = ((h, True), (h, True))                 # [i | f] by heads
    return {"w_up": ModelSplit(1, ((di, False), (di, True))),
            "wq": heads, "wk": heads, "wv": heads,
            "w_gates": ModelSplit(1, gates), "b_gates": ModelSplit(0, gates)}


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_qkv_gates(p: MLSTMBlock, x: torch.Tensor, cfg: XLSTMConfig):
    b, s, _ = x.shape
    h, dh, di = cfg.local_heads, cfg.head_dim, cfg.d_inner
    hn = rms_norm(x, p.ln.scale, cfg.norm_eps)
    w_up = p.w_up.to(x.dtype)
    tp = cfg.tp
    if tp is None or tp.size == 1 or not registry.needs_grad(hn, w_up):
        xm, z = (hn @ w_up).split([di, h * dh], dim=-1)
    else:        # xm whole (replicated), z this rank's heads
        xm = hn @ w_up[:, :di]
        z = tp.copy_in(hn) @ w_up[:, di:]
    if tp is not None:
        xm = tp.copy_in(xm)

    def proj(w):                                 # "bse,ehk->bshk"
        return (xm @ w.to(x.dtype).reshape(di, h * dh)).reshape(b, s, h, dh)

    q, k, v = proj(p.wq), proj(p.wk) / math.sqrt(dh), proj(p.wv)
    gates = xm.float() @ p.w_gates + p.b_gates
    log_i = F.logsigmoid(gates[..., :h])
    log_f = F.logsigmoid(gates[..., h:])
    return q, k, v, log_i, log_f, z


def apply_mlstm_block(p: MLSTMBlock, x: torch.Tensor, cfg: XLSTMConfig,
                      initial_state: Optional[MState] = None,
                      return_state: bool = False):
    """Prefill one mLSTM block over x [B,S,D] through the registry's
    ``ssd_scan`` family; with ``return_state`` also (C, n) after it."""
    q, k, v, log_i, log_f, z = _mlstm_qkv_gates(p, x, cfg)
    y, state = registry.run("ssd_scan", q, k, v, log_f, log_i,
                            chunk=cfg.chunk_size, normalize=True,
                            initial_state=initial_state)
    b, s = x.shape[:2]
    y = y.reshape(b, s, -1) * F.silu(z)
    out = x + _reduce(y @ p.w_down.to(x.dtype), cfg.tp)
    return (out, state) if return_state else out


def init_mlstm_state(batch: int, cfg: XLSTMConfig, device: torch.device,
                     layers: int) -> MState:
    """Zeroed fp32 (C, n) with a leading layers axis (this rank's
    heads)."""
    h, dh = cfg.local_heads, cfg.head_dim
    return (torch.zeros((layers, batch, h, dh, dh), dtype=torch.float32,
                        device=device),
            torch.zeros((layers, batch, h, dh), dtype=torch.float32,
                        device=device))


def mlstm_decode(p: MLSTMBlock, x: torch.Tensor, cfg: XLSTMConfig,
                 state: MState) -> Tuple[torch.Tensor, MState]:
    """x: [B,1,D], one token; plain ops on every device, as the reference
    (``decode_step_linear_attention(..., normalize=True)``)."""
    q, k, v, log_i, log_f, z = _mlstm_qkv_gates(p, x, cfg)
    y, new_state = decode_step_linear_attention(
        q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], log_i[:, 0], state,
        normalize=True)
    b = x.shape[0]
    y = y.reshape(b, 1, -1) * F.silu(z)
    return x + _reduce(y @ p.w_down.to(x.dtype), cfg.tp), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_step(gx_h: torch.Tensor, carry: SState, p: SLSTMBlock,
                cfg: XLSTMConfig, g: Optional[torch.Tensor],
                out: Optional[torch.Tensor] = None,
                eps: float = 1e-6) -> SState:
    """One recurrence step (the reference's ``_slstm_cell``).  ``gx_h``:
    the input-side gate preacts [H,B,4*dh] (head-major, so the per-head
    recurrence adds into them in one batched product); ``g`` a [B,H,4*dh]
    fp32 buffer the step's preacts land in; ``out`` receives h (both
    None under autograd, which records no ``out=`` write).  The gate
    order of the flat [B,4D] preacts is (i, z, f, o)."""
    c, n, hprev = carry                          # each [B, D] f32
    b, d = c.shape
    nh = cfg.num_heads
    dh = d // nh
    # (gx + h R) + b, with the [B,H,4dh] -> [B,4D] reshape of the reference
    acc = torch.baddbmm(gx_h, hprev.reshape(b, nh, dh).transpose(0, 1),
                        p.r_gates)
    if g is None:                                # autograd: no out= buffers
        g = (acc.transpose(0, 1) + p.b_gates.view(nh, 4 * dh)).reshape(
            b, 4 * d)
    else:
        g = torch.add(acc.transpose(0, 1), p.b_gates.view(nh, 4 * dh),
                      out=g).view(b, 4 * d)
    sg = torch.sigmoid(g)
    i, f, o = sg[:, :d], sg[:, 2 * d:3 * d], sg[:, 3 * d:]
    z = torch.tanh(g[:, d:2 * d])
    c = torch.addcmul(f * c, i, z)
    n = torch.addcmul(i, f, n)
    h = torch.mul(o, c / torch.clamp(n, min=eps), out=out)
    return c, n, h


def _reduce(y: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel product's partial sums over the model axis."""
    return y if tp is None else tp.all_reduce(y)


def _slstm_ffn(p: SLSTMBlock, y: torch.Tensor, cfg: XLSTMConfig
               ) -> torch.Tensor:
    yn = rms_norm(y, p.ln_ff.scale, cfg.norm_eps)
    if cfg.tp_ff is not None:
        yn = cfg.tp_ff.copy_in(yn)
    dt = y.dtype
    g = yn @ p.w_ff_gate.to(dt)
    u = yn @ p.w_ff_up.to(dt)
    return y + _reduce((F.silu(g) * u) @ p.w_ff_down.to(dt), cfg.tp_ff)


def _gates_in(p: SLSTMBlock, x: torch.Tensor, cfg: XLSTMConfig
              ) -> torch.Tensor:
    """The input-side gate preacts x W (fp32), [B,S,4D]."""
    xn = rms_norm(x, p.ln.scale, cfg.norm_eps)
    return xn.float() @ p.w_gates


def apply_slstm_block(p: SLSTMBlock, x: torch.Tensor, cfg: XLSTMConfig,
                      initial_state: Optional[SState] = None,
                      return_state: bool = False):
    """Prefill one sLSTM block over x [B,S,D]: the recurrence as a loop
    over time, then the gated FFN."""
    b, s, d = x.shape
    nh = cfg.num_heads
    gx = _gates_in(p, x, cfg)
    # [S,H,B,4dh]: each step's preacts contiguous in the head-major layout
    gx_h = gx.view(b, s, nh, 4 * d // nh).permute(1, 2, 0, 3).contiguous()
    carry = (tuple(t.float() for t in initial_state)
             if initial_state is not None else
             tuple(torch.zeros((b, d), dtype=torch.float32, device=x.device)
                   for _ in range(3)))
    # a shape walk (the dry run, on ``meta``) takes one step: every step
    # has the same shapes, and none holds a value
    walked = 1 if x.device.type == "meta" else s
    if registry.needs_grad(gx_h, p.r_gates, p.b_gates, *carry):
        steps = []
        for t in range(walked):
            carry = _slstm_step(gx_h[t], carry, p, cfg, None)
            steps.append(carry[2])
        hs = torch.stack(steps).expand(s, b, d)
    else:
        hs = torch.empty((s, b, d), dtype=torch.float32, device=x.device)
        g = torch.empty((b, nh, 4 * d // nh), dtype=torch.float32,
                        device=x.device)
        for t in range(walked):
            carry = _slstm_step(gx_h[t], carry, p, cfg, g, out=hs[t])
    y = x + hs.transpose(0, 1).to(x.dtype)
    out = _slstm_ffn(p, y, cfg)
    return (out, carry) if return_state else out


def init_slstm_state(batch: int, cfg: XLSTMConfig, device: torch.device,
                     layers: int) -> SState:
    """Zeroed fp32 (c, n, h) with a leading layers axis."""
    return tuple(torch.zeros((layers, batch, cfg.d_model),
                             dtype=torch.float32, device=device)
                 for _ in range(3))


def slstm_decode(p: SLSTMBlock, x: torch.Tensor, cfg: XLSTMConfig,
                 state: SState) -> Tuple[torch.Tensor, SState]:
    """x: [B,1,D]; state (c, n, h)."""
    b, _, d = x.shape
    nh = cfg.num_heads
    gx = _gates_in(p, x, cfg)[:, 0]
    g = torch.empty((b, nh, 4 * d // nh), dtype=torch.float32,
                    device=x.device)
    new_state = _slstm_step(gx.view(b, nh, 4 * d // nh).transpose(0, 1),
                            state, p, cfg, g)
    y = x + new_state[2][:, None].to(x.dtype)
    return _slstm_ffn(p, y, cfg), new_state
