"""Flash attention for the training step: the CUDA kernels and their plain
twin, as a ``torch.autograd.Function``.

The kernels are ``csrc/flash_attention_train.cu`` (its source note says
what bounds them on an H100 and how they are laid out): a forward that
writes the output and each row's logsumexp, and a backward of two kernels,
dQ (with D = rowsum(dO * O)) then dK and dV.  They replace no TPU kernel:
the JAX package trains through plain ops, and the port's training step
spent most of its device time there (``models/attention.py``,
``_full_attention_offset``).  Contract, shared by the kernels and the
plain twin:

* q ``[B,S,H,Dh]``, k/v ``[B,S,KVH,Dh]`` -> out ``[B,S,H,Dh]`` and lse
  ``[B,H,S]`` fp32, the natural-log logsumexp of each row's scores times
  ``1/sqrt(Dh)``; GQA maps q head ``h`` to kv head ``h // (H // KVH)``;
* query ``i`` sees key ``j`` iff ``j <= i`` (``causal``) or always: no
  query offset, no ragged lengths;
* the backward takes dO ``[B,S,H,Dh]`` and returns dq, dk, dv in q's,
  k's and v's shapes.

The kernels take bf16 at :data:`SUPPORTED_HEAD_DIMS`, read their inputs
through (batch, seq, head) strides with a contiguous head dim (the BSHD
tensors ``_project_qkv`` makes, no transpose copies), and round P and dS
to bf16 before the products that take them, as the plain path's bf16
products do; scores, the softmax and dS stay fp32.  CPU tensors run the
plain twin (``_FlashCore``'s arithmetic in fp32 over materialised scores
rather than tiles, P rounded to the inputs' dtype before PV); CUDA tensors
launch the kernels or raise.  :data:`LAUNCHES` counts each kernel's
launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["flash_train", "flash_train_forward", "flash_train_backward",
           "flash_train_plain_forward", "flash_train_plain_backward",
           "takes", "SUPPORTED_HEAD_DIMS", "LAUNCHES"]

NEG_INF = -2.0e38
SUPPORTED_HEAD_DIMS = (64, 80, 128)

#: kernel launches through the wrappers, by ``__global__`` kernel (plain
#: counters; reset them by assignment)
LAUNCHES: Dict[str, int] = {"fwd": 0, "bwd_dq": 0, "bwd_dkdv": 0}

_P, _I, _F = _build.P, _build.I, _build.F
_SIG = {
    "flash_train_fwd": (_P,) * 5 + (_I,) * 6 + (_F, _P, _P),
    "flash_train_bwd_dq": (_P,) * 8 + (_I,) * 6 + (_F, _P, _P),
    "flash_train_bwd_dkdv": (_P,) * 8 + (_I,) * 6 + (_F, _P, _P),
}


def takes(*, dtype, dh: int, q_offset: int = 0, ragged: bool = False,
          heads: int = 1, kv_heads: int = 1) -> bool:
    """Whether the kernels take a training call with these facts: bf16, a
    head dim they build, no query offset, no ragged lengths, whole GQA
    groups."""
    return (dtype in (torch.bfloat16, "bfloat16")
            and dh in SUPPORTED_HEAD_DIMS and q_offset == 0 and not ragged
            and kv_heads > 0 and heads % kv_heads == 0)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_train takes q [B,S,H,Dh], k/v [B,S,KVH,Dh]")
    b, s, h, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != dh:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"H={h} is not a multiple of KVH={k.shape[2]}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_train takes q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_train inputs on several devices: "
                         f"{ {q.device, k.device, v.device} }")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_train runs on cpu or cuda, not {q.device}")


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked scaled scores [B,H,S,S] fp32 and k repeated over the group
    [B,S,H,Dh] fp32."""
    s, h, dh = q.shape[1], q.shape[2], q.shape[3]
    kf = k.float().repeat_interleave(h // k.shape[2], dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(dh)
    if causal:
        pos = torch.arange(s, device=q.device)
        sc = sc.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    return sc, kf


def _group_sum(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B,S,H,Dh] -> [B,S,KVH,Dh], summed over each kv head's group."""
    b, s, h, dh = x.shape
    return x.reshape(b, s, kvh, h // kvh, dh).sum(dim=3)


def flash_train_plain_forward(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: ``(out, lse)`` from fp32 scores, P rounded to
    q's dtype before PV."""
    sc, _ = _scores(q, k, causal)
    lse = torch.logsumexp(sc, dim=-1)                      # [B,H,S]
    p = torch.exp(sc - lse[..., None]).to(q.dtype).float()
    vf = v.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype), lse


def flash_train_plain_backward(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               lse: torch.Tensor, dout: torch.Tensor, *,
                               causal: bool = True
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The plain backward: P recomputed from ``lse``, D = rowsum(dO * O),
    dS = P (dP - D), all fp32; dq, dk, dv in the inputs' dtype."""
    kvh = k.shape[2]
    sc, kf = _scores(q, k, causal)
    p = torch.exp(sc - lse[..., None])
    do = dout.float()
    vf = v.float().repeat_interleave(q.shape[2] // kvh, dim=2)
    d = (do * out.float()).sum(dim=-1).transpose(1, 2)     # [B,H,S]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = p * (dp - d[..., None]) / math.sqrt(q.shape[3])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = _group_sum(torch.einsum("bhqk,bqhd->bkhd", ds, q.float()), kvh)
    dv = _group_sum(torch.einsum("bhqk,bqhd->bkhd", p, do), kvh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check_card(*ts: torch.Tensor) -> None:
    """The kernels' own conditions on card tensors: bf16, a built head
    dim, a contiguous head dim, rows on 16 bytes."""
    dh = ts[0].shape[3]
    dtypes = {t.dtype for t in ts}
    if dtypes != {torch.bfloat16}:
        raise TypeError(f"the flash_train kernels take bf16, got "
                        f"{sorted(map(str, dtypes))}")
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the flash_train kernels build head dims "
                         f"{SUPPORTED_HEAD_DIMS}, got {dh}")
    for t in ts:
        st = t.stride()
        if st[3] != 1:
            raise ValueError("the flash_train kernels need a contiguous "
                             "head dim")
        if t.data_ptr() % 16 or any(x % 8 for x in st[:3]):
            raise ValueError("the flash_train kernels copy 16-byte row "
                             "chunks: tensors must start on 16 bytes with "
                             "batch, seq and head strides that are "
                             "multiples of 8")


def _strides(*ts: torch.Tensor):
    vals = []
    for t in ts:
        st = t.stride()
        vals += [st[0], st[1], st[2]]
    return (ctypes.c_int64 * len(vals))(*vals)


def _launch(fn: str, ptrs, shape, causal: bool, strides, dev) -> None:
    b, s, h, kvh, dh = shape
    lib = _build.library("flash_attention_train", _SIG)
    guard, stream = _build.launch_on(dev)
    with guard:
        err = getattr(lib, fn)(*ptrs, b, h, kvh, s, dh, int(bool(causal)),
                               1.0 / math.sqrt(dh), strides, stream)
    _build.check(lib, err, fn)


def flash_train_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: CUDA tensors launch the forward kernel (one launch
    in ``LAUNCHES["fwd"]``), CPU tensors run the plain twin."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_train_plain_forward(q, k, v, causal=causal)
    _check_card(q, k, v)
    b, s, h, dh = q.shape
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("flash_train_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr()), (b, s, h, k.shape[2], dh), causal,
            _strides(q, k, v, out), q.device)
    LAUNCHES["fwd"] += 1
    return out, lse


def flash_train_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, *, causal: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """``(dq, dk, dv)``: CUDA tensors launch the dQ kernel, then the dK/dV
    kernel (one launch each in ``LAUNCHES``), CPU tensors run the plain
    twin."""
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    b, s, h, dh = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 of shape {(b, h, s)}")
    if q.device.type == "cpu":
        return flash_train_plain_backward(q, k, v, out, lse, dout,
                                          causal=causal)
    dout = dout.contiguous()            # autograd may hand a strided one
    _check_card(q, k, v, out, dout)
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    kvh = k.shape[2]
    dd = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    shape = (b, s, h, kvh, dh)
    _launch("flash_train_bwd_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr()),
            shape, causal, _strides(q, k, v, out, dout, dq), q.device)
    LAUNCHES["bwd_dq"] += 1
    _launch("flash_train_bwd_dkdv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            shape, causal, _strides(q, k, v, dout, dk, dv), q.device)
    LAUNCHES["bwd_dkdv"] += 1
    return dq, dk, dv


class _FlashTrain(torch.autograd.Function):
    """Forward and backward through the wrappers.  The forward dispatches
    the same aten ops (the two ``empty`` of out and lse) on every call, so
    a selective checkpoint's recompute meets exactly what its forward
    recorded, a profiler opened between them included."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_train_forward(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_train_backward(q, k, v, out, lse, dout,
                                          causal=ctx.causal)
        return dq, dk, dv, None


def flash_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True) -> torch.Tensor:
    """Differentiable attention: q [B,S,H,Dh], k/v [B,S,KVH,Dh] ->
    [B,S,H,Dh] through :class:`_FlashTrain` (the kernels on the card, the
    plain twin on the CPU)."""
    return _FlashTrain.apply(q, k, v, causal)
