"""Chunked gated linear attention (Mamba2 SSD / mLSTM): the CUDA kernel,
its plain twin and the sequential oracle.

Port of ``repro/kernels/ssd_scan.py`` (the Pallas ``_ssd_kernel`` behind
``ssd_scan_flat``) and of its model-layout adapter ``kernels/ops.py::
ssd_scan``.  The kernel is ``csrc/ssd_scan.cu``; its source note says what
bounds it on an H100 and how it is laid out.  Contract, shared by every
version here:

* q, k ``[B,S,H,dk]``, v ``[B,S,H,dv]`` (fp32 or bf16), log_f, log_i
  ``[B,S,H]`` fp32, each <= 0;
* returns (y ``[B,S,H,dv]`` in v's dtype, (C ``[B,H,dk,dv]``, n
  ``[B,H,dk]``) fp32), the ``chunked_linear_attention`` contract;
* ``initial_state`` (C0, n0) continues a carried state (the serving
  prefill passes one); None starts from zeros, exactly ``ssd_scan_flat``.

:func:`ssd_scan` dispatches on the tensors' device: CPU tensors run the
plain twin :func:`repro_torch.models.linear_scan._chunked_linear_attention`,
CUDA tensors launch the kernel (or raise — there is no fallback).  The
kernel reads the model layout through its (batch, seq, head) strides, which
is the flattening to ``[BH,S,d]`` that ``ops.ssd_scan`` does, without a
copy (the Pallas entry's flat ``[BH,S,d]`` is the view ``[BH,S,1,d]``);
q and k may be views broadcast over heads.  :func:`ssd_scan_ref` is the
sequential oracle of ``repro/kernels/ref.py::ssd_scan``.  Each call
declares its FLOPs and bytes to :mod:`repro_torch.core.events`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import events
from repro_torch.kernels import _build
from repro_torch.models.linear_scan import (_chunked_linear_attention,
                                            sequential_linear_attention)

__all__ = ["ssd_scan", "ssd_scan_ref", "ssd_flops", "MAX_STATE_DIM",
           "MAX_CHUNK"]

State = Tuple[torch.Tensor, torch.Tensor]

MAX_STATE_DIM = 512          # dk and dv: mLSTM's state (dv splits over CTAs)
MAX_CHUNK = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"ssd_scan_fwd": (
    _build.P, _build.P, _build.P, _build.P, _build.P,     # q k v lf li
    _build.P, _build.P, _build.P, _build.P, _build.P,     # c0 n0 y c n
    _build.I, _build.I, _build.I, _build.I, _build.I,     # B H S dk dv
    _build.I, _build.I, _build.F, _build.I,               # chunk norm eps dt
    _build.P, _build.P)}                                  # strides stream


def ssd_flops(b: int, h: int, s: int, dk: int, dv: int, chunk: int) -> int:
    """FLOPs the chunked algorithm needs: per chunk of L steps, q @ C and
    the state update (2 L dk dv each), the causal score and value products
    over L (L+1) / 2 pairs (2 dk + 2 dv each), and the normalizer update."""
    c = min(chunk, s)
    per = 0
    for start in range(0, s, c):
        n = min(c, s - start)
        per += 4 * n * dk * dv + n * (n + 1) * (dk + dv) + 2 * n * dk
    return b * h * per


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a view reads (a dim broadcast with
    stride 0 counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _check(q, k, v, log_f, log_i, chunk, initial_state):
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"ssd_scan takes q, k [B,S,H,dk] and v [B,S,H,dv], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if log_f.shape != q.shape[:3] or log_i.shape != q.shape[:3]:
        raise ValueError(f"log_f/log_i must be [B,S,H] = {tuple(q.shape[:3])},"
                         f" got {tuple(log_f.shape)}/{tuple(log_i.shape)}")
    if q.shape[1] < 1 or chunk < 1:
        raise ValueError(f"ssd_scan needs S >= 1 and chunk >= 1, got "
                         f"S={q.shape[1]}, chunk={chunk}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"ssd_scan takes fp32 or bf16 q/k/v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    devs = {t.device for t in (q, k, v, log_f, log_i)}
    if initial_state is not None:
        b, _, h, dk = q.shape
        c0, n0 = initial_state
        if c0.shape != (b, h, dk, v.shape[3]) or n0.shape != (b, h, dk):
            raise ValueError(f"initial_state must be (C [B,H,dk,dv], n "
                             f"[B,H,dk]), got {tuple(c0.shape)}, "
                             f"{tuple(n0.shape)}")
        devs |= {c0.device, n0.device}
    if len(devs) != 1:
        raise ValueError(f"ssd_scan inputs on several devices: {devs}")


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_f: torch.Tensor, log_i: torch.Tensor, *, chunk: int = 128,
             normalize: bool = False, eps: float = 1e-6,
             initial_state: Optional[State] = None
             ) -> Tuple[torch.Tensor, State]:
    """Model layout: q,k [B,S,H,dk]; v [B,S,H,dv]; gates [B,S,H].

    Returns (y [B,S,H,dv], (C [B,H,dk,dv], n [B,H,dk])).  CUDA tensors
    launch ``csrc/ssd_scan.cu`` (and count one launch in
    ``ssd_scan.launches``); CPU tensors run the plain twin."""
    _check(q, k, v, log_f, log_i, chunk, initial_state)
    b, s, h, dk = q.shape
    dv = v.shape[3]
    if q.device.type == "cpu":
        y, state = _chunked_linear_attention(
            q, k, v, log_f, log_i, chunk_size=chunk, normalize=normalize,
            eps=eps, initial_state=initial_state)
    elif q.device.type == "cuda":
        y, state = _launch(q, k, v, log_f, log_i, min(chunk, s), normalize,
                           eps, initial_state)
    else:
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {q.device}")
    state_in = 0 if initial_state is None else \
        4 * (b * h * dk * dv + b * h * dk)
    events.record_launch(
        flops=ssd_flops(b, h, s, dk, dv, chunk),
        arg_bytes=sum(_distinct_bytes(t) for t in (q, k, v, log_f, log_i))
        + state_in,
        out_bytes=y.numel() * y.element_size()
        + 4 * (b * h * dk * dv + b * h * dk))
    return y, state


def _launch(q, k, v, log_f, log_i, c, normalize, eps, initial_state):
    b, s, h, dk = q.shape
    dv = v.shape[3]
    if dk > MAX_STATE_DIM or dv > MAX_STATE_DIM:
        raise ValueError(f"the ssd_scan kernel holds dk, dv <= "
                         f"{MAX_STATE_DIM}, got dk={dk}, dv={dv}")
    if c > MAX_CHUNK:
        raise ValueError(f"the ssd_scan kernel takes chunks <= {MAX_CHUNK}, "
                         f"got {c}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the ssd_scan kernel needs a contiguous feature dim")
    lf, li = log_f.float(), log_i.float()
    dev = q.device
    y = torch.empty((b, s, h, dv), dtype=v.dtype, device=dev)
    c_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    n_out = torch.empty((b, h, dk), dtype=torch.float32, device=dev)
    c0 = n0 = None
    if initial_state is not None:
        c0 = initial_state[0].float().contiguous()
        n0 = initial_state[1].float().contiguous()
    strides = (ctypes.c_int64 * 15)(
        *(st for t in (q, k, v, lf, li) for st in t.stride()[:3]))
    lib = _build.library("ssd_scan", _SIG)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
            li.data_ptr(), None if c0 is None else c0.data_ptr(),
            None if n0 is None else n0.data_ptr(), y.data_ptr(),
            c_out.data_ptr(), n_out.data_ptr(), b, h, s, dk, dv, c,
            int(bool(normalize)), float(eps), _DTYPE_CODE[v.dtype],
            ctypes.cast(strides, ctypes.c_void_p), stream)
    _build.check(lib, err, "ssd_scan_fwd")
    ssd_scan.launches += 1
    return y, (c_out, n_out)


#: kernel launches made through the wrapper (a plain counter; reset it by
#: assignment)
ssd_scan.launches = 0


def ssd_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_f: torch.Tensor, log_i: torch.Tensor, *,
                 normalize: bool = False,
                 initial_state: Optional[State] = None
                 ) -> Tuple[torch.Tensor, State]:
    """Gated linear attention, the O(S) sequential oracle
    (``repro/kernels/ref.py::ssd_scan``).  Model layout, as
    :func:`ssd_scan`."""
    return sequential_linear_attention(q, k, v, log_f, log_i,
                                       normalize=normalize,
                                       initial_state=initial_state)
