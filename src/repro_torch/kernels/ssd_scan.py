"""Chunked gated linear attention (Mamba2 SSD / mLSTM): the CUDA kernel,
its plain twin and the sequential oracle.

Port of ``repro/kernels/ssd_scan.py`` (the Pallas ``_ssd_kernel`` behind
``ssd_scan_flat``) and of its model-layout adapter ``kernels/ops.py::
ssd_scan``.  The kernel is ``csrc/ssd_scan.cu``; its source note says what
bounds it on an H100 and how it is laid out: bf16 runs three passes on the
tensor cores (local chunk states, the pass over states, the outputs) over a
scratch buffer this wrapper allocates at the size the library reports
(``ssd_scan_scratch_bytes``), fp32 the CUDA-core kernel of the first
port.  Contract, shared by every version here:

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
declares its FLOPs and bytes to :mod:`repro_torch.core.events` (the bf16
route's scratch is traffic, not work, and is left out).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import events
from repro_torch.kernels import _build
from repro_torch.models.linear_scan import (_chunked_linear_attention,
                                            sequential_linear_attention)

__all__ = ["ssd_scan", "ssd_scan_ref", "ssd_flops", "copy_width",
           "MAX_STATE_DIM", "MAX_CHUNK"]

State = Tuple[torch.Tensor, torch.Tensor]

MAX_STATE_DIM = 512          # dk and dv: mLSTM's state (dv splits over CTAs)
MAX_CHUNK = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SIG = {"ssd_scan_fwd": (
    _build.P, _build.P, _build.P, _build.P, _build.P,     # q k v lf li
    _build.P, _build.P, _build.P, _build.P, _build.P,     # c0 n0 y c n
    _build.I, _build.I, _build.I, _build.I, _build.I,     # B H S dk dv
    _build.I, _build.I, _build.F, _build.I,               # chunk norm eps dt
    _build.P, _build.I, _build.P, _build.L,               # strides wide scr
    _build.P),                                            # stream
    "ssd_scan_scratch_bytes": (_build.I,) * 6 + (_build.P,)}  # sizes, out


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


def copy_width(*tensors: torch.Tensor) -> int:
    """The bf16 kernel's copy width for the rows of ``tensors`` (q, k, v):
    16 bytes when every row starts 16-byte aligned, 4 when every row starts
    4-byte aligned and holds an even number of elements; raises otherwise
    (the kernel copies no narrower).  A dim of size 1 has no stride that
    matters."""
    def aligned(t, elems):
        return t.data_ptr() % (elems * t.element_size()) == 0 and all(
            st % elems == 0 for size, st in zip(t.shape[:3], t.stride()[:3])
            if size > 1)

    if all(aligned(t, 8) for t in tensors):
        return 16
    if all(aligned(t, 2) and t.shape[3] % 2 == 0 for t in tensors):
        return 4
    raise ValueError("the bf16 ssd_scan kernel copies rows of 16 or 4 bytes: "
                     "every row of q, k, v must start on 4 bytes and hold an "
                     "even number of elements")


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
        + 4 * (b * h * dk * dv + b * h * dk),
        f32=q.device.type == "cpu" or v.dtype == torch.float32)
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
    y = v.new_empty((b, s, h, dv))
    c_out = lf.new_empty((b, h, dk, dv))
    n_out = lf.new_empty((b, h, dk))
    c0 = n0 = None
    if initial_state is not None:
        c0 = initial_state[0].float().contiguous()
        n0 = initial_state[1].float().contiguous()
    lib = _build.library("ssd_scan", _SIG)
    wide, scratch, nbytes = 1, None, 0
    if v.dtype == torch.bfloat16:            # the tensor-core route
        wide = int(copy_width(q, k, v) == 16)
        size = ctypes.c_longlong()
        _build.check(lib, lib.ssd_scan_scratch_bytes(
            b, h, s, dk, dv, c, ctypes.byref(size)), "ssd_scan_scratch_bytes")
        nbytes = size.value
        scratch = lf.new_empty((nbytes,), dtype=torch.uint8)
    strides = (ctypes.c_int64 * 15)(
        *(st for t in (q, k, v, lf, li) for st in t.stride()[:3]))
    guard, stream = _build.launch_on(q.device)
    with guard:
        err = lib.ssd_scan_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
            li.data_ptr(), None if c0 is None else c0.data_ptr(),
            None if n0 is None else n0.data_ptr(), y.data_ptr(),
            c_out.data_ptr(), n_out.data_ptr(), b, h, s, dk, dv, c,
            int(bool(normalize)), float(eps), _DTYPE_CODE[v.dtype],
            strides, wide, None if scratch is None else scratch.data_ptr(),
            nbytes, stream)
    _build.check(lib, err, "ssd_scan_fwd")
    ssd_scan.launches += 1
    return y, (c_out, n_out)


#: calls that launched the kernel (a plain counter; reset it by assignment):
#: one a wrapper call, though a bf16 call launches three ``__global__``
#: functions, its three passes
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
