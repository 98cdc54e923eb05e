"""Chunked gated linear attention: the shared recurrence of mLSTM and Mamba2.

Port of ``repro/models/linear_scan.py``.  Both xLSTM's mLSTM and Mamba2's
SSD are instances of::

    C_t = f_t * C_{t-1} + i_t * k_t v_t^T          C: [dk, dv] per (b, h)
    n_t = f_t * n_{t-1} + i_t * k_t                n: [dk]      (normalizer)
    y_t = q_t @ C_t     [ / max(|q_t @ n_t|, eps)  if normalize ]

with f_t = exp(log_f_t) in (0,1], i_t = exp(log_i_t), log_f, log_i <= 0.

* :func:`sequential_linear_attention` — the O(S) scan oracle;
* :func:`_chunked_linear_attention` — the chunk-parallel form (the
  contract of the ``ssd_scan`` kernel, and its plain PyTorch twin);
* :func:`decode_step_linear_attention` — the one-token serving update.

The JAX package routes ``chunked_linear_attention`` through its kernel
registry; until the registry is ported the routed entry is
:func:`repro_torch.kernels.ssd_scan.ssd_scan`, which dispatches by tensor
device (the plain form here for CPU tensors, the CUDA kernel otherwise).
All math is fp32; ``y`` comes back in ``v``'s dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["sequential_linear_attention", "decode_step_linear_attention"]

State = Tuple[torch.Tensor, torch.Tensor]


def _zero_state(b: int, h: int, dk: int, dv: int,
                device: torch.device) -> State:
    return (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((b, h, dk), dtype=torch.float32, device=device))


def sequential_linear_attention(q, k, v, log_f, log_i, *,
                                normalize: bool = False, eps: float = 1e-6,
                                initial_state: Optional[State] = None):
    """O(S) scan oracle.  q,k: [B,S,H,dk]; v: [B,S,H,dv]; log_f/i: [B,S,H].

    Returns (y [B,S,H,dv], (C [B,H,dk,dv], n [B,H,dk]))."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if initial_state is None:
        C, n = _zero_state(b, h, dk, dv, q.device)
    else:
        C, n = (a.float() for a in initial_state)
    qf, kf, vf, lff, lif = (a.float() for a in (q, k, v, log_f, log_i))
    ys = []
    for t in range(s):
        f = torch.exp(lff[:, t])[..., None]                  # [B,H,1]
        i = torch.exp(lif[:, t])[..., None]
        C = f[..., None] * C + (i * kf[:, t])[..., None] * vf[:, t, :, None, :]
        n = f * n + i * kf[:, t]
        y = torch.einsum("bhk,bhkv->bhv", qf[:, t], C)
        if normalize:
            denom = torch.abs(torch.einsum("bhk,bhk->bh", qf[:, t], n))
            y = y / torch.clamp(denom, min=eps)[..., None]
        ys.append(y)
    return torch.stack(ys, dim=1).to(v.dtype), (C, n)


def _chunked_linear_attention(q, k, v, log_f, log_i, *,
                              chunk_size: int = 128,
                              normalize: bool = False, eps: float = 1e-6,
                              initial_state: Optional[State] = None):
    """Chunk-parallel evaluation (matches the sequential oracle to ~1e-5).

    q,k: [B,S,H,dk]; v: [B,S,H,dv]; log_f, log_i: [B,S,H] (both <= 0).
    Returns (y [B,S,H,dv], final_state (C [B,H,dk,dv], n [B,H,dk])).
    S is padded to a chunk multiple with log_i = -1e9 (inert writes)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk_size, s)
    pad = (-s) % c
    qf, kf, vf, lf, li = (a.float() for a in (q, k, v, log_f, log_i))
    if pad:
        def zp(a):
            return torch.nn.functional.pad(
                a, (0, 0) * (a.dim() - 2) + (0, pad))
        qf, kf, vf, lf = zp(qf), zp(kf), zp(vf), zp(lf)
        # log_i = 0 would let padded tokens write the state: mask them
        li = torch.nn.functional.pad(li, (0, 0, 0, pad), value=-1e9)
    nc = (s + pad) // c

    def rs(a):                                   # [B,S,...] -> [B,nc,c,...]
        return a.reshape(b, nc, c, *a.shape[2:])

    qc, kc, vc, lfc, lic = rs(qf), rs(kf), rs(vf), rs(lf), rs(li)
    if initial_state is None:
        C, n = _zero_state(b, h, dk, dv, q.device)
    else:
        C, n = (a.float() for a in initial_state)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    ys = []
    for j in range(nc):
        qt, kt, vt = qc[:, j], kc[:, j], vc[:, j]     # [B,c,H,*]
        lfj, lij = lfc[:, j], lic[:, j]               # [B,c,H]
        Bc = torch.cumsum(lfj, dim=1)                 # inclusive [B,c,H]
        total = Bc[:, -1]                             # [B,H]
        # inter-chunk: y_inter_t = exp(B_t) q_t @ C_prev
        qdec = qt * torch.exp(Bc)[..., None]
        y_inter = torch.einsum("bchk,bhkv->bchv", qdec, C)
        n_inter = torch.einsum("bchk,bhk->bch", qdec, n)
        # intra-chunk: A[t,j] = exp(B_t - B_j + li_j) for j <= t
        gap = Bc[:, :, None, :] - Bc[:, None, :, :] + lij[:, None, :, :]
        A = torch.where(tri[None, :, :, None], torch.exp(gap), 0.0)
        scores = torch.einsum("bchk,bghk->bcgh", qt, kt) * A
        y_intra = torch.einsum("bcgh,bghv->bchv", scores, vt)
        n_intra_dot = scores.sum(dim=2)               # [B,c,H]
        # state: C_new = exp(total) C + sum_j exp(total-B_j+li_j) k_j v_j^T
        wj = torch.exp(total[:, None] - Bc + lij)     # [B,c,H]
        kw = kt * wj[..., None]
        C = torch.exp(total)[..., None, None] * C + \
            torch.einsum("bchk,bchv->bhkv", kw, vt)
        n = torch.exp(total)[..., None] * n + kw.sum(dim=1)
        y = y_inter + y_intra
        if normalize:
            denom = torch.abs(n_inter + n_intra_dot)
            y = y / torch.clamp(denom, min=eps)[..., None]
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(v.dtype), (C, n)


def decode_step_linear_attention(q, k, v, log_f, log_i, state: State, *,
                                 normalize: bool = False, eps: float = 1e-6
                                 ) -> Tuple[torch.Tensor, State]:
    """Single-token recurrent update (serving).  q,k,v: [B,H,d*]; gates
    [B,H]; state (C [B,H,dk,dv], n [B,H,dk]) fp32."""
    C, n = state
    f = torch.exp(log_f.float())[..., None]
    i = torch.exp(log_i.float())[..., None]
    k32, v32, q32 = (a.float() for a in (k, v, q))
    C = f[..., None] * C + (i * k32)[..., None] * v32[..., None, :]
    n = f * n + i * k32
    y = torch.einsum("bhk,bhkv->bhv", q32, C)
    if normalize:
        denom = torch.abs(torch.einsum("bhk,bhk->bh", q32, n))
        y = y / torch.clamp(denom, min=eps)[..., None]
    return y.to(v.dtype), (C, n)
