"""int8 error-feedback gradient compression.

Port of ``repro/optim/compress.py``.  Each gradient leaf is quantized to
int8 with one symmetric scale (``amax / 127``); the quantization residual
is kept and added back into the next step's gradient (error feedback,
Karimireddy et al. 2019), so the scheme is unbiased over time.  Only the
numerics are implemented, as in the reference: on one card nothing
crosses a wire.

The scale is the reference's: one per *reference* leaf.  The reference
stacks a subtree's layers on a leading axis, so its ``amax`` spans every
layer of, say, ``blocks/attn/wq``; the port keeps one tensor a layer
(``blocks.{i}.attn.wq``), so :func:`compress_decompress` groups a leaf's
per-layer tensors (:func:`repro_torch.bridge.reference_leaf`) under one
scale.  One scale per port tensor would be one per layer, a different
result.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import torch

from repro_torch.bridge import reference_leaf

__all__ = ["init_compress_state", "compress_decompress", "quantize_int8",
           "dequantize_int8"]

CompressState = Dict[str, torch.Tensor]   # fp32 residuals, named as params


def init_compress_state(params: Mapping[str, torch.Tensor]
                        ) -> CompressState:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax / 127.0, min=1e-12)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns (q, scale)."""
    scale = _scale(x.abs().amax())
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(grads: Mapping[str, torch.Tensor],
                        ef: CompressState, layout: Any = None
                        ) -> Tuple[Dict[str, torch.Tensor], CompressState]:
    """Apply EF-int8 to every gradient, one scale per reference leaf.
    Returns (grads', ef'), both fp32 and named as ``grads``.  With a mesh
    ``layout`` the trees hold slices (see the module note)."""
    corrected = {k: g.float() + ef[k] for k, g in grads.items()}
    groups: Dict[str, List[str]] = {}
    for k in corrected:
        groups.setdefault(reference_leaf(k)[0], []).append(k)
    amaxes = torch.stack([
        torch.stack([corrected[k].abs().amax() for k in names]).amax()
        for names in groups.values()])
    if layout is not None:
        amaxes = layout.over_splits([names[0] for names in groups.values()],
                                    amaxes, "max")
    new_g: Dict[str, torch.Tensor] = {}
    new_ef: CompressState = {}
    for names, amax in zip(groups.values(), amaxes):
        scale = _scale(amax)
        for k in names:
            deq = dequantize_int8(_quantize(corrected[k], scale), scale)
            new_g[k] = deq
            new_ef[k] = corrected[k] - deq
    return ({k: new_g[k] for k in grads}, {k: new_ef[k] for k in grads})
