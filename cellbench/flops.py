"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes of the work the rooflines and the utilisations divide by.

Frozen copies, so that a change to the program cannot move the yardstick:

* the peaks are NVIDIA's data sheet for the H100 SXM (dense bf16 on the
  tensor cores, HBM3), as ``repro_torch/core/hwinfo.py`` and
  ``core/roofline.py`` hold them;
* :func:`flash_traffic` is ``repro_torch/kernels/flash_attention.py::
  flash_traffic`` and :func:`paged_traffic` is ``repro_torch/kernels/
  paged_decode.py::paged_traffic``, each call's FLOPs and bytes from its
  shapes and each row's valid keys;
* :func:`train_step_flops` is ``repro_torch/train/step.py::model_flops``
  (PaLM's ``6 N T + 12 L H Dh S T``, the formula ``chip_smoke.py`` phase
  23 applies to one step), with N counted from the configuration's
  widths by :func:`num_params`;
* :func:`forward_flops` counts a serving forward the way ``LM.
  _declare_ops`` counts its GEMMs, but over the experts a token is routed
  to (the useful work), not the capacity buffers the dispatch fills.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from cellbench.bench import family

__all__ = ["PEAK_BF16_FLOPS", "PEAK_HBM_BYTES", "flash_traffic",
           "paged_traffic", "bound_s", "num_params", "active_matmul_params",
           "forward_flops", "train_step_flops"]

#: H100 SXM, dense bf16 on the tensor cores (NVIDIA data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
#: H100 SXM HBM3 bandwidth (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12


def flash_traffic(kv_valid: Sequence[int], *, h: int, kvh: int, sq: int,
                  sk: int, dh: int, itemsize: int, causal: bool,
                  q_offset: int) -> Tuple[float, float, float]:
    """(FLOPs, bytes read, bytes written) of one flash call: QK^T and PV
    over the live (query, key) pairs only, q and the output once, each
    row's K/V up to the last key any query sees, and ``kv_valid``."""
    kv = np.clip(np.asarray(kv_valid, np.int64), 0, sk)
    if causal:
        reach = q_offset + np.arange(1, sq + 1)
        pairs = np.minimum(kv[:, None], reach[None, :]).sum()
        rows = np.minimum(kv, max(q_offset + sq, 0)).sum()
    else:
        pairs, rows = sq * kv.sum(), kv.sum()
    qo = kv.size * h * sq * dh * itemsize
    return (4.0 * dh * h * float(pairs),
            float(qo + 2 * kvh * dh * itemsize * rows + 4 * kv.size),
            float(qo))


def paged_traffic(lengths: Sequence[int], *, kvh: int, g: int, dh: int,
                  ps: int, q_itemsize: int, page_itemsize: int,
                  scales: bool) -> Tuple[float, float, float]:
    """(FLOPs, bytes read, bytes written) of one paged decode call: every
    live page of K and V once (with two f32 scales a token for int8
    pages) and its table entry; q, the new K/V, ``lengths`` and the
    output once; QK^T and PV over the past tokens and the new one."""
    lens = np.maximum(np.asarray(lengths, np.int64), 0)
    live = int(((lens + ps - 1) // ps).sum())
    b = lens.size
    per_token = 2 * kvh * dh * page_itemsize + (8 if scales else 0)
    out = b * kvh * g * dh * q_itemsize
    arg = (out + 2 * b * kvh * dh * q_itemsize + 4 * b
           + live * (ps * per_token + 4))
    return (4.0 * dh * kvh * g * float((lens + 1).sum()), float(arg),
            float(out))


def bound_s(flops: float, read: float, written: float) -> float:
    """The least time the H100 needs for the work: the larger of its
    FLOPs at the bf16 peak and its bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, (read + written) / PEAK_HBM_BYTES)


def _attn_params(cfg: dict) -> int:
    d, h, kvh = (cfg["hidden_size"], cfg["num_attention_heads"],
                 cfg["num_key_value_heads"])
    dh = d // h
    n = d * (h + 2 * kvh) * dh + h * dh * d
    if cfg.get("qkv_bias"):
        n += (h + 2 * kvh) * dh
    return n


def num_params(cfg: dict) -> int:
    """Every parameter of the model (a tied embedding once): the leaves
    the configuration's family draws, as ``LM.num_params()`` counts."""
    from cellbench import weights as W
    return sum(int(np.prod(shape)) for _, leaves in W.groups(cfg)
               for _, shape, _ in leaves)


def active_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies in the backbone (2 FLOPs each): the
    attention projections, and what the family multiplies past them (the
    MLP, or the router, the top-k experts and the shared expert with its
    gate).  Embedding and head left out."""
    n = _attn_params(cfg) + family(cfg).mlp_active_params(cfg)
    return cfg["num_hidden_layers"] * n


def forward_flops(cfg: dict, new: int, past: int, logits_rows: int) -> float:
    """FLOPs of a serving forward of ``new`` tokens after ``past`` tokens
    already cached, producing ``logits_rows`` rows of logits: the GEMMs of
    every new token, the causal attention's QK^T and PV over each new
    token's context (itself included), and the head."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dh = d // h
    pairs = new * past + new * (new + 1) / 2.0
    return (2.0 * active_matmul_params(cfg) * new
            + 4.0 * cfg["num_hidden_layers"] * h * dh * pairs
            + 2.0 * d * cfg["vocab_size"] * logits_rows)


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch x seq`` tokens:
    ``6 N T + 12 L H Dh S T`` (PaLM's count, causal masking not
    discounted)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    t = batch * seq
    n = (num_params(cfg)
         - cfg["num_hidden_layers"] * family(cfg).idle_layer_params(cfg))
    return 6.0 * n * t + 12.0 * cfg["num_hidden_layers"] * h * (d // h) * seq * t
