"""Architecture registry and input-shape catalogue, as plain data.

Every ported architecture registers an :class:`ArchSpec` holding its FULL
config, a REDUCED smoke config (same family, tiny dims — what CPU tests
instantiate) and its shape skips with reasons.  The shapes (the dry
run's cells, ``repro/configs/base.py:40-51``)::

    train_4k      seq 4096,   global_batch 256   (train_step)
    prefill_32k   seq 32768,  global_batch 32    (serve prefill)
    decode_32k    seq 32768,  global_batch 128   (serve decode: 1 new token
                                                  against a 32k KV cache)
    long_500k     seq 524288, global_batch 1     (decode; sub-quadratic
                                                  archs only)

:func:`input_specs` builds one cell's data batch as ``meta`` tensors
(shapes and dtypes, no storage), the stand-ins the dry run
(:mod:`repro_torch.launch.dryrun`) walks.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.lm import LMConfig

__all__ = ["Shape", "SHAPES", "ArchSpec", "register", "get_arch",
           "list_archs", "input_specs", "ALL_ARCH_IDS", "LONG_SKIP"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: LMConfig
    smoke: LMConfig
    source: str                      # provenance tag
    skip_shapes: Tuple[Tuple[str, str], ...] = ()   # (shape, reason)

    def skipped(self, shape_name: str) -> Optional[str]:
        for s, reason in self.skip_shapes:
            if s == shape_name:
                return reason
        return None


_REGISTRY: Dict[str, ArchSpec] = {}

#: every architecture of the JAX package's registry, one config module each
ALL_ARCH_IDS = ["qwen2-0.5b", "zamba2-1.2b", "xlstm-350m", "qwen1.5-0.5b",
                "stablelm-3b", "mistral-large-123b", "qwen2-moe-a2.7b",
                "qwen3-moe-235b-a22b", "qwen2-vl-7b", "seamless-m4t-medium"]

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ALL_ARCH_IDS}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        mod = _MODULE_FOR.get(arch_id)
        if mod is None:
            raise KeyError(f"unknown arch {arch_id!r}; registered: "
                           f"{ALL_ARCH_IDS}")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[arch_id]


# the standard long_500k skip (pure full-attention archs)
def list_archs() -> List[ArchSpec]:
    return [get_arch(a) for a in ALL_ARCH_IDS]


def input_specs(cfg: LMConfig, shape: Shape,
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for one (arch x shape) cell's data batch, the
    reference's shapes and dtypes (``repro/configs/base.py:122-157``)::

        train:   {tokens, labels}           [B, S] int32
        prefill: {tokens}                   [B, S] int32 (+ frontend stubs)
        decode:  {tokens}                   [B, 1] int32 (the state comes
                                            from init_decode_state)

    Frontend stubs: an encdec model's ``src_embeds`` [B, S / src_ratio, D]
    (precomputed frame embeddings) and a vlm model's ``patch_embeds``
    [B, n_patches, D], in ``dtype``."""
    b, s = shape.global_batch, shape.seq_len

    def meta(*dims, dt=torch.int32):
        return torch.empty(dims, dtype=dt, device="meta")

    out: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        out["tokens"], out["labels"] = meta(b, s), meta(b, s)
    elif shape.kind == "prefill":
        out["tokens"] = meta(b, s)
    else:                                   # decode: one new token
        out["tokens"] = meta(b, 1)
    if shape.kind != "decode":
        if cfg.family == "encdec":
            out["src_embeds"] = meta(b, max(s // cfg.src_ratio, 1),
                                     cfg.d_model, dt=dtype)
        if cfg.family == "vlm" and cfg.n_patches:
            out["patch_embeds"] = meta(b, cfg.n_patches, cfg.d_model,
                                       dt=dtype)
    return out


LONG_SKIP = (
    "long_500k",
    "pure full-attention arch: 500k dense-KV decode is quadratic-cost and "
    "cache-prohibitive; shape runs only for SSM/hybrid archs (DESIGN.md §5)",
)
