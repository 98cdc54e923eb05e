"""Architecture registry, as plain data.

Every ported architecture registers an :class:`ArchSpec` holding its FULL
config, a REDUCED smoke config (same family, tiny dims — what CPU tests
instantiate) and its shape skips with reasons.  The JAX package's shape
catalogue and ``input_specs`` serve its dry-run, which is not ported.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from repro_torch.models.lm import LMConfig

__all__ = ["ArchSpec", "register", "get_arch", "ALL_ARCH_IDS", "LONG_SKIP"]


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
LONG_SKIP = (
    "long_500k",
    "pure full-attention arch: 500k dense-KV decode is quadratic-cost and "
    "cache-prohibitive; shape runs only for SSM/hybrid archs (DESIGN.md §5)",
)
