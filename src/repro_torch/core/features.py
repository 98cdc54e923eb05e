"""repro-features: view/toggle switchable features (likwid-features).

Port of ``repro/core/features.py``.  likwid-features flips hardware
prefetcher bits and reports switchable CPU feature state; the JAX package
keeps that switchable state in the compiler and runtime configuration.
:class:`FeatureSet` (its fields, defaults and :meth:`FeatureSet.validate`
errors), :func:`default_features`, :func:`from_env` (the same
``REPRO_FEATURE_`` prefix, so one environment drives both packages) and
:func:`render_state` are the reference's.  :data:`FEATURE_DOC` gives each
field's meaning on CUDA ("XLA only" where it has none), and
:func:`torch_settings_for` takes the place of ``xla_flags_for``: the
PyTorch settings the state implies.  Like the reference's flags they are
reported, not applied.  ``LM(cfg, ..., features=)`` takes a
:class:`FeatureSet`, as the reference's LM does: ``remat_policy`` maps
onto ``torch.utils.checkpoint`` in training
(:func:`repro_torch.models.transformer.remat`).  ``scan_layers`` and
``scan_unroll`` are XLA's, and ``decode_inplace_cache`` asks for what the
port's dense decode always does (it writes each token into the cache
buffers in place): all three stay report-only.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

__all__ = ["FeatureSet", "FEATURE_DOC", "default_features", "from_env",
           "render_state", "torch_settings_for", "TORCH_MATMUL_PRECISION"]


REMAT_POLICIES = ("none", "dots", "dots_no_batch", "full")
PRECISIONS = ("default", "high", "highest")


@dataclasses.dataclass
class FeatureSet:
    """The switchable state.  Defaults = production training configuration."""

    # -- memory/compute trade (activation checkpointing) --
    remat_policy: str = "dots_no_batch"  # none | dots | dots_no_batch | full
    # -- layer loop codegen --
    scan_layers: bool = True             # lax.scan over stacked layers
    scan_unroll: int = 1                 # unroll factor inside the scan
    # -- buffer/donation --
    donate_state: bool = True            # donate params/opt-state to the step
    # -- collective scheduling --
    async_collectives: bool = True       # XLA latency-hiding scheduler flags
    collective_matmul: bool = True       # overlap all-gather with partial matmul
    # -- numerics --
    matmul_precision: str = "default"    # default | high | highest
    compute_dtype: str = "bfloat16"
    # -- distributed-optimization tricks --
    grad_compression: str = "none"       # none | int8_ef (error feedback)
    # -- kernels --
    prefetch_to_vmem: bool = True        # double-buffered Pallas pipelines
    # -- decode --
    # carry-threaded in-place KV cache (§Perf hillclimb 3, iteration 2):
    # REFUTED on the CPU artifact (XLA CPU double-buffers the carried
    # stack); kept opt-in for TPU measurement where while-carries alias.
    decode_inplace_cache: bool = False

    def validate(self) -> "FeatureSet":
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} not in {REMAT_POLICIES}")
        if self.matmul_precision not in PRECISIONS:
            raise ValueError(f"matmul_precision {self.matmul_precision!r} not in {PRECISIONS}")
        if self.grad_compression not in ("none", "int8_ef"):
            raise ValueError(f"grad_compression {self.grad_compression!r}")
        if self.scan_unroll < 1:
            raise ValueError("scan_unroll must be >= 1")
        return self

    def with_(self, **kw) -> "FeatureSet":
        return dataclasses.replace(self, **kw).validate()


FEATURE_DOC: Dict[str, str] = {
    "remat_policy": "activation checkpointing of the training step: "
                    "none|dots|dots_no_batch|full",
    "scan_layers": "XLA only (the port's layer loop is a Python loop)",
    "scan_unroll": "XLA only (unroll factor of the layer scan)",
    "donate_state": "update params+opt state in place in train_step",
    "async_collectives": "XLA only (latency-hiding scheduler flags)",
    "collective_matmul": "XLA only (all-gather <-> matmul overlap rewrite)",
    "matmul_precision": "torch.set_float32_matmul_precision (default="
                        "medium, high, highest)",
    "compute_dtype": "activation compute dtype (the LM's torch dtype)",
    "grad_compression": "int8 error-feedback compression of DP grad reduce",
    "prefetch_to_vmem": "XLA only (Pallas HBM->VMEM double buffering)",
    "decode_inplace_cache": "always on (the dense decode writes the cache "
                            "in place)",
}

#: ``jax.default_matmul_precision`` names -> the
#: ``torch.set_float32_matmul_precision`` value that does the same work:
#: JAX's "default" is one bf16 pass (torch "medium"), "high" three
#: (torch "high", TF32), "highest" full fp32
TORCH_MATMUL_PRECISION: Dict[str, str] = {
    "default": "medium", "high": "high", "highest": "highest"}


def default_features() -> FeatureSet:
    return FeatureSet().validate()


_ENV_PREFIX = "REPRO_FEATURE_"


def from_env(base: Optional[FeatureSet] = None) -> FeatureSet:
    """Read feature overrides from REPRO_FEATURE_<NAME> env vars (CLI surface)."""
    fs = base or default_features()
    kw = {}
    for f in dataclasses.fields(FeatureSet):
        env = os.environ.get(_ENV_PREFIX + f.name.upper())
        if env is None:
            continue
        if f.type == "bool" or isinstance(getattr(fs, f.name), bool):
            kw[f.name] = env.lower() in ("1", "true", "on", "yes")
        elif isinstance(getattr(fs, f.name), int):
            kw[f.name] = int(env)
        else:
            kw[f.name] = env
    return fs.with_(**kw) if kw else fs


def render_state(fs: FeatureSet) -> str:
    """The paper's bit-table view of switchable feature state."""
    lines = ["Switchable features (repro-features)", "-" * 60]
    for f in dataclasses.fields(FeatureSet):
        v = getattr(fs, f.name)
        state = ("ON" if v else "off") if isinstance(v, bool) else str(v)
        lines.append(f"  {f.name:<20} {state:<14} {FEATURE_DOC[f.name]}")
    return "\n".join(lines)


def torch_settings_for(fs: FeatureSet) -> List[str]:
    """PyTorch settings implied by the feature set, the counterpart of
    the reference's ``xla_flags_for``: reported, not applied."""
    return [
        f"torch.set_float32_matmul_precision("
        f"{TORCH_MATMUL_PRECISION[fs.matmul_precision]!r})",
        f"compute dtype torch.{fs.compute_dtype}",
    ]
