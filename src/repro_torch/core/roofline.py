"""Three-term roofline model over perfctr events.

Port of ``repro/core/roofline.py``.  For one measured region, per GPU:

    T_compute = (FLOPS_TOTAL - FLOPS_F32) / peak_bf16_flops
                + FLOPS_F32 / peak_f32_flops
    T_memory  = BYTES_ACCESSED / hbm_bw
    T_nvlink  = ICI_TOTAL_BYTES / (nvlink_links_used * nvlink_bw_per_link)

The compute term takes each FLOP's own peak: fp32 work on CUDA cores is
bounded by 67 TFLOP/s on an H100 SXM, not by the 989 of bf16 tensor
cores.  The interconnect term is NVLink (the reference's ICI) and reads
0 on one card.  The bottleneck is the largest term; ``efficiency_overlap``
and ``mfu_bound`` are the reference's, and ``useful_flops_ratio`` is
MODEL_FLOPS (6*N*D train, 2*N*D inference) over the declared FLOPs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import hwinfo
from repro_torch.core.events import EventCounts
from repro_torch.core.groups import t_compute

__all__ = ["RooflineTerms", "analyze", "model_flops"]


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    cell: str                      # what was measured
    t_compute: float
    t_memory: float
    t_nvlink: float
    model_flops_per_device: float  # 6ND / devices (or 2ND serve)
    declared_flops_per_device: float
    chip: str

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "nvlink": self.t_nvlink}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def t_dominant(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_nvlink)

    @property
    def t_sum(self) -> float:
        return self.t_compute + self.t_memory + self.t_nvlink

    @property
    def efficiency_overlap(self) -> float:
        """Share of a perfectly-overlapped schedule the dominant term takes."""
        return self.t_dominant / self.t_sum if self.t_sum else 0.0

    @property
    def mfu_bound(self) -> float:
        """MFU ceiling under perfect overlap (compute term / dominant term)."""
        return self.t_compute / self.t_dominant if self.t_dominant else 0.0

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / declared FLOPs — catches redundant work."""
        return (self.model_flops_per_device / self.declared_flops_per_device
                if self.declared_flops_per_device else 0.0)

    def row(self) -> Dict[str, object]:
        return {
            "cell": self.cell,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_nvlink_s": self.t_nvlink,
            "bound": self.bound,
            "efficiency_overlap": self.efficiency_overlap,
            "mfu_bound": self.mfu_bound,
            "useful_flops_ratio": self.useful_flops_ratio,
        }

    def render(self) -> str:
        return (f"{self.cell:<44} Tc={self.t_compute*1e3:9.3f}ms "
                f"Tm={self.t_memory*1e3:9.3f}ms Tn={self.t_nvlink*1e3:9.3f}ms "
                f"bound={self.bound:<7} mfu_bound={self.mfu_bound:5.2f} "
                f"useful={self.useful_flops_ratio:5.2f}")


def model_flops(n_params: int, n_tokens: int, *, training: bool = True,
                n_active_params: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), N_active for MoE."""
    n = n_active_params if n_active_params is not None else n_params
    return (6.0 if training else 2.0) * float(n) * float(n_tokens)


def analyze(ev: EventCounts, *, cell: str, chip: hwinfo.ChipSpec,
            nvlink_links_used: Optional[int] = None,
            model_flops_total: float = 0.0,
            num_devices: int = 1) -> RooflineTerms:
    """Build the three terms for one region from its events (per GPU);
    ``model_flops_total`` is the whole job's and is divided by
    ``num_devices`` here."""
    links = (nvlink_links_used if nvlink_links_used is not None
             else chip.nvlink_links)
    wire = ev["ICI_TOTAL_BYTES"]
    return RooflineTerms(
        cell=cell,
        t_compute=t_compute(ev, chip),
        t_memory=ev["BYTES_ACCESSED"] / chip.hbm_bw,
        t_nvlink=(wire / (max(links, 1) * chip.nvlink_bw_per_link)
                  if wire else 0.0),
        model_flops_per_device=model_flops_total / max(num_devices, 1),
        declared_flops_per_device=ev["FLOPS_TOTAL"],
        chip=chip.name,
    )
