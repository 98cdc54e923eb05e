"""Hardware data sheets — LIKWID's per-microarchitecture tables, for the GPU.

The JAX package keys TPU data sheets by ``device_kind``; the port keys
NVIDIA data sheets by the name ``torch.cuda.get_device_name`` reports,
because the SXM and PCIe H100 share a chip and differ in every rate.
Numbers are static truth from the data sheets (NVIDIA H100 Tensor Core
GPU data sheet and the NVIDIA H100 architecture white paper: SXM5 and
PCIe columns, dense rates without sparsity), not measured at run time;
:func:`check_device` holds the ones the CUDA runtime reports
(``torch.cuda.get_device_properties``) against them.

Field names follow the JAX package where the meaning carries
(``peak_bf16_flops``, ``peak_f32_flops``, ``peak_int8_ops``, ``hbm_bytes``,
``hbm_bw``, ``clock_hz``, :meth:`ChipSpec.flops_for_dtype`); Hopper names
replace the TPU's where it does not (``sm_count``, ``l2_bytes``,
``smem_per_sm``, NVLink for ICI).  All bandwidths are bytes/s, all compute
rates FLOP/s (OP/s for int8).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import torch

__all__ = ["ChipSpec", "CHIP_REGISTRY", "H100_SXM", "H100_PCIE", "HOST_CPU",
           "lookup_chip", "current_chip", "check_device"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Data sheet of one accelerator (one CUDA device)."""

    name: str                      # canonical short name, e.g. "h100-sxm"
    device_kinds: tuple            # matched against the device name
    # --- compute ---
    peak_bf16_flops: float         # FLOP/s, tensor cores, bf16 dense
    peak_f32_flops: float          # FLOP/s, fp32 on CUDA cores
    peak_int8_ops: float           # OP/s, tensor cores, int8 dense
    sm_count: int                  # streaming multiprocessors
    clock_hz: float                # max boost clock
    # --- memory hierarchy (HBM -> L2 -> shared memory -> registers) ---
    hbm_bytes: int                 # device memory capacity
    hbm_bw: float                  # device memory bandwidth, bytes/s
    l2_bytes: int                  # L2 cache
    smem_per_sm: int               # shared memory per SM (with L1: 256 KB)
    smem_per_block: int            # opt-in dynamic shared memory per block
    regs_per_sm: int               # 32-bit registers per SM
    # --- interconnect ---
    nvlink_links: int              # NVLink links per GPU
    nvlink_bw_per_link: float      # bytes/s per link, both directions

    @property
    def nvlink_bw(self) -> float:
        """Aggregate NVLink bytes/s if all links are active."""
        return self.nvlink_links * self.nvlink_bw_per_link

    def flops_for_dtype(self, dtype_name: str) -> float:
        if dtype_name in ("bfloat16", "float16", "bf16", "f16"):
            return self.peak_bf16_flops
        if dtype_name in ("int8", "s8"):
            return self.peak_int8_ops
        return self.peak_f32_flops


H100_SXM = ChipSpec(
    name="h100-sxm",
    device_kinds=("H100 80GB HBM3", "H100 SXM"),
    peak_bf16_flops=989e12,
    peak_f32_flops=67e12,
    peak_int8_ops=1979e12,
    sm_count=132,
    clock_hz=1.98e9,
    hbm_bytes=80 * 10**9,
    hbm_bw=3.35e12,
    l2_bytes=50 * 2**20,
    smem_per_sm=228 * 1024,
    smem_per_block=227 * 1024,
    regs_per_sm=65536,
    nvlink_links=18,
    nvlink_bw_per_link=50e9,        # 900 GB/s in all
)

H100_PCIE = ChipSpec(
    name="h100-pcie",
    device_kinds=("H100 PCIe",),
    peak_bf16_flops=756e12,
    peak_f32_flops=51e12,
    peak_int8_ops=1513e12,
    sm_count=114,
    clock_hz=1.755e9,
    hbm_bytes=80 * 10**9,
    hbm_bw=2.0e12,
    l2_bytes=50 * 2**20,
    smem_per_sm=228 * 1024,
    smem_per_block=227 * 1024,
    regs_per_sm=65536,
    nvlink_links=0,                 # a bridge pairs two cards at most
    nvlink_bw_per_link=0.0,
)

# The host entry lets the tools run on a machine without a GPU, as the
# tests do; its numbers are generic single-socket estimates.
HOST_CPU = ChipSpec(
    name="host-cpu",
    device_kinds=("cpu",),
    peak_bf16_flops=0.5e12,
    peak_f32_flops=0.25e12,
    peak_int8_ops=1.0e12,
    sm_count=1,
    clock_hz=3.0e9,
    hbm_bytes=16 * 2**30,
    hbm_bw=50e9,
    l2_bytes=32 * 2**20,
    smem_per_sm=0,
    smem_per_block=0,
    regs_per_sm=0,
    nvlink_links=0,
    nvlink_bw_per_link=0.0,
)

CHIP_REGISTRY: Dict[str, ChipSpec] = {
    spec.name: spec for spec in (H100_SXM, H100_PCIE, HOST_CPU)
}


def lookup_chip(name: str) -> ChipSpec:
    """Map a device name onto its data sheet; raise for a name with none.

    ``"cpu"`` is the host.  A GPU matches when one of a sheet's
    ``device_kinds`` occurs in its name ("NVIDIA H100 80GB HBM3").  There is
    no fallback: a wrong sheet would mislabel every rate."""
    low = name.lower()
    if low == "cpu":
        return HOST_CPU
    found = [spec for spec in (H100_SXM, H100_PCIE)
             if any(k.lower() in low for k in spec.device_kinds)]
    if len(found) != 1:
        raise ValueError(f"no data sheet for device {name!r}; known: "
                         f"{[k for s in (H100_SXM, H100_PCIE) for k in s.device_kinds]}")
    return found[0]


def current_chip(device: Optional[Union[str, torch.device]] = None
                 ) -> ChipSpec:
    """The data sheet of ``device`` (``None`` -> ``cuda``, which raises
    when no GPU is visible)."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return HOST_CPU
    return lookup_chip(torch.cuda.get_device_name(dev))


def check_device(spec: ChipSpec, props) -> List[str]:
    """Disagreements between a data sheet and what the CUDA runtime reports
    (``torch.cuda.get_device_properties``): SM count and L2 size exactly,
    memory within 10% (the runtime reports usable bytes).  Empty when they
    agree."""
    bad = []
    if props.multi_processor_count != spec.sm_count:
        bad.append(f"SMs: device {props.multi_processor_count}, data sheet "
                   f"{spec.sm_count}")
    l2 = getattr(props, "L2_cache_size", None)
    if l2 is not None and l2 != spec.l2_bytes:
        bad.append(f"L2: device {l2} B, data sheet {spec.l2_bytes} B")
    if not 0.9 <= props.total_memory / spec.hbm_bytes <= 1.1:
        bad.append(f"memory: device {props.total_memory} B, data sheet "
                   f"{spec.hbm_bytes} B")
    return bad
