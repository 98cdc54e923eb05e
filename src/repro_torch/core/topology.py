"""repro-topology: probe and render GPU topology (likwid-topology).

Port of ``repro/core/topology.py``.  likwid-topology reads ``cpuid`` to
recover the socket/core tree and the cache hierarchy; the port reads the
same facts for the CUDA devices of one host:

* the **card / SM** tree, from ``torch.cuda``: one :class:`Chip` per
  visible device, ``core_count`` its streaming multiprocessors
  (``multi_processor_count``), ``coords`` ``(i, 0, 0)``, host 0;
* the **memory hierarchy** HBM -> L2 -> shared memory per SM -> registers
  per SM, from the :mod:`repro_torch.core.hwinfo` data sheet of the probed
  card (static truth, as cpuid leaf 0x4 is), with
  :func:`repro_torch.core.hwinfo.check_device`'s disagreements between
  the sheet and the runtime listed under the summary table;
* the tensor-core bf16 peak and NVLink, where the TPU table shows the MXU,
  ICI and DCN.

``probe(device="cpu")`` synthesizes a topology, as the reference's probe
does on a host without TPUs: the modelled pod of :class:`TopoSpec`, whose
chips carry the H100 data sheet (the port has no TPU sheet).  The torus
model (``coords``, :meth:`NodeTopology.ici_hops`) is kept as it is, so
the pin strategies of :mod:`repro_torch.core.pin` give the reference's
orders over a synthesized pod; how NVSwitch and InfiniBand join H100s
into a cluster is not modelled yet (``ROADMAP.md``).

:class:`TopoSpec`, :func:`synthesize`, the production specs,
:class:`Chip` and :class:`NodeTopology` (``ici_hops``, ``same_host``, the
renderers) are the reference's; the memory table and :func:`probe` are
the GPU's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch

from repro_torch.core import hwinfo

__all__ = [
    "Chip",
    "NodeTopology",
    "TopoSpec",
    "probe",
    "synthesize",
    "PRODUCTION_SINGLE_POD",
    "PRODUCTION_MULTI_POD",
]


@dataclasses.dataclass(frozen=True)
class Chip:
    """One accelerator and its position in the job."""

    device_id: int                 # global flat id (CUDA ordinal or synthetic)
    pod: int                       # pod (slice) index
    host: int                      # process/host index within the job
    coords: Tuple[int, int, int]   # position in the torus model (x, y, z)
    core_count: int                # SMs on this card

    def ici_neighbors(self, grid: Tuple[int, int, int]) -> List[Tuple[int, int, int]]:
        """Torus-neighbor coordinates within this chip's pod."""
        x, y, z = self.coords
        gx, gy, gz = grid
        out = []
        for dx, dy, dz in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                           (0, 0, 1), (0, 0, -1)):
            nx, ny, nz = (x + dx) % gx, (y + dy) % gy, (z + dz) % gz
            if (nx, ny, nz) != (x, y, z) and (nx, ny, nz) not in out:
                # skip degenerate axes (grid size 1 wraps to self)
                if (dx and gx > 1) or (dy and gy > 1) or (dz and gz > 1):
                    out.append((nx, ny, nz))
        return out


@dataclasses.dataclass(frozen=True)
class TopoSpec:
    """Requested shape of a (possibly synthetic) job topology."""

    num_pods: int = 1
    pod_grid: Tuple[int, int, int] = (16, 16, 1)   # chips per pod, torus dims
    chips_per_host: int = 4
    chip: hwinfo.ChipSpec = hwinfo.H100_SXM

    @property
    def chips_per_pod(self) -> int:
        gx, gy, gz = self.pod_grid
        return gx * gy * gz

    @property
    def total_chips(self) -> int:
        return self.num_pods * self.chips_per_pod


#: The reference's production targets (a 16x16 slice; a 2-pod job), the
#: modelled pod the pin strategies and case studies lay out.
PRODUCTION_SINGLE_POD = TopoSpec(num_pods=1, pod_grid=(16, 16, 1))
PRODUCTION_MULTI_POD = TopoSpec(num_pods=2, pod_grid=(16, 16, 1))


def _size(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024:
            return f"{n:.0f} {unit}"
        n /= 1024
    return f"{n:.0f} TiB"


@dataclasses.dataclass(frozen=True)
class NodeTopology:
    """The probed/synthesized topology model — the tool's core data structure."""

    chip_spec: hwinfo.ChipSpec
    chips: Tuple[Chip, ...]
    pod_grid: Tuple[int, int, int]
    num_pods: int
    chips_per_host: int
    synthetic: bool                # True when built from a TopoSpec, not real devices
    #: data sheet against runtime disagreements of a probed card
    #: (:func:`repro_torch.core.hwinfo.check_device`; empty when they agree)
    check_device: Tuple[str, ...] = ()

    # ------------------------------------------------------------------ sizes
    @property
    def total_chips(self) -> int:
        return len(self.chips)

    @property
    def chips_per_pod(self) -> int:
        return self.total_chips // max(self.num_pods, 1)

    @property
    def num_hosts(self) -> int:
        return len({(c.pod, c.host) for c in self.chips})

    # --------------------------------------------------------------- lookups
    def chips_in_pod(self, pod: int) -> List[Chip]:
        return [c for c in self.chips if c.pod == pod]

    def chip_by_id(self, device_id: int) -> Chip:
        for c in self.chips:
            if c.device_id == device_id:
                return c
        raise KeyError(device_id)

    def same_host(self, a: int, b: int) -> bool:
        ca, cb = self.chip_by_id(a), self.chip_by_id(b)
        return (ca.pod, ca.host) == (cb.pod, cb.host)

    def ici_hops(self, a: int, b: int) -> int:
        """Torus manhattan distance between two chips (-1 across pods).

        Cross-pod traffic rides the data-center network, not the pod's
        links; -1 lets callers special-case it (the paper's analogue:
        traffic crossing the socket boundary uses QPI, not the shared L3).
        """
        ca, cb = self.chip_by_id(a), self.chip_by_id(b)
        if ca.pod != cb.pod:
            return -1
        hops = 0
        for d, g in zip((0, 1, 2), self.pod_grid):
            dist = abs(ca.coords[d] - cb.coords[d])
            hops += min(dist, g - dist)  # torus wraparound
        return hops

    # ------------------------------------------------------------- rendering
    def summary_table(self) -> str:
        """The paper's 'Hardware Thread Topology' table, for cards."""
        spec = self.chip_spec
        lines = []
        w = 72
        lines.append("*" * w)
        lines.append("Pod / GPU / SM Topology".center(w))
        lines.append("*" * w)
        lines.append(f"GPU type:         {spec.name}" + ("  [synthetic probe]" if self.synthetic else ""))
        lines.append(f"GPU clock:        {spec.clock_hz/1e9:.2f} GHz")
        lines.append(f"Pods:             {self.num_pods}")
        lines.append(f"GPUs per pod:     {self.chips_per_pod}  (torus {self.pod_grid[0]}x{self.pod_grid[1]}" +
                     (f"x{self.pod_grid[2]}" if self.pod_grid[2] > 1 else "") + ")")
        lines.append(f"Hosts:            {self.num_hosts}  ({self.chips_per_host} GPUs/host)")
        lines.append(f"SMs per GPU:      {spec.sm_count}")
        lines.append("-" * w)
        lines.append(f"{'Device':>8} {'Pod':>5} {'Host':>6} {'Coords':>12} {'SMs':>6}")
        show = list(self.chips[:8])
        for c in show:
            lines.append(f"{c.device_id:>8} {c.pod:>5} {c.host:>6} "
                         f"{str(c.coords):>12} {c.core_count:>6}")
        if self.total_chips > len(show):
            lines.append(f"{'...':>8} ({self.total_chips - len(show)} more GPUs)")
        lines.append("-" * w)
        if self.check_device:
            lines.append("Data sheet disagrees with the runtime:")
            lines += [f"  {msg}" for msg in self.check_device]
            lines.append("-" * w)
        return "\n".join(lines)

    def memory_table(self) -> str:
        """cpuid-leaf-0x4 analogue: deterministic memory-hierarchy parameters."""
        spec = self.chip_spec
        w = 72
        lines = []
        lines.append("*" * w)
        lines.append("Memory Hierarchy  (HBM -> L2 -> SMEM -> REG)".center(w))
        lines.append("*" * w)
        lines.append(f"{'Level':<8} {'Size':>12} {'Bandwidth':>14} {'Scope':>22}")
        lines.append(f"{'HBM':<8} {_size(spec.hbm_bytes):>12} {spec.hbm_bw/1e9:>10.0f} GB/s {'per GPU':>22}")
        lines.append(f"{'L2':<8} {_size(spec.l2_bytes):>12} {'(on-chip)':>14} {'per GPU':>22}")
        lines.append(f"{'SMEM':<8} {_size(spec.smem_per_sm):>12} {'(on-chip)':>14} {'per SM':>22}")
        lines.append(f"{'REG':<8} {_size(4 * spec.regs_per_sm):>12} {'(register)':>14} {'per SM':>22}")
        lines.append("-" * w)
        lines.append(f"Tensor cores:     {spec.sm_count} SMs x 4")
        lines.append(f"Peak bf16:        {spec.peak_bf16_flops/1e12:.0f} TFLOP/s per GPU (dense)")
        lines.append(f"NVLink:           {spec.nvlink_links} links x {spec.nvlink_bw_per_link/1e9:.0f} GB/s")
        lines.append("-" * w)
        return "\n".join(lines)

    def ascii_art(self, max_cols: int = 16) -> str:
        """The paper's '-g' ASCII-art output, drawn for the torus grid.

        Each pod is drawn as its chip grid; each cell shows the device id.
        The box nesting mirrors the paper's socket/L3 drawing: pod box =
        socket, chip cell = core+caches, the pod-level HBM line = L3.
        """
        out: List[str] = []
        gx, gy, _ = self.pod_grid
        for pod in range(self.num_pods):
            chips = sorted(self.chips_in_pod(pod), key=lambda c: (c.coords[1], c.coords[0]))
            cell = 6
            inner = min(gx, max_cols) * cell
            out.append(f"+{'-' * inner}+   Pod {pod}")
            for row in range(gy):
                row_chips = [c for c in chips if c.coords[1] == row][:max_cols]
                cells = "".join(f"{c.device_id:^{cell}}" for c in row_chips)
                out.append(f"|{cells:<{inner}}|")
            spec = self.chip_spec
            hbm = f" HBM {spec.hbm_bytes // 2**30} GiB x {len(chips)} GPUs, {gx}x{gy} torus "
            out.append(f"|{hbm:^{inner}}|")
            out.append(f"+{'-' * inner}+")
        return "\n".join(out)

    def render(self, graphical: bool = False) -> str:
        parts = [self.summary_table(), "", self.memory_table()]
        if graphical:
            parts += ["", self.ascii_art()]
        return "\n".join(parts)


# ---------------------------------------------------------------------------
# Probing
# ---------------------------------------------------------------------------

def _torus_coords(i: int, grid: Tuple[int, int, int]) -> Tuple[int, int, int]:
    gx, gy, _ = grid
    return (i % gx, (i // gx) % gy, i // (gx * gy))


def synthesize(spec: TopoSpec) -> NodeTopology:
    """Build the topology model for a :class:`TopoSpec` without real devices."""
    chips: List[Chip] = []
    did = 0
    hosts_per_pod = -(-spec.chips_per_pod // spec.chips_per_host)
    for pod in range(spec.num_pods):
        for i in range(spec.chips_per_pod):
            chips.append(Chip(
                device_id=did,
                pod=pod,
                # host ids are GLOBAL: pod 1's first host is not pod 0's
                host=pod * hosts_per_pod + i // spec.chips_per_host,
                coords=_torus_coords(i, spec.pod_grid),
                core_count=spec.chip.sm_count,
            ))
            did += 1
    return NodeTopology(
        chip_spec=spec.chip,
        chips=tuple(chips),
        pod_grid=spec.pod_grid,
        num_pods=spec.num_pods,
        chips_per_host=spec.chips_per_host,
        synthetic=True,
    )


def _grid_for_count(n: int) -> Tuple[int, int, int]:
    """Choose a near-square 2D torus grid for n chips."""
    gx = int(math.sqrt(n))
    while gx > 1 and n % gx:
        gx -= 1
    return (max(gx, 1), n // max(gx, 1), 1)


def probe(device: Optional[Union[str, torch.device]] = None,
          spec: Optional[TopoSpec] = None) -> NodeTopology:
    """Probe this host's GPU topology (the tool's main entry point).

    * ``device`` ``None`` or ``cuda``: read every visible CUDA device from
      ``torch.cuda`` (raises when there is none): the cpuid path.
    * ``device="cpu"``: synthesize from ``spec`` (default: one card), as
      the reference does on a host without accelerators.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        if spec is None:
            spec = TopoSpec(num_pods=1, pod_grid=_grid_for_count(1),
                            chips_per_host=1)
        return synthesize(spec)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for a synthetic topology")
    n = torch.cuda.device_count()
    chips, sheets, bad = [], set(), []
    for i in range(n):
        props = torch.cuda.get_device_properties(i)
        sheet = hwinfo.current_chip(torch.device("cuda", i))
        sheets.add(sheet)
        bad += [f"device {i}: {msg}"
                for msg in hwinfo.check_device(sheet, props)]
        chips.append(Chip(device_id=i, pod=0, host=0, coords=(i, 0, 0),
                          core_count=props.multi_processor_count))
    if len(sheets) != 1:
        raise ValueError(f"mixed cards on one host: {sorted(s.name for s in sheets)}")
    return NodeTopology(
        chip_spec=sheets.pop(),
        chips=tuple(chips),
        pod_grid=(n, 1, 1),
        num_pods=1,
        chips_per_host=n,
        synthetic=False,
        check_device=tuple(bad),
    )
