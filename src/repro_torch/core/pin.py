"""repro-pin: placement control for logical meshes (likwid-pin).

Copied from ``repro/core/pin.py`` (pure Python); only the topology
import changes, to :mod:`repro_torch.core.topology`.  The strategies are
pure permutations over a :class:`NodeTopology`, so over a synthesized pod
they give the JAX package's orders.  On one H100 a probed topology holds
one device and every strategy returns it; the paper's CPU affinity and
NUMA placement have no counterpart in the JAX package and are not ported
(``ROADMAP.md``).  The reference's note follows.

likwid-pin binds threads to physical cores at creation time: the *same
program*, pinned differently, runs 2x faster or slower (paper Figs. 4-11).
On a TPU pod the analogous placement degree of freedom is **the order of
devices handed to ``jax.make_mesh``**: it decides which mesh axis walks
ICI-contiguous rings (cheap collectives) and which hops across hosts or pods
(expensive).  XLA owns intra-chip scheduling — the device permutation is the
one placement knob the user actually has, exactly as thread->core binding was
the one knob on x86.

The paper's CLI surface maps as:

=====================  =====================================================
likwid-pin             repro-pin
=====================  =====================================================
``-c 0-3,6``           :func:`parse_pinlist` explicit device lists
``-c N:0-7`` (logical) strategies: :class:`Compact`, :class:`Scatter`,
                       :class:`Ring`
skip mask ``-s 0x1``   :func:`apply_skip` — hold devices out (shepherd
                       threads -> hot spares for elastic restart, see
                       :mod:`repro.ft`)
``-t intel|gcc``       ``preset=`` names bundling strategy + skip mask
=====================  =====================================================

Every strategy is a *pure permutation* on the probed topology: property
tests assert each device appears exactly once and axis sizes are preserved.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.topology import NodeTopology

__all__ = [
    "PinStrategy",
    "Compact",
    "Scatter",
    "Ring",
    "Explicit",
    "parse_pinlist",
    "apply_skip",
    "get_strategy",
    "STRATEGIES",
    "PinResult",
]


# ---------------------------------------------------------------------------
# Pin strings ("-c 0-3,8,12-15")
# ---------------------------------------------------------------------------

_RANGE_RE = re.compile(r"^(\d+)(?:-(\d+))?$")


def parse_pinlist(s: str) -> List[int]:
    """Parse the paper's ``-c`` syntax: ``"0-3,8,12-15"`` -> explicit ids."""
    out: List[int] = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        m = _RANGE_RE.match(part)
        if not m:
            raise ValueError(f"bad pin range {part!r} in {s!r}")
        lo = int(m.group(1))
        hi = int(m.group(2)) if m.group(2) else lo
        if hi < lo:
            raise ValueError(f"descending pin range {part!r}")
        out.extend(range(lo, hi + 1))
    seen = set()
    uniq = []
    for i in out:
        if i in seen:
            raise ValueError(f"device {i} pinned twice in {s!r}")
        seen.add(i)
        uniq.append(i)
    return uniq


def apply_skip(ids: Sequence[int], skip: Sequence[int]) -> List[int]:
    """Remove skip-masked devices (shepherd threads -> hot spares)."""
    skipset = set(skip)
    return [i for i in ids if i not in skipset]


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PinResult:
    """A placement decision: an ordered device-id list + provenance."""

    device_ids: Tuple[int, ...]
    strategy: str
    skipped: Tuple[int, ...] = ()

    def describe(self) -> str:
        ids = list(self.device_ids)
        head = ",".join(map(str, ids[:12])) + ("..." if len(ids) > 12 else "")
        s = f"pin[{self.strategy}] {len(ids)} devices: {head}"
        if self.skipped:
            s += f"  (skip mask: {list(self.skipped)})"
        return s


class PinStrategy:
    """Produces a device ordering from a topology model."""

    name = "base"

    def order(self, topo: NodeTopology) -> List[int]:
        raise NotImplementedError

    def __call__(self, topo: NodeTopology,
                 skip: Sequence[int] = ()) -> PinResult:
        ids = apply_skip(self.order(topo), skip)
        return PinResult(tuple(ids), self.name, tuple(skip))


class Compact(PinStrategy):
    """Fill ICI-contiguous blocks first (paper: fill one socket's cores first).

    Orders chips pod-major, then row-major within the torus so adjacent mesh
    positions are adjacent torus chips: the innermost mesh axis rides
    contiguous ICI links and never leaves a pod until it is full.
    """

    name = "compact"

    def order(self, topo: NodeTopology) -> List[int]:
        return [c.device_id for c in sorted(
            topo.chips, key=lambda c: (c.pod, c.coords[2], c.coords[1], c.coords[0]))]


class Scatter(PinStrategy):
    """Round-robin across pods (paper: spread threads across sockets).

    Position i goes to pod ``i % num_pods``.  Maximizes aggregate HBM/DCN
    bandwidth per mesh-prefix — the right call for bandwidth-bound work that
    does not communicate on the inner axis (the paper's STREAM case), and the
    wrong call for collective-heavy inner axes (demonstrated in
    benchmarks/bench_stream_pinning.py).
    """

    name = "scatter"

    def order(self, topo: NodeTopology) -> List[int]:
        per_pod = [sorted((c for c in topo.chips_in_pod(p)),
                          key=lambda c: (c.coords[2], c.coords[1], c.coords[0]))
                   for p in range(topo.num_pods)]
        out: List[int] = []
        for i in range(topo.chips_per_pod):
            for p in range(topo.num_pods):
                if i < len(per_pod[p]):
                    out.append(per_pod[p][i].device_id)
        return out


class Ring(PinStrategy):
    """Order each pod's chips along a Hamiltonian ring on the 2D torus.

    Boustrophedon (snake) walk: row 0 left-to-right, row 1 right-to-left, ...
    Consecutive positions are always torus neighbors (wrap edge closes the
    ring), so a collective-permute or ring all-reduce over the flat order
    takes exactly 1 ICI hop per step — the minimum.  This is the placement
    the hillclimb in EXPERIMENTS.md §Perf uses for collective-bound cells.
    """

    name = "ring"

    def order(self, topo: NodeTopology) -> List[int]:
        out: List[int] = []
        for p in range(topo.num_pods):
            chips = topo.chips_in_pod(p)
            by_coord: Dict[Tuple[int, int, int], int] = {
                c.coords: c.device_id for c in chips}
            gx, gy, gz = topo.pod_grid
            for z in range(gz):
                for y in range(gy):
                    xs = range(gx) if y % 2 == 0 else range(gx - 1, -1, -1)
                    for x in xs:
                        if (x, y, z) in by_coord:
                            out.append(by_coord[(x, y, z)])
        return out


class Explicit(PinStrategy):
    """The paper's ``-c`` list: the user states the exact physical order."""

    name = "explicit"

    def __init__(self, pinlist: str):
        self.ids = parse_pinlist(pinlist)

    def order(self, topo: NodeTopology) -> List[int]:
        known = {c.device_id for c in topo.chips}
        missing = [i for i in self.ids if i not in known]
        if missing:
            raise ValueError(f"pinned devices not in topology: {missing}")
        return list(self.ids)


STRATEGIES: Dict[str, type] = {
    "compact": Compact,
    "scatter": Scatter,
    "ring": Ring,
}


def get_strategy(name: str) -> PinStrategy:
    """Resolve a strategy name or an explicit ``-c``-style list."""
    if name in STRATEGIES:
        return STRATEGIES[name]()
    if re.match(r"^[\d,\-\s]+$", name):
        return Explicit(name)
    raise ValueError(
        f"unknown pin strategy {name!r}; expected one of {sorted(STRATEGIES)} "
        f"or an explicit list like '0-63,128-191'")
