"""Paper Figs. 4-10 on one GPU: STREAM triad, pinned vs unpinned.

Counterpart of ``benchmarks/bench_stream_pinning.py``, in its two halves:

1. **Placement quality on the modelled production mesh** (the paper's
   actual variable): for each pin strategy, and for random orders
   standing in for the unpinned case, the ring-collective hop cost of the
   16x16 mesh's axes and of one flat 256-device ring, from the topology
   model alone (:func:`repro_torch.core.topology.synthesize` of the
   production spec: on the card :func:`~repro_torch.core.topology.probe`
   would return the one real H100).  The reference's four claims hold:
   compact lays perfect 2D rings, the snake a perfect 1D ring, the right
   pinning depends on the workload, and any deliberate pinning beats the
   unpinned median by over 2x.  Row ``stream_pin_hops``.
2. **Wall clock**: the triad through the kernel registry (kernel #6 on
   the card) at N = 2^27 fp32 — 512 MiB per array, 1.5 GiB in all, over
   4x the 50 MB L2 as the STREAM rule asks — 100 samples inside a
   ``PerfCtr`` marker region, each timed between CUDA events; quartiles
   printed like the paper's box plots, and the median's bandwidth against
   the data-sheet HBM peak.

Run on the card: ``python -m repro_torch.bench.bench_stream_pinning``
(``--smoke`` for N = 2^20, 10 samples and 5 random orders, ``--device
cpu`` for the plain version on the host, ``--json PATH`` to keep the
numbers).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.bench.common import claim
from repro_torch.core import pin as pin_mod
from repro_torch.core import topology as topo_mod
from repro_torch.core.perfctr import PerfCtr
from repro_torch.kernels import registry
from repro_torch.kernels.stream_triad import triad_bytes


def _mesh_hop_cost(topo, order, axis_sizes=(16, 16)):
    """Ring-collective cost model: for each mesh axis, every ring step is a
    collective-permute between consecutive devices along that axis; cost =
    mean torus hops per step (1.0 = perfect rings)."""
    d, m = axis_sizes
    grid = np.asarray(order[:d * m]).reshape(d, m)
    hops = []
    for row in grid:                       # 'model' axis rings
        hops += [topo.ici_hops(int(row[j]), int(row[(j + 1) % m]))
                 for j in range(m)]
    for col in grid.T:                     # 'data' axis rings
        hops += [topo.ici_hops(int(col[i]), int(col[(i + 1) % d]))
                 for i in range(d)]
    return float(np.mean(hops))


def _flat_ring_cost(topo, order, n=256):
    """Hop cost of one 256-device 1D ring over the flat device order."""
    ids = list(order[:n])
    return float(np.mean([topo.ici_hops(ids[i], ids[(i + 1) % n])
                          for i in range(n)]))


def placement(csv: list, smoke: bool = False) -> dict:
    """The placement half: hop costs of the pin strategies and of random
    orders over the modelled 16x16 pod (raises if a claim fails)."""
    topo = topo_mod.synthesize(topo_mod.PRODUCTION_SINGLE_POD)
    n_random = 5 if smoke else 20
    print("== STREAM triad placement quality (production 16x16 mesh) ==")
    print(f"{'placement':<22} {'2D mesh-axis rings':>19} {'flat 1D ring':>14}")
    mesh_cost, flat_cost = {}, {}
    for name in ("compact", "scatter", "ring"):
        order = pin_mod.get_strategy(name)(topo).device_ids
        mesh_cost[name] = _mesh_hop_cost(topo, order)
        flat_cost[name] = _flat_ring_cost(topo, order)
        print(f"pin[{name}]{'':<13} {mesh_cost[name]:>19.3f} "
              f"{flat_cost[name]:>14.3f}")
    rng = np.random.default_rng(0)
    randoms_mesh, randoms_flat = [], []
    for _ in range(n_random):              # the unpinned distribution
        order = rng.permutation(256)
        randoms_mesh.append(_mesh_hop_cost(topo, order))
        randoms_flat.append(_flat_ring_cost(topo, order))
    q1, med, q3 = (float(v) for v in np.percentile(randoms_mesh,
                                                    [25, 50, 75]))
    medf = float(np.median(randoms_flat))
    print(f"{'unpinned (random x' + str(n_random) + ')':<22} "
          f"{med:>19.3f} {medf:>14.3f}   "
          f"[2D q1={q1:.3f} q3={q3:.3f} max={max(randoms_mesh):.3f}]")
    # the paper's conclusion, structurally: the right pinning is workload-
    # dependent (compact owns the 2D mesh axes, the snake owns a flat
    # ring) and ANY deliberate pinning beats the unpinned median by a wide
    # margin with zero variance
    claim(mesh_cost["compact"] <= 1.0 + 1e-9,
          f"compact 2D rings cost {mesh_cost['compact']} hops, not 1")
    claim(flat_cost["ring"] <= 1.0 + 1e-9,
          f"the snake's 1D ring costs {flat_cost['ring']} hops, not 1")
    claim(flat_cost["ring"] < flat_cost["compact"],
          "the snake does not beat compact on the flat ring")
    claim(med > 2.0 * mesh_cost["compact"],
          f"the unpinned median {med} is not over 2x compact's")
    csv.append(("stream_pin_hops", 0.0,
                f"compact2d={mesh_cost['compact']:.3f};"
                f"ring1d={flat_cost['ring']:.3f};unpinned2d_median={med:.3f}"))
    return {"mesh_cost": mesh_cost, "flat_cost": flat_cost,
            "unpinned_2d": {"q1": q1, "median": med, "q3": q3,
                            "max": float(max(randoms_mesh))},
            "unpinned_flat_median": medf, "random_orders": n_random}


def run(ctr: PerfCtr, *, n: int = 1 << 27, samples: int = 100,
        warmup: int = 1) -> dict:
    """Time ``samples`` fp32 triads of length ``n`` (the registry's
    ``stream_triad`` family) into a marker region of ``ctr``; returns the
    quartiles and bandwidths."""
    gen = torch.Generator(device=ctr.device).manual_seed(0)
    b = torch.randn(n, generator=gen, device=ctr.device)
    c = torch.randn(n, generator=gen, device=ctr.device)
    region = f"triad N={n} fp32"
    with ctr.marker(region):
        m = ctr.probe(registry.run, "stream_triad", b, c, warmup=warmup,
                      repeats=samples)
    q1, med, q3 = (float(v) for v in np.percentile(m.wall_times,
                                                    [25, 50, 75]))
    nbytes = triad_bytes(n, b.element_size())
    return {"region": region, "n": n, "dtype": "float32",
            "samples": samples, "q1_s": q1, "median_s": med, "q3_s": q3,
            "best_s": min(m.wall_times), "bytes": nbytes,
            "gbps_median": nbytes / med / 1e9,
            "gbps_best": nbytes / min(m.wall_times) / 1e9,
            "hbm_peak_gbps": ctr.chip.hbm_bw / 1e9,
            "launches": m.events["LAUNCHES"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    csv: list = []
    place = placement(csv, smoke=args.smoke)
    ctr = PerfCtr(groups=("HBM", "ROOFLINE"), device=args.device)
    res = run(ctr, n=1 << 20 if args.smoke else 1 << 27,
              samples=10 if args.smoke else 100)
    res["placement"] = place
    print(f"== STREAM triad on {ctr.chip.name} ({ctr.device}), "
          f"{res['samples']} samples, N={res['n']} fp32 ==")
    print(f"triad: median {res['median_s'] * 1e6:.1f} us  "
          f"[q1 {res['q1_s'] * 1e6:.1f}, q3 {res['q3_s'] * 1e6:.1f}]  -> "
          f"{res['gbps_median']:.1f} GB/s (best {res['gbps_best']:.1f}; "
          f"data-sheet HBM {res['hbm_peak_gbps']:.0f})")
    print(ctr.report())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
