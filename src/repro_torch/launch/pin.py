"""repro-pin CLI (likwid-pin): show/compare placement strategies.

    python -m repro_torch.launch.pin -c compact --multi-pod
    python -m repro_torch.launch.pin -c "0-63,128-191" --skip 5,17
    python -m repro_torch.launch.pin --compare    # hop table, all strategies

Port of ``repro/launch/pin.py``, over the same modelled pod
(:func:`repro_torch.core.topology.synthesize` of the production spec):
the hop table is the placement-quality metric, the mean torus hops
between mesh-adjacent devices per axis (1.0 = every collective step rides
one link), and the share of pairs that cross pods.  It reads no device,
so it prints the same table on the host and on the card.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import pin as pin_mod
from repro_torch.core import topology as topo_mod


def _hop_stats(topo, order, axis_sizes):
    """Mean torus hops between consecutive devices along each mesh axis."""
    arr = np.array(order).reshape(axis_sizes)
    stats = {}
    for ax in range(arr.ndim):
        pairs = []
        moved = np.moveaxis(arr, ax, 0)
        for i in range(moved.shape[0] - 1):
            for a, b in zip(moved[i].ravel(), moved[i + 1].ravel()):
                h = topo.ici_hops(int(a), int(b))
                pairs.append(h if h >= 0 else np.nan)  # cross-pod
        pairs = np.array(pairs, float)
        stats[ax] = (np.nanmean(pairs) if np.isfinite(pairs).any() else
                     float("nan"),
                     float(np.mean(np.isnan(pairs))))
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-c", "--cpulist", default="compact",
                    help="strategy name or explicit device list")
    ap.add_argument("--skip", default="",
                    help="skip mask, e.g. '5,17' (hot spares)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--compare", action="store_true")
    args = ap.parse_args(argv)

    spec = (topo_mod.PRODUCTION_MULTI_POD if args.multi_pod
            else topo_mod.PRODUCTION_SINGLE_POD)
    topo = topo_mod.synthesize(spec)
    skip = pin_mod.parse_pinlist(args.skip) if args.skip else []
    axis_sizes = (2, 16, 16) if args.multi_pod else (16, 16)

    names = (list(pin_mod.STRATEGIES) if args.compare else [args.cpulist])
    print(f"{'strategy':<10} {'axis':>4} {'mean ICI hops':>14} "
          f"{'cross-pod frac':>15}")
    for name in names:
        strat = pin_mod.get_strategy(name)
        res = strat(topo, skip=skip)
        if len(res.device_ids) < int(np.prod(axis_sizes)):
            print(f"{name:<10} insufficient devices after skip")
            continue
        order = res.device_ids[:int(np.prod(axis_sizes))]
        for ax, (hops, xpod) in _hop_stats(topo, order, axis_sizes).items():
            print(f"{name:<10} {ax:>4} {hops:>14.2f} {xpod:>15.2f}")
        if not args.compare:
            print(res.describe())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
