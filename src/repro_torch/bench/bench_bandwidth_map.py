"""Paper §VI future plans on one GPU: the bandwidth map.

Counterpart of ``benchmarks/bench_bandwidth_map.py``: (a) the map measured
with the port's triad kernel over working sets of 16 KiB to 2 GiB,
repeats back to back with no L2 flush, so the L2 plateau and the HBM
floor both show; (b) the data-sheet map of the same card (levels REG,
SMEM, L2, HBM; "n/a" where the data sheet gives no bandwidth).

Run on the card: ``python -m repro_torch.bench.bench_bandwidth_map``
(``--smoke`` for 16 KiB .. 64 MiB and 2 repeats, ``--device cpu`` for the
host's caches through the plain version).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.core import hwinfo
from repro_torch.core.bandwidth import (DEFAULT_SIZES, measure_map,
                                        model_map, render_map)
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    chip = hwinfo.current_chip(dev)
    sizes = [s for s in DEFAULT_SIZES if s <= 64 << 20] if args.smoke \
        else DEFAULT_SIZES
    pts = measure_map(sizes, repeats=2 if args.smoke else 5, device=dev,
                      chip=chip)
    print(render_map(pts, title=f"bandwidth map — {chip.name} ({dev}, "
                                f"measured, triad kernel, L2 not flushed)"))
    print()
    print(render_map(model_map(chip),
                     title=f"bandwidth map — {chip.name} (data sheet)"))
    l2 = [p for p in pts if p.level == "L2"]
    hbm = [p for p in pts if p.working_set_bytes >= 4 * chip.l2_bytes]
    summary = {
        "l2_plateau_gbps": max(p.bandwidth for p in l2) / 1e9 if l2 else None,
        "hbm_floor_gbps": (min(p.bandwidth for p in hbm) / 1e9
                           if hbm else None),
        "hbm_peak_gbps": chip.hbm_bw / 1e9}
    print(f"\nL2 plateau {summary['l2_plateau_gbps']} GB/s, HBM (>= 4x L2) "
          f"{summary['hbm_floor_gbps']} GB/s, data sheet "
          f"{summary['hbm_peak_gbps']:.0f} GB/s")
    res = {"chip": chip.name, "summary": summary,
           "points": [dataclasses.asdict(p) for p in pts]}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
