"""repro-topology CLI (likwid-topology), on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.topology          # the card
    PYTHONPATH=src python -m repro_torch.launch.topology -g --json t.json
    PYTHONPATH=src python -m repro_torch.launch.topology --production \\
        --multi-pod --pin ring --skip 6,7       # the modelled pod
    PYTHONPATH=src python -m repro_torch.launch.topology --device cpu

Port of ``repro/launch/topology.py``.  Without ``--production`` it probes
the CUDA devices of this host (``--device cuda``, the default; raises
without a GPU) or synthesizes one card on ``--device cpu``; it prints the
summary and memory tables (``-g`` adds the grid), then the device order
``--pin`` and ``--skip`` give over that topology.  ``--mesh`` lays mesh
axes onto the links through ``launch/mesh.py``'s ``axis_ici_map``, which
is not ported yet: it exits with an error (``ROADMAP.md``, queue 1 item
14).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core import pin as pin_mod
from repro_torch.core import topology as topo_mod
from repro_torch.launch import cli


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("-g", "--graphical", action="store_true",
                    help="ASCII-art pod/GPU grid (the paper's -g)")
    ap.add_argument("--production", action="store_true",
                    help="describe the modelled production pod instead of "
                         "probing local devices")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None, metavar="AxB[xC]",
                    help="mesh-axis -> link map (needs launch/mesh.py: not "
                         "ported yet, ROADMAP.md queue 1 item 14)")
    ap.add_argument("--pin", default="compact",
                    help="pin strategy ordering the devices (compact | "
                         "scatter | ring | explicit pinlist)")
    ap.add_argument("--skip", default="",
                    help="device ids to hold out as hot spares, e.g. 6,7")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu "
                         "(a synthetic card)")
    cli.add_json_args(ap, what="topology summary")
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error("--mesh lays mesh axes onto the links through "
                 "launch/mesh.py's axis_ici_map, which is not ported yet "
                 "(ROADMAP.md, queue 1 item 14: mesh and fault tolerance)")

    if args.production:
        spec = (topo_mod.PRODUCTION_MULTI_POD if args.multi_pod
                else topo_mod.PRODUCTION_SINGLE_POD)
        topo = topo_mod.synthesize(spec)
    else:
        topo = topo_mod.probe(args.device)
    print(topo.render(graphical=args.graphical))
    skip = tuple(pin_mod.parse_pinlist(args.skip)) if args.skip else ()
    order = pin_mod.get_strategy(args.pin)(topo, skip=skip)
    print(order.describe())

    if args.json:
        payload = {
            "chips": len(topo.chips),
            "hosts": len({c.host for c in topo.chips}),
            "pods": topo.num_pods,
            "pod_grid": list(topo.pod_grid),
            "chips_per_host": topo.chips_per_host,
            "chip": topo.chip_spec.name,
            "sm_count": [c.core_count for c in topo.chips],
            "synthetic": topo.synthetic,
            "check_device": list(topo.check_device),
            "pin": {"strategy": order.strategy,
                    "device_ids": list(order.device_ids),
                    "skipped": list(order.skipped)},
        }
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        print(f"[topology] wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
