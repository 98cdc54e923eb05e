"""repro-topology CLI (likwid-topology), on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.topology          # the card
    PYTHONPATH=src python -m repro_torch.launch.topology -g --json t.json
    PYTHONPATH=src python -m repro_torch.launch.topology --production \\
        --multi-pod --pin ring --skip 6,7       # the modelled pod
    PYTHONPATH=src python -m repro_torch.launch.topology --device cpu
    PYTHONPATH=src python -m repro_torch.launch.topology --production \
        --mesh 16x16 --pin ring --json topo.json  # + mesh-axis -> link map

Port of ``repro/launch/topology.py``.  Without ``--production`` it probes
the CUDA devices of this host (``--device cuda``, the default; raises
without a GPU) or synthesizes one card on ``--device cpu``; it prints the
summary and memory tables (``-g`` adds the grid), then the device order
``--pin`` and ``--skip`` give over that topology.  ``--mesh AxB[xC]``
also shows how the pin strategy lays each mesh axis onto the links
(``launch/mesh.py``'s ``axis_ici_map``): the rank order
``make_serve_mesh`` / ``make_production_mesh`` build their meshes in.
The port keeps the reference's torus model, so orders and hop counts
match the JAX CLI's; how NVSwitch and InfiniBand join H100s is not
modelled (``ROADMAP.md``).  A mesh larger than the devices the pin
leaves exits 2.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core import pin as pin_mod
from repro_torch.core import topology as topo_mod
from repro_torch.launch import cli


def _parse_shape(text: str, ap: argparse.ArgumentParser):
    try:
        shape = tuple(int(p) for p in text.lower().split("x"))
        if not shape or any(s < 1 for s in shape):
            raise ValueError
    except ValueError:
        ap.error(f"--mesh wants AxB[xC] with positive sizes, got {text!r}")
    return shape


def _axes_for(shape) -> tuple:
    # match mesh_axes(): trailing axes are (data, model), a third
    # leading axis is the pod axis
    names = ("pod", "data", "model")
    return names[len(names) - len(shape):] if len(shape) <= 3 else tuple(
        f"ax{i}" for i in range(len(shape) - 2)) + ("data", "model")


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
                    help="also print the mesh-axis -> link map the pin "
                         "strategy produces for this mesh shape")
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

    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import axis_ici_map
        shape = _parse_shape(args.mesh, ap)
        axes = _axes_for(shape)
        need = int(np.prod(shape))
        if len(order.device_ids) < need:
            ap.error(f"pin[{args.pin}] leaves {len(order.device_ids)} "
                     f"devices; mesh {args.mesh} needs {need}")
        ids = list(order.device_ids[:need])
        rows = axis_ici_map(topo, ids, shape, axes)
        print(f"Mesh {args.mesh} (axes {'x'.join(axes)}, "
              f"pin={order.strategy}):")
        for row in rows:
            ring = "ring" if row["ring"] else (
                f"mean {row['mean_hops']:.1f} / max {row['max_hops']} hops"
                + (f", {row['dcn_crossings']} pod crossings"
                   if row["dcn_crossings"] else ""))
            print(f"  axis {row['axis']:<6} size {row['size']:>3}  {ring}")
        mesh = {"shape": list(shape), "axes": list(axes), "pin": args.pin,
                "device_ids": ids, "axis_ici_map": rows}

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
        if mesh is not None:
            payload["mesh"] = mesh
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        print(f"[topology] wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
