"""repro-perfctr CLI (likwid-perfCtr): an (arch x shape) cell's groups.

Port of ``repro/launch/perfctr.py``::

    python -m repro_torch.launch.perfctr -g ROOFLINE --arch qwen2-0.5b \\
        --shape train_4k
    python -m repro_torch.launch.perfctr -g HBM,ICI --arch zamba2-1.2b \\
        --shape decode_32k
    python -m repro_torch.launch.perfctr --list-groups

Wrapper mode over the dry run's record (:func:`repro_torch.launch.
dryrun.run_cell`: one rank of the production mesh walked on ``meta``,
its declared events; nothing runs, through the artifact cache);
``--execute`` adds multiplex mode: the cell's ``SMOKE`` config's loss
runs on the card (``--device cpu`` on the host, only when asked) and its
wall time is attached to the derived metrics.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.launch import cli


def _execute(spec, device: str) -> float:
    """Seconds a call of the SMOKE config's loss on ``device`` (the mean
    of 5 after one untimed call)."""
    import torch
    from repro_torch.core.features import default_features
    from repro_torch.models.lm import LM
    cfg = spec.smoke
    dev = torch.device(device)
    lm = LM(cfg, torch.bfloat16, dev,
            features=default_features().with_(remat_policy="none"))
    lm.init(torch.Generator(device=dev).manual_seed(0))
    batch = {"tokens": torch.zeros((2, 32), dtype=torch.int32, device=dev),
             "labels": torch.zeros((2, 32), dtype=torch.int32, device=dev)}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.zeros((2, 8, cfg.d_model),
                                          dtype=torch.bfloat16, device=dev)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (2, cfg.n_patches, cfg.d_model), dtype=torch.bfloat16,
            device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        lm.loss(batch)
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            lm.loss(batch)
        sync()
    return (time.perf_counter() - t0) / 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("-g", "--groups", default="ROOFLINE",
                    help="comma list: FLOPS_BF16,HBM,ICI,ROOFLINE,MOE,REMAT,"
                         "SERVE")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--list-groups", action="store_true")
    ap.add_argument("--execute", action="store_true",
                    help="multiplex mode: run the SMOKE config's loss and "
                         "attach its wall time to the derived metrics")
    ap.add_argument("--device", default="cuda",
                    help="where --execute runs (default cuda; cpu on the "
                         "host)")
    cli.add_impl_args(ap)
    cli.add_cache_args(ap)
    cli.add_json_args(ap, what="per-group event summary")
    args = ap.parse_args(argv)

    from repro_torch.core.groups import list_groups
    if args.list_groups:
        print(list_groups())
        return 0

    from repro_torch.configs import get_arch
    from repro_torch.core.events import EventCounts
    from repro_torch.core.perfctr import Measurement
    from repro_torch.launch import dryrun

    session = cli.session_from_args(args)
    if args.tune:
        cli.run_tune_suite(session)
    with cli.impl_context(args):
        rec = dryrun.run_cell(args.arch, args.shape, args.multi_pod,
                              out_dir=None, verbose=False, session=session)
    if rec["status"] != "ok":
        print(f"cell unavailable: {rec.get('reason') or rec.get('error')}")
        return 1

    # the record (walked, or from the artifact cache) carries the whole
    # event bag the groups read
    ev = EventCounts(counts=dict(rec["events"]))
    m = Measurement(region=rec["cell"], events=ev, chip=dryrun.CHIP,
                    num_devices=512 if args.multi_pod else 256)

    wall = None
    if args.execute:
        wall = _execute(get_arch(args.arch), args.device)
        m.wall_times.append(wall)
        print(f"[multiplex] smoke-config loss on {args.device}: "
              f"{wall * 1e3:.2f} ms a call")

    print(m.report(args.groups.split(",")))
    print(f"[{session.stats()}]")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"cell": rec["cell"], "status": rec["status"],
                       "groups": args.groups.split(","),
                       "events": rec["events"], "wall_s": wall,
                       "device": args.device if args.execute else None},
                      f, indent=2, default=float)
        print(f"[perfctr] wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
