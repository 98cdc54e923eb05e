"""Aggregate dry-run records into a roofline table for the H100.

Port of ``repro/launch/roofline_report.py``::

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
        --records experiments/dryrun --mesh 16x16 [--markdown]

    # (re)generate the records first, through the artifact cache: cold,
    # one walk a cell (repro_torch.launch.dryrun); warm, none
    PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
        --sweep --archs qwen2-0.5b,zamba2-1.2b --parallel 4

Per (arch x shape) cell: the three roofline terms (``Tn``: NVLink, where
the reference has ``Ti`` for ICI), the bottleneck, the MODEL_FLOPS over
declared FLOPs usefulness ratio, the HBM fit (an estimate: the dry run's
live-bytes peak) and a one-line 'what would move the dominant term down'
from the event profile, in the card's terms (shared memory, tensor
cores, NVLink).
"""

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.launch import cli


def _advice(rec: Dict) -> str:
    """One sentence: what would move the dominant term down."""
    r = rec["roofline"]
    c = rec["collectives"]
    kind = rec["kind"]
    bound = r["bound"]
    if bound == "memory":
        if kind == "train" and r["useful_flops_ratio"] < 0.8:
            return ("recompute traffic: relax remat / chunk attention so "
                    "score tensors never round-trip HBM")
        if kind == "decode":
            return ("decode is KV-cache streaming: shrink cache reads "
                    "(GQA width, quantized KV) or batch more tokens/step")
        return ("blockwise-fuse attention (flash kernel) so [B,H,S,S] "
                "scores stay in shared memory")
    if bound == "nvlink":
        ag = c["ICI_AG_BYTES"]
        ar = c["ICI_AR_BYTES"]
        if ar >= ag:
            return ("all-reduces dominate NVLink: reduce-scatter to shards "
                    "(ZeRO), overlap with bwd, or int8-EF compress")
        return ("weight all-gathers dominate NVLink: prefetch FSDP gathers "
                "under compute or shrink the model axis")
    # compute-bound: the good case
    if r["useful_flops_ratio"] < 0.7:
        return ("compute-bound but 30%+ of FLOPs are recompute or "
                "replicated work: save dots selectively, split whole heads")
    return "near roofline: only kernel-level tensor-core utilization left"


def load_records(records_dir: str, mesh: str,
                 include_tagged: bool = False) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(records_dir, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("mesh") != mesh or rec.get("status") != "ok":
            continue
        if "@" in rec.get("cell", "") and not include_tagged:
            continue          # tagged variants, not baselines
        out.append(rec)
    return out


def render(records: List[Dict], markdown: bool = False) -> str:
    rows = []
    hdr = ("cell", "Tc ms", "Tm ms", "Tn ms", "bound", "mfu_bound",
           "useful", "HBM x", "next move")
    for rec in sorted(records, key=lambda r: r["cell"]):
        r = rec["roofline"]
        rows.append((
            rec["cell"].rsplit("/", 1)[0],
            f"{r['t_compute_s']*1e3:9.2f}",
            f"{r['t_memory_s']*1e3:9.2f}",
            f"{r['t_nvlink_s']*1e3:9.2f}",
            r["bound"],
            f"{r['mfu_bound']:.3f}",
            f"{r['useful_flops_ratio']:.2f}",
            f"{rec['memory_analysis']['hbm_fraction']:.2f}",
            _advice(rec),
        ))
    if markdown:
        lines = ["| " + " | ".join(hdr) + " |",
                 "|" + "---|" * len(hdr)]
        lines += ["| " + " | ".join(row) + " |" for row in rows]
        return "\n".join(lines)
    w = [max(len(str(r[i])) for r in rows + [hdr])
         for i in range(len(hdr) - 1)]
    lines = ["  ".join(h.ljust(w[i]) for i, h in enumerate(hdr[:-1]))
             + "  " + hdr[-1]]
    lines.append("-" * 120)
    for row in rows:
        lines.append("  ".join(str(row[i]).ljust(w[i])
                               for i in range(len(hdr) - 1)) + "  " + row[-1])
    return "\n".join(lines)


def pick_hillclimb(records: List[Dict]) -> Dict[str, str]:
    """The three picks: worst mfu ceiling, most collective-bound, most
    representative (the largest train cell)."""
    train = [r for r in records if r["kind"] == "train"]
    worst = min(records, key=lambda r: r["roofline"]["mfu_bound"])
    coll = max(records, key=lambda r: r["roofline"]["t_nvlink_s"]
               / max(r["roofline"]["t_compute_s"], 1e-12))
    rep = max(train, key=lambda r: r["n_params"]) if train else worst
    return {"worst_mfu_bound": worst["cell"],
            "most_collective_bound": coll["cell"],
            "most_representative": rep["cell"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--records", default="experiments/dryrun")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="(re)generate the records via session.sweep "
                         "before rendering (cache-backed)")
    ap.add_argument("--archs", default=None,
                    help="comma list for --sweep (default: every arch)")
    ap.add_argument("--shapes", default=None,
                    help="comma list for --sweep (default: every shape)")
    ap.add_argument("--parallel", type=int, default=4)
    cli.add_impl_args(ap)
    cli.add_cache_args(ap)
    cli.add_json_args(ap, what="roofline-table summary")
    args = ap.parse_args(argv)

    if args.sweep:
        from repro_torch.configs import SHAPES, list_archs
        session = cli.session_from_args(args)
        if args.tune:
            cli.run_tune_suite(session)
        archs = (args.archs.split(",") if args.archs
                 else [s.arch_id for s in list_archs()])
        shapes = args.shapes.split(",") if args.shapes else list(SHAPES)
        with cli.impl_context(args):
            session.sweep(archs, shapes, parallel=args.parallel,
                          multi_pod=args.mesh == "2x16x16",
                          out_dir=args.records)
        print(f"[sweep] {session.stats()}")

    records = load_records(args.records, args.mesh)
    if not records:
        print(f"no records for mesh {args.mesh} under {args.records}")
        return 1
    print(render(records, markdown=args.markdown))
    print()
    hill = pick_hillclimb(records)
    for k, v in hill.items():
        print(f"{k}: {v}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"mesh": args.mesh,
                       "cells": [{"cell": r["cell"], "kind": r["kind"],
                                  "bound": r["roofline"]["bound"]}
                                 for r in records],
                       "hillclimb": hill}, f, indent=2, default=float)
        print(f"[roofline] wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
