"""The readings the correctness limits are set from, on the card:

    python3 -m cellbench.control --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2] --seconds 10 [--json control.json]

For each seed, in one process, one run of the cell at its own size and
load (a short window), then the numbers its check compares, read by the
module of the cell's kind (``kinds/<kind>.py::readings``): the program
against the float32 reference (the lower reading), and each control
against it (the reference computed in float8, the step below the
bfloat16 the configuration states, on the linear layers alone and on
the attention's products too: for a served model the token float8 puts
first at each served position, its gap read in float32's logits), and,
for a training cell, the fault of half the batch left out (the reference
over the first half of each batch's rows).  The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from cellbench.bench import ROOT, Cell
from cellbench.run import log, prepare_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default=None,
                    help="the seeds that also read the controls and faults "
                    "(default: every seed)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    prepare_env(ROOT)
    import torch
    if not torch.cuda.is_available():
        log("[cellbench] the control runs on the card")
        return 2
    device = torch.device("cuda", 0)
    cell = Cell(args.workload, ROOT)
    rows = []
    seeds = [int(s) for s in args.seeds.split(",")]
    with_controls = (set(seeds) if args.control_seeds is None else
                     {int(s) for s in args.control_seeds.split(",")})
    for seed in seeds:
        r = dict(seed=seed, **cell.kind.readings(
            cell, seed, args.seconds, device,
            controls=seed in with_controls))
        rows.append(r)
        print(json.dumps(r), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
