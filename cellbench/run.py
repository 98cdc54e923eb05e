"""Run one benchmark cell once.

    python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The run sets up (weights drawn on the card
from the seed, kernels built into ``build/`` on a checkout's first run),
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON line last on standard output:
the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
with the device's busy seconds and a breakdown (``--trace 1``), and the
numbers compared with their limits, which also end standard error.  It
exits non-zero, printing no result, without enough CUDA devices, or if
JAX or the package the port was made from was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict  # noqa: E402

from cellbench.bench import (ROOT, Cell, forbidden_modules,  # noqa: E402
                             metric_reader, result_line)

__all__ = ["main", "run_cell", "prepare_env"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def prepare_env(root: Path) -> None:
    """Put the port on the path and every cache of the program at a fixed
    place inside the checkout: the kernels build into ``build/``, and the
    tuning cache is an empty directory, so every run takes the kernels'
    default tiles and sweeps nothing."""
    os.environ["REPRO_CACHE_DIR"] = str(root / "build" / "cellbench-tune")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ.pop("REPRO_IMPL", None)
    os.environ.pop("REPRO_ATTN_IMPL", None)
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, logf: Callable[[str], None] = log) -> dict:
    """One run of ``cell`` on ``device``; returns the result's fields."""
    out = cell.kind.run(cell, seed, seconds, traced, device, t_start, logf)
    nums = cell.kind.check(cell, seed, out, device, logf)
    gc.collect()
    logf(f"[cellbench] readings {json.dumps(nums)}")
    nums = {k: v for k, v in nums.items() if isinstance(v, float)}
    # the cell's limits file names the numbers it compares
    compared = {k: {"value": nums.get(k), "limit": lim}
                for k, lim in cell.limits.items()}
    correct = (out["failed"] == 0 and bool(compared)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in compared.values()))
    ctx = out["ctx"]
    metrics: Dict[str, dict] = {}
    device_d = dict(out["device"])
    breakdown = None
    if traced:
        for m in cell.per_layer:
            v = metric_reader(cell.root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        prof = ctx.get("profile")
        if prof is not None:
            device_d["busy_s"] = prof["busy_s"]
            device_d["window_s"] = prof["window_s"]
            breakdown = {"device_ops": prof["device_ops"],
                         "idle_gaps": prof["idle_gaps"]}
            logf(f"[cellbench] idle by host span: "
                 f"{json.dumps(prof['idle_by_host'])}")
    else:
        for m in cell.end_to_end:
            v = out["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return dict(correct=correct, attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=device_d,
                compared=compared, breakdown=breakdown, e2e=out["e2e"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env(ROOT)
    cell = Cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"[cellbench] {args.workload} needs {cell.chips} CUDA "
            f"device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    bad = forbidden_modules()
    if bad:
        log(f"[cellbench] modules that no run may load: {bad}")
        return 3
    for k, v in res["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(result_line(res["correct"], res["attempted"], res["failed"],
                      res["metrics"], res["device"], res["compared"],
                      res["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
