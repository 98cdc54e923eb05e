"""The port's bench runner: every ``repro_torch.bench`` bench in turn.

Counterpart of ``benchmarks/run.py`` for the port:

    PYTHONPATH=src python -m repro_torch.bench [--smoke] [--device cpu]
        [--json PATH] [--only serve,spec,...]

runs the serving benches (``serve``, ``paged_decode``, ``flash_prefill``,
``spec``, ``chaos``; ``mesh`` over 3 spawned ranks), the perfctr tool's own benches (``marker_overhead``,
``perfctr``), the kernel registry's autotune suite (``autotune``) and the
tool layer's case studies (``stream_pinning``, ``stencil_pinning``,
``jacobi_traffic``, ``bandwidth_map``), each with ``--smoke`` and
``--device`` passed on.
``--device`` defaults to ``cuda`` (raises without a GPU); every kernel is
built before the first bench.  A bench whose correctness claim fails
raises; the runner prints the traceback, marks it FAILED and goes on.
Speed bars are read from each summary's ``bars``.  The exit code is 1
when a bench failed or a bar was missed, else 0.  ``--json`` writes each
bench's status, seconds, summary and missed bars, and the CSV rows.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Dict, List

from repro_torch.bench import (bench_autotune, bench_bandwidth_map,
                               bench_chaos, bench_flash_prefill,
                               bench_jacobi_traffic, bench_marker_overhead,
                               bench_mesh,
                               bench_paged_decode, bench_perfctr,
                               bench_serve, bench_spec,
                               bench_stencil_pinning, bench_stream_pinning)
from repro_torch.bench.common import card_line, missed_bars, setup_device

#: benches whose ``run(csv, smoke=, device=)`` returns their summary
SERVING = {
    "serve": bench_serve,                  # fused loop vs per-token loop
    "paged_decode": bench_paged_decode,    # paged KV pool: bytes/token
    "flash_prefill": bench_flash_prefill,  # kernel #1 parity
    "spec": bench_spec,                    # speculative vs target-only
    "chaos": bench_chaos,                  # robustness under faults
}
#: the perfctr tool's benches, the same ``run(csv, smoke=, device=)``
TOOLS = {
    "marker_overhead": bench_marker_overhead,  # zero-overhead claim
    "perfctr": bench_perfctr,                  # the §II-A listing
    "autotune": bench_autotune,                # every tunable family
}
#: the case studies, driven through their ``main(argv)``
CASE_STUDIES = {
    "stream_pinning": bench_stream_pinning,    # Figs 4-10
    "stencil_pinning": bench_stencil_pinning,  # Fig 11
    "jacobi_traffic": bench_jacobi_traffic,    # Table I
    "bandwidth_map": bench_bandwidth_map,      # paper VI future plans
}
#: benches that spawn their own ranks (``run_spawned``)
MULTI_RANK = {
    "mesh": bench_mesh,                    # sharded parity, re-mesh
}
BENCHES = {**SERVING, **MULTI_RANK, **TOOLS, **CASE_STUDIES}


def run_bench(name: str, csv: list, smoke: bool, device) -> Dict:
    """One bench's summary."""
    if name in SERVING or name in TOOLS:
        return BENCHES[name].run(csv, smoke=smoke, device=device)
    if name in MULTI_RANK:
        return MULTI_RANK[name].run_spawned(csv, smoke=smoke, device=device)
    argv = ["--device", str(device)] + (["--smoke"] if smoke else [])
    return CASE_STUDIES[name].main(argv)


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI scale: tiny sizes, few reps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--only", default=None, metavar="NAME[,NAME...]",
                    help=f"run these benches (default: all of "
                         f"{list(BENCHES)})")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the runner's summary here")
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else list(BENCHES)
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        ap.error(f"unknown bench(es) {unknown}; choose from {list(BENCHES)}")
    device = setup_device(args.device)
    card = card_line(device)
    print(f"[repro_torch.bench] device {device}: {card}")
    csv: list = []
    report = []
    failures = missed = 0
    for name in names:
        doc = BENCHES[name].__doc__.strip().splitlines()[0]
        print("=" * 72)
        print(f"== bench: {name}   ({doc})")
        print("=" * 72)
        t0 = time.perf_counter()
        entry: Dict = {"name": name, "status": "ok"}
        try:
            summary = run_bench(name, csv, args.smoke, device)
        except Exception:               # a failed claim: record, go on
            failures += 1
            entry["status"] = "FAILED"
            traceback.print_exc()
        else:
            entry["summary"] = summary
            entry["bars_missed"] = missed_bars(summary)
            missed += len(entry["bars_missed"])
            for bar_name in entry["bars_missed"]:
                b = summary["bars"][bar_name]
                print(f"[{name}] bar missed: {bar_name} {b['value']:.3f} "
                      f"< {b['bar']}")
        entry["seconds"] = round(time.perf_counter() - t0, 3)
        report.append(entry)
        print(f"[{name}] {entry['status']} in {entry['seconds']:.1f}s\n")

    print("name,us_per_call,derived")
    for row in csv:
        print(f"{row[0]},{row[1]:.2f},{row[2]}")
    print(f"\n[repro_torch.bench] {len(names)} run, {failures} failed, "
          f"{missed} bar(s) missed")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"smoke": args.smoke, "device": str(device),
                       "card": card, "benches": report,
                       "csv": [{"name": n, "us_per_call": us, "derived": d}
                               for n, us, d in csv]},
                      f, indent=1, default=str)
        print(f"[repro_torch.bench] wrote {args.json}")
    return 1 if failures or missed else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
