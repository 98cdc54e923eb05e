"""Registry autotune suite: every tunable family, disk-warm restarts.

Counterpart of ``benchmarks/bench_autotune.py``: sweep the tune space of
EVERY tunable kernel family (the flash kernel's ``(bq, bk)``, both paged
kernels' ``(page_size, split)``, the argmax split of the sampling impls,
the SSD chunk, the triad's ``block_rows``, the Jacobi column's
``block_x``) through one ``ProfileSession``, persisting winners in the
artifact cache.  On the card every candidate is timed (device time, L2
flushed); on the CPU (``--device cpu``) it is scored by the roofline over
its declared events.  Because both the probes AND the sweep outcomes are
content-addressed cache entries, a re-run in a **fresh process** must do
**zero sweeps and zero timed probes** — ``--assert-warm`` enforces exactly
that.  ``--dump`` writes the resolved tune table (``TUNE_TABLE.json``, the
reference's field names).  Winners persist only in a root the caller
names (``--cache-dir``, else ``$REPRO_CACHE_DIR``); with neither, the
suite sweeps in a temporary root and leaves no record behind, since a
record in the default root changes the tiles of every later run in that
home (``--assert-warm`` then refuses to run: there is nothing to be warm
from).

``--suite family`` (default) tunes ``perf_report.FAMILY_SUITE``, the
reference's cells (``--smoke``: their smoke candidates in the port's
tiles); ``--suite card`` tunes ``CARD_SUITE``, the serving paths' shapes.

    PYTHONPATH=src python -m repro_torch.bench.bench_autotune --smoke \\
        --cache-dir .tune --json BENCH_autotune.json
    PYTHONPATH=src python -m repro_torch.bench.bench_autotune --smoke \\
        --cache-dir .tune --assert-warm --dump TUNE_TABLE.json
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

from repro_torch.bench.common import card_line, setup_device, tune_session


def _suite(name: str):
    from repro_torch.core import perf_report
    return {"family": perf_report.FAMILY_SUITE,
            "card": perf_report.CARD_SUITE}[name]


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter."""
    from repro_torch.kernels import (flash_attention, jacobi7, paged_decode,
                                     sampling, ssd_scan, stream_triad)
    return {"flash_attention": flash_attention.flash_attention_bhsd.launches,
            "paged_decode":
                paged_decode.paged_decode_attention_grouped.launches,
            "paged_decode_q8":
                paged_decode.paged_decode_attention_q8_grouped.launches,
            "argmax": sampling.block_argmax.launches,
            "ssd_scan": ssd_scan.ssd_scan.launches,
            "stream_triad": stream_triad.stream_triad.launches,
            "jacobi7": jacobi7.jacobi7_sweeps.launches}


def run(csv: list, session=None, smoke: bool = False, device="cuda",
        suite: str = "family") -> Dict:
    """Autotune every cell of the suite (``cli.run_tune_suite``); the
    summary counts sweeps, timed probes and kernel launches.  Without a
    ``session`` (the runner's call), one from :func:`tune_session`."""
    from repro_torch.kernels import registry
    from repro_torch.launch.cli import run_tune_suite

    if session is None:
        with tune_session() as session:
            return run(csv, session, smoke, device, suite)
    print("== registry autotune: every tunable family through one session ==")
    before = launch_counts()
    t0 = time.perf_counter()
    cells = run_tune_suite(session, smoke=smoke, suite=_suite(suite),
                           backend=str(device).split(":")[0],
                           verbose=False)
    secs = time.perf_counter() - t0
    after = launch_counts()
    summary: Dict = {"suite": suite, "families": cells,
                     "sweeps": sum(int(r["swept"]) for r in cells.values()),
                     "lowerings": session.lowerings,
                     "event_timed": session.event_timed,
                     "seconds": secs,
                     "launches": {k: after[k] - before[k] for k in after}}
    for cell, r in cells.items():
        src = "swept" if r["swept"] else "tune table (disk)"
        print(f"{cell:>15}: choice={tuple(r['choice'])}  "
              f"score {r['score_us']:9.3f} us  [{src}, "
              f"{r['lowerings']} timed probes]")
        csv.append((f"autotune_{cell}", r["score_us"],
                    f"choice={'x'.join(str(c) for c in r['choice'])},"
                    f"swept={int(r['swept'])},lowerings={r['lowerings']}"))
    print(f"total: {summary['sweeps']} sweeps, "
          f"{summary['lowerings']} timed probes in {secs:.2f} s "
          f"({session.stats()})")
    summary["table"] = registry.dump_tune_table()
    return summary


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced candidate sets (the family suite)")
    ap.add_argument("--suite", default="family", choices=["family", "card"],
                    help="the reference's cells (family) or the serving "
                         "paths' shapes (card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the summary here (BENCH_autotune.json)")
    ap.add_argument("--assert-warm", action="store_true",
                    help="fail unless EVERY family resolved from the "
                         "persisted tune table: zero sweeps, zero timed "
                         "probes (the fresh-process warm-start bar)")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persist the winners in this cache root (default "
                         "$REPRO_CACHE_DIR; with neither, a temporary root "
                         "that is removed at exit)")
    ap.add_argument("--dump", default=None, metavar="PATH",
                    help="write the resolved tune-table dump here "
                         "(TUNE_TABLE.json)")
    args = ap.parse_args(argv)
    if args.assert_warm and not (args.cache_dir
                                 or os.environ.get("REPRO_CACHE_DIR")):
        ap.error("--assert-warm needs the root of the cold run: "
                 "--cache-dir DIR or $REPRO_CACHE_DIR")
    device = setup_device(args.device)
    print(f"[bench_autotune] device {device}: {card_line(device)}")
    csv: list = []
    with tune_session(args.cache_dir) as session:
        summary = run(csv, session=session, smoke=args.smoke,
                      device=device, suite=args.suite)
    print("name,us_per_call,derived")
    for name, us, derived in csv:
        print(f"{name},{us:.2f},{derived}")
    if args.dump:
        with open(args.dump, "w") as f:
            json.dump(summary["table"], f, indent=1)
        print(f"[bench_autotune] wrote tune table dump to {args.dump}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"smoke": args.smoke, **summary}, f, indent=1)
        print(f"[bench_autotune] wrote {args.json}")
    if args.assert_warm:
        if summary["sweeps"] or session.lowerings:
            print(f"[bench_autotune] FAIL: warm restart swept "
                  f"{summary['sweeps']} families and timed "
                  f"{session.lowerings} probes — the persisted tune table "
                  f"should have served everything")
            return 1
        print("[bench_autotune] warm restart: 0 sweeps, 0 timed probes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
