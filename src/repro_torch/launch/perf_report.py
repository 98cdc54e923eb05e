"""Roofline perf report over run artifacts, with a baseline gate.

Port of ``repro/launch/perf_report.py`` over
:mod:`repro_torch.core.perf_report`.

    # on the card, no artifacts: autotune the canonical suite (a warm
    # cache sweeps nothing), measure the production path, print + write
    PYTHONPATH=src python -m repro_torch.launch.perf_report \\
        --json PERF_REPORT.json

    # ingest a run's BENCH_*.json / TUNE_TABLE.json (either package's)
    # and gate against the port's baseline (first run: warn, exit 0)
    PYTHONPATH=src python -m repro_torch.launch.perf_report --artifacts . \\
        --json PERF_REPORT.json --md PERF_REPORT.md --gate

    # write the port's baseline after an intentional perf change
    PYTHONPATH=src python -m repro_torch.launch.perf_report --update-baseline

    # re-gate a previously written report (no device, pure compare)
    PYTHONPATH=src python -m repro_torch.launch.perf_report \\
        --check PERF_REPORT.json --baseline PERF_BASELINE_TORCH.json --gate

    # on the host: the plain versions, scored by the declared roofline
    PYTHONPATH=src python -m repro_torch.launch.perf_report --device cpu

Exit status: 0 ok (including "no baseline yet": the first run is
non-blocking), 2 when ``--gate`` and a family regressed beyond
``--threshold`` (after one re-measure) or a tune winner flipped without a
toolchain-fingerprint change.  See :mod:`repro_torch.core.perf_report`
for the report and gate rules.

**One departure from the reference.**  Its ``--baseline`` defaults to
the committed ``PERF_BASELINE.json``, a report of TPU ceilings on CPU
cells (its ``chip.name`` says so).  Here ``--baseline`` defaults to
``PERF_BASELINE_TORCH.json``, a file of the port's own that the
repository does not commit; a baseline whose ``chip.name`` differs from
the report's is printed as not comparable and never gated, and
``--update-baseline`` refuses to overwrite one.  ``--device`` defaults
to ``cuda`` (``--device cpu`` runs the plain versions on the host).
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.core import perf_report as pr
from repro_torch.launch import cli

#: the port's own baseline (not committed; the repository's
#: ``PERF_BASELINE.json`` is the JAX package's, on TPU ceilings)
DEFAULT_BASELINE = "PERF_BASELINE_TORCH.json"


def _write(path, doc):
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
    print(f"wrote {path}")


def _chip_name(doc) -> str:
    return (doc.get("chip") or {}).get("name", "?")


def _build(args, arts):
    """Tune (or pin the artifacts' records), measure and build the
    report: ``(report, records, walls, device)``."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import registry
    dev = resolve_device(args.device)
    records = pr.tune_records(arts)
    session = cli.session_from_args(args)
    with cli.impl_context(args):
        if records:
            n = pr.seed_tune_table(records)
            print(f"pinned {n} tune records from artifacts")
        if args.tune or not records:
            cli.run_tune_suite(session, smoke=True, backend=dev.type)
            records = registry.dump_tune_table()["records"]
        walls = (None if args.no_measure
                 else pr.measure_walls(records, device=dev))
    report = pr.build_report(records, walls=walls,
                             benches=pr.summarize_benches(arts))
    return report, records, walls, dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifacts", default=".", metavar="DIR",
                    help="directory holding BENCH_*.json / TUNE_TABLE.json "
                         "(default: cwd; absent artifacts just mean the "
                         "suite is tuned+measured live)")
    ap.add_argument("--check", default=None, metavar="REPORT.json",
                    help="gate a previously written report instead of "
                         "building one (pure compare, no measurement)")
    ap.add_argument("--md", default=None, metavar="PATH",
                    help="write the markdown report here")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    metavar="PATH",
                    help="baseline report to gate against (default "
                         "%(default)s, the port's own; a baseline of "
                         "another chip is not comparable and never gated)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write the fresh report to --baseline (refused "
                         "over a baseline of another chip)")
    ap.add_argument("--gate", action="store_true",
                    help="exit 2 on regression vs baseline (winner flips "
                         "are exempt when the toolchain fingerprint "
                         "changed; missing baseline warns, exits 0)")
    ap.add_argument("--threshold", type=float, default=pr.DEFAULT_THRESHOLD,
                    help="allowed relative drop in achieved roofline "
                         "fraction (default %(default)s)")
    ap.add_argument("--wall-floor", type=float, default=pr.WALL_FLOOR_S,
                    metavar="SECONDS",
                    help="fraction regressions on rows whose wall is "
                         "under this are noise notes, not failures "
                         "(default %(default)s; 0 gates everything)")
    ap.add_argument("--no-measure", action="store_true",
                    help="skip wall-clock measurement (report renders "
                         "rooflines only, no achieved fractions)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu "
                         "(the plain versions, scored by the declared "
                         "roofline)")
    cli.add_impl_args(ap)
    cli.add_cache_args(ap)
    cli.add_json_args(ap, what="report (PERF_REPORT.json)")
    args = ap.parse_args(argv)

    arts, records, walls, dev = {}, [], None, None
    if args.check:
        with open(args.check) as fh:
            report = json.load(fh)
    else:
        arts = pr.load_artifacts(args.artifacts)
        if arts:
            print(f"artifacts: {', '.join(sorted(arts))}")
        report, records, walls, dev = _build(args, arts)
        print(pr.render_table(report))

    baseline = None
    if os.path.exists(args.baseline):
        with open(args.baseline) as fh:
            baseline = json.load(fh)
        if _chip_name(baseline) != _chip_name(report):
            print(f"[gate] baseline {args.baseline} holds chip "
                  f"{_chip_name(baseline)!r}, this report "
                  f"{_chip_name(report)!r}: not comparable, not gated")
            if args.update_baseline:
                ap.error(f"--update-baseline would overwrite "
                         f"{args.baseline}, a baseline of chip "
                         f"{_chip_name(baseline)!r}: name another path")
            baseline = None

    failures, notes, compared = [], [], False
    if baseline is not None:
        failures, notes = pr.compare(report, baseline,
                                     threshold=args.threshold,
                                     wall_floor_s=args.wall_floor)
        compared = True
        # Wall-clock noise on the microsecond smoke cells can transiently
        # depress achieved fractions; a fraction regression gets ONE
        # re-measure (keeping each family's best wall) before it counts.
        # Real regressions persist across the retry; winner flips are
        # deterministic and never retried.
        if (failures and not args.check and not args.no_measure
                and any("fraction regressed" in f for f in failures)):
            print("[gate] fraction regression — re-measuring once to "
                  "rule out wall-clock noise")
            with cli.impl_context(args):
                rewalls = pr.measure_walls(records, device=dev)
            for fam, w in rewalls.items():
                old = walls.get(fam) if walls else None
                if old is None or w["wall_s"] < old["wall_s"]:
                    walls[fam] = w
            report = pr.build_report(records, walls=walls,
                                     benches=pr.summarize_benches(arts))
            failures, notes = pr.compare(report, baseline,
                                         threshold=args.threshold,
                                         wall_floor_s=args.wall_floor)
        for n in notes:
            print(f"[gate] note: {n}")
        for f in failures:
            print(f"[gate] FAIL: {f}")
        if not failures:
            print(f"[gate] ok: no regressions vs {args.baseline}")
    elif not os.path.exists(args.baseline) and (args.gate
                                                or args.update_baseline):
        print(f"[gate] no baseline at {args.baseline} — skipping gate "
              f"(first run is non-blocking; --update-baseline writes one)")

    if args.json:
        _write(args.json, report)
    if args.md:
        with open(args.md, "w") as fh:
            fh.write(pr.render_markdown(
                report, failures if compared else None,
                notes if compared else None))
        print(f"wrote {args.md}")
    if args.update_baseline:
        _write(args.baseline, report)

    if args.gate and failures:
        print(f"[gate] {len(failures)} failure(s) — exiting non-zero")
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
