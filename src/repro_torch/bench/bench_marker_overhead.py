"""Paper's zero-overhead claim: 'there is no interference of likwid-perfCtr
while the measured code is being executed'.

Counterpart of ``benchmarks/bench_marker_overhead.py``.  The JAX tool
reads its events from the compiled artifact, so its claim holds by
construction.  The port's events are declared by the code that runs
(:mod:`repro_torch.core.events`), so measuring adds host work: a marker
region, an open event collection timed by CUDA events, and what each
declaring call does inside it.  Two cases, each timed bare and inside an
open ``PerfCtr.marker`` with the region's event collection open
(``region_timer``), in the order bare, measured, measured, bare, three
rounds of it, the card synchronized around each loop; the overhead is the
medians' (a call of the reference's case is tens of microseconds of host
time, so one slow loop on a shared host is not the marker's cost):

1. **The reference's case**: ``tanh(x @ x)`` at n = 384 fp32, 50 calls a
   loop (n = 128 and 5 with ``--smoke``).  Plain PyTorch declares
   nothing, so this is the cost of the marker and the collection; the
   reference's bound holds (|overhead| < 25%, < 100% with ``--smoke``) or
   the bench raises.
2. **A kernel that declares events**: one paged decode call
   (``registry.run("paged_decode", ...)``: kernel #2 on the card) at
   ``bench_paged_decode``'s long mix (4 rows of 512, 503, 495, 479 past
   tokens at max_seq 1024, pages of 16, its model's 2 KV heads of 32 and
   G = 2).  Inside the collection every launch queues a copy of
   ``lengths`` to pinned host memory (``events.record_launch_from``).
   Printed and recorded, not asserted: the reference makes no claim
   about it.

The reference's third part, a measurement of inputs that cannot run, has
no counterpart: the port's probe executes what it measures.

    python -m repro_torch.bench.bench_marker_overhead [--smoke]
        [--device cpu] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.bench.bench_paged_decode import PS, bench_config, mixes
from repro_torch.bench.common import card_line, claim, setup_device, sync
from repro_torch.core.perfctr import PerfCtr
from repro_torch.kernels import registry


def _time(fn: Callable, reps: int, device: torch.device) -> float:
    """Seconds a call over ``reps`` calls, synchronized around the loop."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps


def overhead(fn: Callable, reps: int, ctr: PerfCtr, region: str,
             rounds: int = 3) -> Dict:
    """Bare against measured seconds a call (bare, measured, measured,
    bare, ``rounds`` times) and the relative overhead of the medians."""
    def measured() -> float:
        with ctr.marker(region), ctr.region_timer(region):
            return _time(fn, reps, ctr.device)

    bare, meas = [], []
    for _ in range(rounds):
        bare.append(_time(fn, reps, ctr.device))
        meas += [measured(), measured()]
        bare.append(_time(fn, reps, ctr.device))
    t_bare, t_meas = float(np.median(bare)), float(np.median(meas))
    return {"bare_us": t_bare * 1e6, "measured_us": t_meas * 1e6,
            "bare_runs_us": [t * 1e6 for t in bare],
            "measured_runs_us": [t * 1e6 for t in meas],
            "overhead": (t_meas - t_bare) / t_bare, "reps": reps}


def paged_inputs(device: torch.device, max_seq: int = 1024, seed: int = 0):
    """One paged decode call at ``bench_paged_decode``'s long mix."""
    cfg = bench_config()
    kvh, dh = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // kvh
    lens = mixes(max_seq)["long_ctx"]
    pages = [-(-n // PS) for n in lens]
    width = max(pages)
    rng = np.random.default_rng(seed)
    table = np.zeros((len(lens), width), np.int32)
    nxt = 1                                       # page 0 is the null page
    for r, n in enumerate(pages):
        table[r, :n] = np.arange(nxt, nxt + n)
        nxt += n

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    b = len(lens)
    return (t(b, kvh, g, dh), t(nxt, PS, kvh, dh), t(nxt, PS, kvh, dh),
            torch.from_numpy(table).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device),
            t(b, kvh, dh), t(b, kvh, dh))


def run(csv: list, smoke: bool = False, device="cuda") -> Dict:
    device = torch.device(device)
    n = 128 if smoke else 384
    reps = 5 if smoke else 50
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(n, n, generator=gen, device=device)
    ctr = PerfCtr(device=device)
    mm = overhead(lambda: torch.tanh(a @ a), reps, ctr, "hot")
    args = paged_inputs(device, 512 if smoke else 1024)
    paged = overhead(lambda: registry.run("paged_decode", *args), reps, ctr,
                     "paged")
    print(f"== marker overhead on {card_line(device)} ==")
    for name, r in (("tanh(x @ x), n=" + str(n), mm),
                    ("paged decode, long mix", paged)):
        print(f"{name:<24} bare {r['bare_us']:9.1f} us/call  measured "
              f"{r['measured_us']:9.1f} us/call  (overhead "
              f"{r['overhead'] * 100:+.1f}%)")
    launches = ctr.regions["paged"].events["LAUNCHES"]
    print(f"paged region: {launches:.0f} declared launches over "
          f"{ctr.regions['paged'].calls} timed loops")
    csv.append(("marker_overhead_pct", mm["bare_us"],
                f"overhead_pct={mm['overhead'] * 100:.2f}"))
    csv.append(("marker_overhead_paged_pct", paged["bare_us"],
                f"overhead_pct={paged['overhead'] * 100:.2f}"))
    # noise-level, not systematic (smoke reps are too few to bound tightly)
    bound = 1.0 if smoke else 0.25
    claim(abs(mm["overhead"]) < bound,
          f"marker overhead {mm['overhead'] * 100:+.1f}% on tanh(x @ x) is "
          f"over the {bound * 100:.0f}% bound")
    return {"matmul": dict(mm, n=n, bound=bound),
            "paged_decode": dict(paged, region_launches=launches)}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = setup_device(args.device)
    csv: list = []
    res = run(csv, smoke=args.smoke, device=device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card_line(device), **res}, f, indent=2)
    return res


if __name__ == "__main__":
    main()
