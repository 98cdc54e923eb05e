"""Paper §II-A listing: likwid-perfctr marker mode on two named regions.

Counterpart of ``benchmarks/bench_perfctr.py``: an ``Init`` region and a
``Benchmark`` region, raw events then derived metrics of the FLOPS_BF16
group each, with the benchmark region measured twice and accumulated
(2 calls).  The reference reads its events from XLA's artifact; the port's
plain PyTorch regions declare theirs (:func:`repro_torch.core.events.
record_ops`): ``Init`` one multiply-add a element, ``Benchmark``
``tanh(x @ x) @ x``'s two n x n x n products (4 n^3 FLOPs), each fp32
input read once and its output written once.  Then the benchmark region
is timed on its own.  n = 512 fp32 (128 with ``--smoke``).

    python -m repro_torch.bench.bench_perfctr [--smoke] [--device cpu]
        [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from repro_torch.bench.common import card_line, claim, setup_device, sync
from repro_torch.core import events
from repro_torch.core.perfctr import PerfCtr


def run(csv: list, smoke: bool = False, device="cuda") -> Dict:
    device = torch.device(device)
    n = 128 if smoke else 512
    reps = 3 if smoke else 20
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(n, n, generator=gen, device=device)
    nbytes = a.numel() * a.element_size()

    def init_region(x):
        out = x * 0.0 + 1.0             # the paper's Init: almost no flops
        events.record_ops(flops=2 * x.numel(), arg_bytes=nbytes,
                          out_bytes=nbytes)
        return out

    def benchmark_region(x):
        out = torch.tanh(x @ x) @ x     # the paper's Benchmark: dense flops
        events.record_ops(flops=4 * n ** 3, arg_bytes=nbytes,
                          out_bytes=nbytes)
        return out

    ctr = PerfCtr(groups=("FLOPS_BF16",), device=device)
    with ctr.marker("Init"):
        ctr.probe(init_region, a, repeats=1)
    with ctr.marker("Benchmark"):
        ctr.probe(benchmark_region, a, repeats=1)
        ctr.probe(benchmark_region, a, repeats=1)  # accumulation

    print(ctr.report())

    benchmark_region(a)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        benchmark_region(a)
    sync(device)
    us = (time.perf_counter() - t0) / reps * 1e6
    print(f"Benchmark region alone: {us:.1f} us/call on {card_line(device)}")

    bench = ctr.regions["Benchmark"]
    flops = bench.events["FLOPS_TOTAL"]
    csv.append(("perfctr_marker_benchmark_region", us,
                f"flops_accumulated={flops:.3g};calls={bench.calls}"))
    claim(bench.calls == 2, f"Benchmark accumulated {bench.calls} calls, "
                            f"not 2")
    claim(flops >= 2 * (2 * n ** 3) * 2 * 0.9,
          f"Benchmark declared {flops:.3g} FLOPs for 2 calls of 2 products")
    return {"n": n, "us_per_call": us, "init_calls": ctr.regions["Init"].calls,
            "benchmark_calls": bench.calls, "benchmark_flops": flops,
            "benchmark_time_s": bench.time_s}


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
