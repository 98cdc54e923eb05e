"""Paper Figs. 4-10 on one GPU: STREAM triad wall clock through perfctr.

Counterpart of ``benchmarks/bench_stream_pinning.py``'s wall-clock part:
the port's triad kernel (``csrc/stream_triad.cu``) at N = 2^27 fp32 —
512 MiB per array, 1.5 GiB in all, over 4x the 50 MB L2 as the STREAM
rule asks — 100 samples inside a ``PerfCtr`` marker region, each timed
between CUDA events; quartiles printed like the paper's box plots, and the
median's bandwidth against the data-sheet HBM peak.

The reference's other half, placement quality (ring hop costs of pin
strategies over the topology model), needs the ``pin`` and ``topology``
tools, which wait for the next tool-layer slice.

Run on the card: ``python -m repro_torch.bench.bench_stream_pinning``
(``--smoke`` for N = 2^20 and 10 samples, ``--device cpu`` for the plain
version on the host, ``--json PATH`` to keep the numbers).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core.perfctr import PerfCtr
from repro_torch.kernels.stream_triad import stream_triad, triad_bytes


def run(ctr: PerfCtr, *, n: int = 1 << 27, samples: int = 100,
        warmup: int = 1) -> dict:
    """Time ``samples`` fp32 triads of length ``n`` into a marker region
    of ``ctr``; returns the quartiles and bandwidths."""
    gen = torch.Generator(device=ctr.device).manual_seed(0)
    b = torch.randn(n, generator=gen, device=ctr.device)
    c = torch.randn(n, generator=gen, device=ctr.device)
    region = f"triad N={n} fp32"
    with ctr.marker(region):
        m = ctr.probe(stream_triad, b, c, warmup=warmup, repeats=samples)
    q1, med, q3 = (float(v) for v in np.percentile(m.wall_times,
                                                    [25, 50, 75]))
    nbytes = triad_bytes(n, b.element_size())
    return {"region": region, "n": n, "dtype": "float32",
            "samples": samples, "q1_s": q1, "median_s": med, "q3_s": q3,
            "best_s": min(m.wall_times), "bytes": nbytes,
            "gbps_median": nbytes / med / 1e9,
            "gbps_best": nbytes / min(m.wall_times) / 1e9,
            "hbm_peak_gbps": ctr.chip.hbm_bw / 1e9,
            "launches": m.events["LAUNCHES"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    ctr = PerfCtr(groups=("HBM", "ROOFLINE"), device=args.device)
    res = run(ctr, n=1 << 20 if args.smoke else 1 << 27,
              samples=10 if args.smoke else 100)
    print(f"== STREAM triad on {ctr.chip.name} ({ctr.device}), "
          f"{res['samples']} samples, N={res['n']} fp32 ==")
    print(f"kernel triad: median {res['median_s'] * 1e6:.1f} us  "
          f"[q1 {res['q1_s'] * 1e6:.1f}, q3 {res['q3_s'] * 1e6:.1f}]  -> "
          f"{res['gbps_median']:.1f} GB/s (best {res['gbps_best']:.1f}; "
          f"data-sheet HBM {res['hbm_peak_gbps']:.0f})")
    print(ctr.report())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
