"""Paper Table I on one GPU: memory traffic and MLUPS of naive against
wavefront Jacobi, measured with perfctr.

Counterpart of ``benchmarks/bench_jacobi_traffic.py``.  At 512^3 fp32 and
T = 4 time steps:

* **naive** (Table I "threaded (NT)"): 4 launches of the one-sweep kernel,
  each a full HBM round trip;
* **wavefront**: 1 launch running the 4 sweeps in shared memory per tile.

Each runs inside a ``PerfCtr`` marker region (HBM and ROOFLINE groups);
the table shows the traffic the reference's ``traffic_model`` gives, the
bytes the kernel declares (halos re-read by neighbouring tiles counted),
the time per T steps (CUDA events) and MLUPS (lattice updates over T
valid sweeps per microsecond).  The x86 write-allocate variant has no GPU
counterpart (a full-sector store reads nothing) and stays a model row.

Paper's numbers for reference: 75.39 / 43.97 / 16.57 GB (1 : 0.58 : 0.22)
at MLUPS 784 / 1032 / 1331.

Run on the card: ``python -m repro_torch.bench.bench_jacobi_traffic``
(``--smoke`` for 64^3 and T = 2, ``--device cpu`` for the plain versions).
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from repro_torch.core.perfctr import PerfCtr
from repro_torch.kernels.jacobi7 import (jacobi7_naive, jacobi7_wavefront,
                                         lattice_updates, traffic_model)


def _naive_steps(x: torch.Tensor, sweeps: int) -> torch.Tensor:
    for _ in range(sweeps):
        x = jacobi7_naive(x)
    return x


def run(ctr: PerfCtr, *, shape=(512, 512, 512), sweeps: int = 4,
        repeats: int = 10, warmup: int = 1) -> dict:
    """Measure both variants into marker regions of ``ctr``; returns one
    row per variant."""
    gen = torch.Generator(device=ctr.device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=ctr.device)
    model = traffic_model(shape, sweeps)
    updates = lattice_updates(shape, sweeps)
    rows = {}
    for name, fn, model_key in (
            (f"naive x{sweeps} (T=1)", lambda: _naive_steps(x, sweeps),
             "threaded_nt"),
            (f"wavefront (T={sweeps})",
             lambda: jacobi7_wavefront(x, sweeps=sweeps), "wavefront")):
        with ctr.marker(name):
            m = ctr.probe(fn, warmup=warmup, repeats=repeats)
        t = statistics.median(m.wall_times)
        rows[name] = {"model_bytes": model[model_key],
                      "declared_bytes": m.events["BYTES_ACCESSED"] / m.calls,
                      "launches_per_call": m.events["LAUNCHES"] / m.calls,
                      "median_s": t, "mlups": updates / t / 1e6,
                      "gbps": m.events["BYTES_ACCESSED"] / m.calls / t / 1e9}
    return {"shape": list(shape), "sweeps": sweeps,
            "threaded_wa_model_bytes": model["threaded"], "rows": rows}


def render(res: dict) -> str:
    rows = res["rows"]
    base = res["threaded_wa_model_bytes"]
    out = [f"== Table I analogue: Jacobi, {res['sweeps']} sweeps, grid "
           f"{tuple(res['shape'])} fp32 ==",
           f"{'variant':<18} {'model GB':>9} {'declared GB':>12} "
           f"{'launches':>9} {'ms':>9} {'MLUPS':>9} {'GB/s':>8}",
           f"{'threaded (WA)':<18} {base / 1e9:>9.3f} {'(x86 only)':>12}"]
    for name, r in rows.items():
        out.append(f"{name:<18} {r['model_bytes'] / 1e9:>9.3f} "
                   f"{r['declared_bytes'] / 1e9:>12.3f} "
                   f"{r['launches_per_call']:>9.0f} "
                   f"{r['median_s'] * 1e3:>9.4f} {r['mlups']:>9.0f} "
                   f"{r['gbps']:>8.1f}")
    out.append("paper:             75.39 / 43.97 / 16.57 GB "
               "(1 : 0.58 : 0.22), MLUPS 784 / 1032 / 1331")
    return "\n".join(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    ctr = PerfCtr(groups=("HBM", "ROOFLINE"), device=args.device)
    res = run(ctr, shape=(64, 64, 64) if args.smoke else (512, 512, 512),
              sweeps=2 if args.smoke else 4, repeats=3 if args.smoke else 10)
    print(render(res))
    print(ctr.report())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
