"""Paper Fig. 11 on one GPU: the wavefront stencil placed wrong.

Counterpart of ``benchmarks/bench_stencil_pinning.py``.  The paper's
wavefront code needs its thread group to share an L3; on the TPU its slab
must fit VMEM; on the card each CTA streams its column's input box plane
by plane along x (2.5D blocking), and its planes — a ring of input
planes and three rolling planes for each intermediate sweep, each the
column's y-z tile with a halo of T a side — must fit the 227 KiB of
shared memory a block may have.  A y-z tile whose planes do not fit is
the "wrong placement": the wrapper refuses it (it would have to spill to
HBM every sweep).  The x extent a column streams costs no shared memory;
it sets how often the 2T halo planes along x are paid.

At 512^3 fp32 and T = 4 (``--sweeps``; 1 is the naive sweep) this
prints, for several tiles ``(bx, by, bz)``,
the ``smem_footprint`` verdict, the bytes the kernel declares (halos
counted), and the time and MLUPS of each tile that fits, measured in a
``PerfCtr`` marker region.  It checks that the wrapper refuses every tile
the footprint rejects ((8, 64, 128) is one).

Run on the card: ``python -m repro_torch.bench.bench_stencil_pinning``
(``--smoke`` for 64^3, ``--device cpu`` for the plain version).
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from repro_torch.core.perfctr import PerfCtr
from repro_torch.kernels.jacobi7 import (MAX_THREADS, SMEM_PER_BLOCK,
                                         block_threads, jacobi7_wavefront,
                                         kernel_bytes, lattice_updates,
                                         smem_footprint)

TILES = ((64, 16, 64), (64, 32, 64), (128, 16, 64), (32, 16, 64),
         (256, 16, 64), (64, 8, 128), (64, 16, 128), (128, 32, 64),
         (8, 16, 64), (8, 64, 128))


def run(ctr: PerfCtr, *, shape=(512, 512, 512), sweeps: int = 4,
        repeats: int = 5, warmup: int = 1) -> dict:
    gen = torch.Generator(device=ctr.device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=ctr.device)
    updates = lattice_updates(shape, sweeps)
    rows = []
    for tile in TILES:
        need = smem_footprint(sweeps, tile)
        row = {"tile": list(tile), "smem_bytes": need,
               "threads": block_threads(sweeps, tile),
               "fits": (need <= SMEM_PER_BLOCK
                        and block_threads(sweeps, tile) <= MAX_THREADS),
               "declared_bytes": kernel_bytes(shape, sweeps, tile)}
        if row["fits"]:
            with ctr.marker(f"wavefront T={sweeps} tile {tile}"):
                m = ctr.probe(jacobi7_wavefront, x, sweeps=sweeps, tile=tile,
                              warmup=warmup, repeats=repeats)
            t = statistics.median(m.wall_times)
            row.update(median_s=t, mlups=updates / t / 1e6)
        else:
            try:
                jacobi7_wavefront(x, sweeps=sweeps, tile=tile)
            except ValueError as e:
                row["refused"] = str(e)
            else:
                raise AssertionError(f"tile {tile} does not fit a block and "
                                     f"was not refused")
        rows.append(row)
    return {"shape": list(shape), "sweeps": sweeps, "rows": rows}


def render(res: dict) -> str:
    out = [f"== wavefront stencil: tile vs shared memory "
           f"({SMEM_PER_BLOCK} B, {MAX_THREADS} threads per block), grid "
           f"{tuple(res['shape'])}, T={res['sweeps']} ==",
           f"{'tile':<14} {'smem KiB':>9} {'threads':>8} {'fits':>5} "
           f"{'declared GB':>12} {'ms':>9} {'MLUPS':>8}"]
    for r in res["rows"]:
        t = "x".join(map(str, r["tile"]))
        tail = (f"{r['median_s'] * 1e3:>9.4f} {r['mlups']:>8.0f}"
                if r["fits"] else f"{'refused (wrong placement)':>18}")
        out.append(f"{t:<14} {r['smem_bytes'] / 1024:>9.1f} "
                   f"{r['threads']:>8} {str(r['fits']):>5} "
                   f"{r['declared_bytes'] / 1e9:>12.3f} {tail}")
    return "\n".join(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sweeps", type=int, default=4,
                    help="sweeps a launch (1: the naive sweep)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    ctr = PerfCtr(groups=("HBM", "ROOFLINE"), device=args.device)
    res = run(ctr, shape=(64, 64, 64) if args.smoke else (512, 512, 512),
              sweeps=args.sweeps, repeats=2 if args.smoke else 5)
    print(render(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
