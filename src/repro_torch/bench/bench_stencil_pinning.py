"""Paper Fig. 11 on one GPU: the wavefront stencil placed wrong.

Counterpart of ``benchmarks/bench_stencil_pinning.py``.  The paper's
wavefront code needs its thread group to share an L3; on the TPU its slab
must fit VMEM; on the card one CTA's output tile plus its halo of T per
side, in two buffers, must fit the 227 KiB of shared memory a block may
have.  A tile that does not fit is the "wrong placement": the wrapper
refuses it (it would have to spill to HBM every sweep).

At 512^3 fp32 and T = 4 this prints, for several tiles, the
``smem_footprint`` verdict, the bytes the kernel declares (halos
counted), and the time and MLUPS of each tile that fits, measured in a
``PerfCtr`` marker region.  It checks that the wrapper refuses every tile
the footprint rejects.

Run on the card: ``python -m repro_torch.bench.bench_stencil_pinning``
(``--smoke`` for 64^3, ``--device cpu`` for the plain version).
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from repro_torch.core.perfctr import PerfCtr
from repro_torch.kernels.jacobi7 import (SMEM_PER_BLOCK, jacobi7_wavefront,
                                         kernel_bytes, lattice_updates,
                                         smem_footprint)

TILES = ((8, 16, 64), (4, 16, 64), (8, 8, 128), (4, 32, 64), (8, 32, 64),
         (16, 16, 64))


def run(ctr: PerfCtr, *, shape=(512, 512, 512), sweeps: int = 4,
        repeats: int = 5, warmup: int = 1) -> dict:
    gen = torch.Generator(device=ctr.device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=ctr.device)
    updates = lattice_updates(shape, sweeps)
    rows = []
    for tile in TILES:
        need = smem_footprint(sweeps, tile)
        row = {"tile": list(tile), "smem_bytes": need,
               "fits": need <= SMEM_PER_BLOCK,
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
                raise AssertionError(f"tile {tile} needs {need} B of shared "
                                     f"memory and was not refused")
        rows.append(row)
    return {"shape": list(shape), "sweeps": sweeps, "rows": rows}


def render(res: dict) -> str:
    out = [f"== wavefront stencil: tile vs shared memory "
           f"({SMEM_PER_BLOCK} B per block), grid {tuple(res['shape'])}, "
           f"T={res['sweeps']} ==",
           f"{'tile':<14} {'smem KiB':>9} {'fits':>5} {'declared GB':>12} "
           f"{'ms':>9} {'MLUPS':>8}"]
    for r in res["rows"]:
        t = "x".join(map(str, r["tile"]))
        tail = (f"{r['median_s'] * 1e3:>9.4f} {r['mlups']:>8.0f}"
                if r["fits"] else f"{'refused (wrong placement)':>18}")
        out.append(f"{t:<14} {r['smem_bytes'] / 1024:>9.1f} "
                   f"{str(r['fits']):>5} {r['declared_bytes'] / 1e9:>12.3f} "
                   f"{tail}")
    return "\n".join(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    ctr = PerfCtr(groups=("HBM", "ROOFLINE"), device=args.device)
    res = run(ctr, shape=(64, 64, 64) if args.smoke else (512, 512, 512),
              repeats=2 if args.smoke else 5)
    print(render(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
