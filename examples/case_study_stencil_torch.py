"""Paper case studies 2+3 (§IV-V) on one GPU: the Jacobi-7 stencil, its
placement in shared memory and counter-quantified temporal blocking.

The PyTorch port's counterpart of ``examples/case_study_stencil.py``:
runs the port's Jacobi-7 kernel (``csrc/jacobi7.cu``, naive sweeps vs one
temporally blocked wavefront), holds it to the plain valid-mode oracle,
then reproduces Table I with the port's perfctr: the declared traffic of
four naive sweeps against one four-sweep wavefront explains why the
wavefront wins, and its time says by how much.

    PYTHONPATH=src python examples/case_study_stencil_torch.py
        [--device cpu] [--shape X,Y,Z]

It runs on the card unless ``--device cpu`` asks for the host (the
kernel's plain version then runs, and the times are the host's).
"""

import argparse

import torch

from repro_torch.core import hwinfo
from repro_torch.core.perfctr import measure
from repro_torch.device import resolve_device
from repro_torch.kernels.jacobi7 import (SMEM_PER_BLOCK, TILE_YZ,
                                         jacobi7_naive, jacobi7_valid_plain,
                                         jacobi7_wavefront, lattice_updates,
                                         smem_footprint, traffic_model)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--shape", default="64,128,256",
                    help="the Table I lattice X,Y,Z (default 64,128,256)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    chip = hwinfo.current_chip(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- correctness first (kernel vs oracle) -----------------------------
    sweeps = 2
    x = torch.randn((32, 34, 130), generator=gen, device=dev)
    got = jacobi7_wavefront(x, sweeps=sweeps)
    torch.testing.assert_close(got, jacobi7_valid_plain(x, sweeps),
                               rtol=1e-4, atol=1e-5)
    print(f"wavefront kernel == {sweeps} oracle sweeps on {dev} "
          f"(allclose OK)")

    # -- case study 2: the 'wrong pinning' analogue -----------------------
    # the residency is a tile's ring of planes in shared memory; a tile
    # whose planes do not fit is refused, never shrunk
    for tile_yz in (TILE_YZ, (64, 128)):
        need = smem_footprint(4, (1,) + tuple(tile_yz))
        verdict = ("fits shared memory" if need <= SMEM_PER_BLOCK
                   else "REFUSED (the Fig-11 wrong placement)")
        print(f"y-z tile {tile_yz[0]}x{tile_yz[1]}, T=4: {need / 1024:7.1f} "
              f"KiB of the {SMEM_PER_BLOCK / 1024:.0f} a block may have -> "
              f"{verdict}")

    # -- case study 3: Table I with perfctr -------------------------------
    shape = tuple(int(s) for s in args.shape.split(","))
    big = torch.randn(shape, generator=gen, device=dev)

    def threaded(v):
        for _ in range(4):
            v = jacobi7_naive(v)
        return v

    m_nt = measure(threaded, big, region="threaded-NT", device=dev,
                   chip=chip, repeats=3)
    m_wf = measure(lambda v: jacobi7_wavefront(v, sweeps=4), big,
                   region="wavefront", device=dev, chip=chip, repeats=3)
    torch.testing.assert_close(jacobi7_wavefront(big, sweeps=4),
                               threaded(big), rtol=1e-4, atol=1e-5)
    nt = m_nt.events["BYTES_ACCESSED"] / m_nt.calls
    wf = m_wf.events["BYTES_ACCESSED"] / m_wf.calls
    model = traffic_model(shape, 4)
    lups = lattice_updates(shape, 4)
    print(f"\ntraffic for 4 sweeps of {shape} (declared by the kernel, "
          f"halos counted):")
    print(f"  threaded (NT): {nt / 1e9:8.4f} GB   {m_nt.mean_time * 1e3:8.3f} "
          f"ms  {lups / m_nt.mean_time / 1e6:9.1f} MLUPS")
    print(f"  wavefront:     {wf / 1e9:8.4f} GB   {m_wf.mean_time * 1e3:8.3f} "
          f"ms  {lups / m_wf.mean_time / 1e6:9.1f} MLUPS   saving "
          f"{nt / wf:.2f}x")
    print(f"  Table I model: threaded NT {model['threaded_nt'] / 1e9:.4f} "
          f"GB, wavefront {model['wavefront'] / 1e9:.4f} GB")
    print("paper Table I: 43.97 -> 16.57 GB (2.7x); MLUPS only 1032->1331,")
    print("the traffic saving outruns the time saving (paper §V).")
    print(f"(times: {chip.name} on {dev}"
          + (", the host's plain versions)" if dev.type == "cpu" else ")"))
    return {"device": str(dev), "shape": shape, "threaded_bytes": nt,
            "wavefront_bytes": wf, "threaded_s": m_nt.mean_time,
            "wavefront_s": m_wf.mean_time}


if __name__ == "__main__":
    main()
