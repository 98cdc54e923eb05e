"""7-point 3D Jacobi stencil (paper case studies 2+3, §IV-V): the CUDA
kernel and its plain twins.

Port of ``repro/kernels/jacobi7.py``: the Pallas ``_wavefront_kernel``
becomes ``csrc/jacobi7.cu`` (its source note says what bounds it on an
H100 and how it is laid out).  Semantics are the reference's: valid-mode
sweeps, ``[X,Y,Z] -> [X-2T, Y-2T, Z-2T]``, each
``omega * (x-1 + x+1 + y-1 + y+1 + z-1 + z+1)`` summed in that order, fp32.

* :func:`jacobi7_naive`      — one sweep per call (T=1); T time steps cost
                               T full HBM round trips (Table I "threaded").
* :func:`jacobi7_wavefront`  — T sweeps per call in one shared-memory
                               residency per output tile (temporal blocking).

On the TPU the residency is an x-slab of whole Y-Z planes in VMEM; on the
card a CTA owns an output column of ``block_x`` points along x and a
32 x 64 tile in y-z, and streams its input box (a halo of T a side)
through shared memory plane by plane along x: a ring of input planes and
two planes for each intermediate sweep, one thread a 4-point chunk of a
plane (2.5D blocking).  :func:`smem_footprint` gives those planes' bytes
and :func:`block_threads` the threads, neither of which depends on
``block_x``; a y-z tile whose planes do not fit the 227 KiB a block may
have, or that needs more than 1024 threads, is refused with an error —
the stencil bench's Fig. 11 "wrong placement" verdict — never shrunk.
One launch fuses at most :data:`MAX_SWEEPS` sweeps.
:func:`traffic_model` is the reference's Table I model, copied unchanged;
:func:`kernel_bytes` is what this kernel moves, halos counted.

The wrappers dispatch on the tensor's device: CPU tensors run the plain
versions, CUDA tensors launch the kernel (or raise — there is no
fallback).  Each call declares its FLOPs and bytes to
:mod:`repro_torch.core.events`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import events
from repro_torch.kernels import _build

__all__ = ["jacobi7_naive", "jacobi7_wavefront", "jacobi7_sweeps",
           "jacobi7_sweep_plain",
           "jacobi7_valid_plain", "traffic_model", "smem_footprint",
           "kernel_bytes", "lattice_updates", "SMEM_PER_BLOCK", "TILE_YZ",
           "BLOCK_X", "RING_PLANES", "MAX_THREADS", "MAX_SWEEPS",
           "block_threads"]

#: dynamic shared memory one block may opt in to on sm_90 (227 KiB)
SMEM_PER_BLOCK = _build.SMEM_OPT_IN
#: the tile's y and z extents; ``block_x`` sets its x extent (chosen on
#: an H100 with ``bench_stencil_pinning`` at 512^3: the fastest at T = 4)
TILE_YZ = (32, 64)
#: the x extent a CTA streams by default (the reference's slab width is 8;
#: here it only sets how many planes a column walks)
BLOCK_X = 128
#: input planes in each CTA's cp.async ring (``csrc/jacobi7.cu::kRing``)
RING_PLANES = 6
#: threads a block may have: one a 4-point chunk of a plane
MAX_THREADS = 1024
#: sweeps one launch of the kernel fuses
MAX_SWEEPS = 8
_SIG = {"jacobi7_fwd": (_build.P, _build.P, _build.I, _build.I, _build.I,
                        _build.I, _build.F, _build.I, _build.I, _build.I,
                        _build.P)}

Tile = Tuple[int, int, int]


def jacobi7_sweep_plain(x: torch.Tensor, omega: float = 1.0 / 6.0
                        ) -> torch.Tensor:
    """One valid-mode sweep: [X,Y,Z] -> [X-2,Y-2,Z-2] (the reference's
    order of summation)."""
    return omega * (
        x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1] +
        x[1:-1, :-2, 1:-1] + x[1:-1, 2:, 1:-1] +
        x[1:-1, 1:-1, :-2] + x[1:-1, 1:-1, 2:]
    )


def jacobi7_valid_plain(x: torch.Tensor, sweeps: int = 1,
                        omega: float = 1.0 / 6.0) -> torch.Tensor:
    """T valid-mode sweeps (the wavefront kernel's contract)."""
    for _ in range(sweeps):
        x = jacobi7_sweep_plain(x, omega)
    return x


def _pitch(sweeps: int, bz: int) -> int:
    """A plane's row pitch: the box's z extent rounded up to 4 elements."""
    return -(-(bz + 2 * sweeps) // 4) * 4


def smem_footprint(sweeps: int, tile: Tile, dtype_bytes: int = 4) -> int:
    """Shared-memory bytes one CTA needs (``csrc/jacobi7.cu::smem_bytes``):
    :data:`RING_PLANES` input planes and two planes for each of sweeps
    1..T-1, every plane the y-z box ``(by+2T) x (bz+2T)`` with its rows
    padded to a multiple of 4 elements.  The x extent ``bx`` streams
    through and costs nothing."""
    _, by, bz = tile
    t = sweeps
    plane = (by + 2 * t) * _pitch(t, bz)
    return (RING_PLANES + 2 * (t - 1)) * plane * dtype_bytes


def block_threads(sweeps: int, tile: Tile) -> int:
    """Threads one CTA needs: one a 4-point chunk of a padded plane."""
    _, by, bz = tile
    return (by + 2 * sweeps) * _pitch(sweeps, bz) // 4


def _out_shape(shape, sweeps: int) -> Tuple[int, int, int]:
    return tuple(int(s) - 2 * sweeps for s in shape)


def kernel_bytes(shape, sweeps: int, tile: Tile,
                 dtype_bytes: int = 4) -> int:
    """HBM bytes one call moves: every CTA reads its box — its column's
    output extent plus a halo of T per side — exactly once (halos re-read
    by neighbouring columns count again), and the output is written once.
    Columns are a Cartesian grid, so the sum over them factorises per
    dimension: ``o + ceil(o / b) * 2T``."""
    out = _out_shape(shape, sweeps)
    read = 1
    for o, b in zip(out, tile):
        read *= o + -(-o // b) * 2 * sweeps
    return (read + int(np.prod(out))) * dtype_bytes


def lattice_updates(shape, sweeps: int) -> int:
    """Points updated over T valid sweeps (the MLUPS numerator)."""
    return sum(int(np.prod(_out_shape(shape, s)))
               for s in range(1, sweeps + 1))


def traffic_model(shape: Tuple[int, int, int], sweeps: int,
                  dtype_bytes: int = 4, block_x: int = 8) -> dict:
    """Modeled HBM bytes for T time steps of each variant.

    threaded (x86 WA):  T * (read + write + write-allocate)
    threaded_nt:        T * (read + write)   [TPU stores are always NT]
    wavefront:          read (+ T-halo slab overlap) + write, once
    """
    n = int(np.prod(shape)) * dtype_bytes
    T = sweeps
    halo_overlap = (2 * T) / max(block_x, 1)
    return {
        "threaded": T * 3 * n,
        "threaded_nt": T * 2 * n,
        "wavefront": int((1 + halo_overlap) * n) + n,
    }


def jacobi7_sweeps(x: torch.Tensor, sweeps: int, *,
                   omega: float = 1.0 / 6.0, block_x: int = BLOCK_X,
                   tile: Optional[Tile] = None) -> torch.Tensor:
    """The wrapper of ``csrc/jacobi7.cu`` behind both entries: T valid
    sweeps of ``x`` with output tile ``tile`` (default
    ``(block_x, 32, 64)``: a column of ``block_x`` points along x over a
    32 x 64 y-z tile).  CUDA tensors count one launch in
    ``jacobi7_sweeps.launches``."""
    if x.dim() != 3:
        raise ValueError(f"jacobi7 takes [X,Y,Z], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"jacobi7 takes fp32, got {x.dtype}")
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    out_shape = _out_shape(x.shape, sweeps)
    if min(out_shape) < 1:
        raise ValueError(f"{sweeps} valid sweeps leave nothing of "
                         f"{tuple(x.shape)}")
    tile = tuple(tile) if tile is not None else (block_x, *TILE_YZ)
    if len(tile) != 3 or min(tile) < 1:
        raise ValueError(f"tile must be 3 positive extents, got {tile}")
    need, threads = smem_footprint(sweeps, tile), block_threads(sweeps, tile)
    if need > SMEM_PER_BLOCK or threads > MAX_THREADS:
        raise ValueError(
            f"jacobi7 tile {tile} at T={sweeps} needs {need} B of shared "
            f"memory and {threads} threads, over the {SMEM_PER_BLOCK} B and "
            f"{MAX_THREADS} threads a block may have: wrong placement, "
            f"choose a smaller tile")
    if x.device.type == "cpu":
        out = jacobi7_valid_plain(x, sweeps, omega)
    elif x.device.type == "cuda":
        if sweeps > MAX_SWEEPS:
            raise ValueError(f"the jacobi7 kernel fuses at most "
                             f"{MAX_SWEEPS} sweeps a launch, got {sweeps}")
        out = _launch(x.contiguous(), sweeps, omega, tile, out_shape)
    else:
        raise ValueError(f"jacobi7 runs on cpu or cuda, not {x.device}")
    # 5 adds and 1 multiply per updated point, on fp32 CUDA cores
    nbytes = kernel_bytes(x.shape, sweeps, tile)
    out_bytes = 4 * int(np.prod(out_shape))
    events.record_launch(flops=6 * lattice_updates(x.shape, sweeps),
                         arg_bytes=nbytes - out_bytes, out_bytes=out_bytes)
    return out


def _launch(x: torch.Tensor, sweeps: int, omega: float, tile: Tile,
            out_shape) -> torch.Tensor:
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    lib = _build.library("jacobi7", _SIG)
    guard, stream = _build.launch_on(x.device)
    with guard:
        err = lib.jacobi7_fwd(x.data_ptr(), out.data_ptr(), *x.shape, sweeps,
                              omega, *tile, stream)
    _build.check(lib, err, "jacobi7_fwd")
    jacobi7_sweeps.launches += 1
    return out


#: kernel launches of ``csrc/jacobi7.cu`` through either entry point (a
#: plain counter; reset it by assignment)
jacobi7_sweeps.launches = 0


def jacobi7_naive(x: torch.Tensor, *, omega: float = 1.0 / 6.0,
                  block_x: int = BLOCK_X, tile: Optional[Tile] = None
                  ) -> torch.Tensor:
    """One valid sweep: [X,Y,Z] -> [X-2,Y-2,Z-2] (call T times for T
    steps).  ``tile`` overrides ``(block_x, 32, 64)``."""
    return jacobi7_sweeps(x, 1, omega=omega, block_x=block_x, tile=tile)


def jacobi7_wavefront(x: torch.Tensor, *, sweeps: int = 4,
                      omega: float = 1.0 / 6.0, block_x: int = BLOCK_X,
                      tile: Optional[Tile] = None) -> torch.Tensor:
    """T valid sweeps in one pass over each column's input box:
    [X,Y,Z] -> [X-2T,Y-2T,Z-2T].  ``tile`` overrides
    ``(block_x, 32, 64)``."""
    return jacobi7_sweeps(x, sweeps, omega=omega, block_x=block_x,
                          tile=tile)
