"""The port's case-study kernels (STREAM triad, Jacobi-7) against the JAX
package's Pallas kernels.

On this CPU host each wrapper runs its plain PyTorch version (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them against
the same plain versions).  Here the plain versions are held, on the same
numpy-seeded inputs, to the Pallas kernels in interpret mode and to the
oracles of ``repro/kernels/ref.py``:

* triad at the reference's ``TOL`` (``tests/test_kernels.py``: fp32
  rtol=2e-4 atol=2e-5, bf16 3e-2 — JAX rounds ``s*c`` and then the sum,
  the port rounds once);
* Jacobi at rtol=1e-4, atol=1e-5 (the reference's stencil tolerance);
* the traffic model and the triad byte model exactly;
* the triad kernel's schedule (:func:`triad_plan`'s grid and tiles, each
  thread's 16-byte vectors and scalar tail), emulated: it writes every
  element exactly once;
* the Jacobi kernel's 2.5D plane-streaming schedule (the ring of input
  planes, each level's planes, registers and neighbour lanes, the store
  paths, ragged edge columns), emulated in fp32: bit-equal to the plain
  sweeps for T = 1..4 and every tile, within the stencil tolerance of the
  Pallas kernel, and reading each column's box exactly once, as
  :func:`kernel_bytes` counts.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.jacobi7 import jacobi7_naive as jax_naive
from repro.kernels.jacobi7 import jacobi7_wavefront as jax_wavefront
from repro.kernels.jacobi7 import traffic_model as jax_traffic_model
from repro.kernels.stream_triad import stream_triad as jax_triad
from repro.kernels.stream_triad import triad_bytes as jax_triad_bytes
from repro_torch.core import events
from repro_torch.kernels.jacobi7 import (MAX_THREADS, RING_PLANES,
                                         SMEM_PER_BLOCK, block_threads,
                                         jacobi7_naive, jacobi7_sweep_plain,
                                         jacobi7_sweeps, jacobi7_valid_plain,
                                         jacobi7_wavefront, kernel_bytes,
                                         lattice_updates, smem_footprint,
                                         traffic_model)
from repro_torch.kernels.stream_triad import (TRIAD_THREADS,
                                              stream_triad,
                                              stream_triad_plain, triad_bytes,
                                              triad_plan)

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
STENCIL_TOL = dict(rtol=1e-4, atol=1e-5)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# STREAM triad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [128, 4096, 128 * 513])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pipelined", [True, False])
def test_triad_matches_pallas_and_oracle(n, dtype, pipelined):
    b, c = _normal(n, n), _normal(n + 1, n)
    jb, jc = jnp.asarray(b, JNP[dtype]), jnp.asarray(c, JNP[dtype])
    want_pallas = np.asarray(jax_triad(jb, jc, s=2.5, pipelined=pipelined),
                             np.float32)
    want_ref = np.asarray(ref.stream_triad(None, jb, jc, 2.5), np.float32)
    tb = torch.from_numpy(b).to(TORCH[dtype])
    tc = torch.from_numpy(c).to(TORCH[dtype])
    got = stream_triad(tb, tc, s=2.5, pipelined=pipelined)
    assert got.dtype == TORCH[dtype] and got.shape == (n,)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want_pallas, **TOL[dtype])
    np.testing.assert_allclose(got, want_ref, **TOL[dtype])
    if dtype == "float32":       # one rounding of b + s*c, as on the card
        np.testing.assert_array_equal(
            got, stream_triad_plain(torch.from_numpy(b),
                                    torch.from_numpy(c)).numpy())


def test_triad_block_rows_does_not_change_the_result():
    b, c = torch.from_numpy(_normal(1, 128 * 7)), \
        torch.from_numpy(_normal(2, 128 * 7))
    base = stream_triad(b, c)
    for rows in (1, 3, 256):
        assert torch.equal(stream_triad(b, c, block_rows=rows), base)


def _tile_coverage(length, esize, vector_ok):
    """Writes per element of one tile of ``length`` elements, as the
    kernel's threads take it: with ``vector_ok`` thread x takes the
    16-byte vectors x, x + 256, ..., then every thread the scalar tail x,
    x + 256, ...; without it, the scalars only."""
    kn = 16 // esize
    counts = np.zeros(length, np.int64)
    tail = 0
    if vector_ok:
        nvec = length // kn
        for x in range(TRIAD_THREADS):
            for v in range(x, nvec, TRIAD_THREADS):
                counts[v * kn:(v + 1) * kn] += 1
        tail = nvec * kn
    for x in range(TRIAD_THREADS):
        counts[tail + x::TRIAD_THREADS] += 1
    return counts


@pytest.mark.parametrize("n", [128, 128 * 3, 128 * 513, 1 << 27])
@pytest.mark.parametrize("esize", [4, 2])
def test_triad_schedule_writes_every_element_once(n, esize):
    schedules = [(None, True), (1, True), (3, True), (256, True)]
    if n < 1 << 20:                        # one CTA over the whole array
        schedules.append((None, False))
    for rows, pipelined in schedules:
        grid, tile = triad_plan(n, esize, rows, pipelined)
        assert tile % 128 == 0 and grid >= 1
        tiles = -(-n // tile)
        if not pipelined:
            assert (grid, tile) == (1, n)
        elif rows is None:                 # one vector a thread a tile
            assert tile == min(TRIAD_THREADS * 16 // esize, n)
        else:
            assert tile == min(rows * 128, n)
        if pipelined:                      # one CTA a tile
            assert grid == tiles
        # CTA i takes tiles i, i + grid, ...: each tile exactly once
        taken = np.concatenate([np.arange(i, tiles, grid)
                                for i in range(grid)])
        np.testing.assert_array_equal(np.sort(taken), np.arange(tiles))
        # aligned views take the vector path, unaligned ones the scalars;
        # within the tiles (all full but the last) every element once
        for vector_ok in (True, False):
            for length in {tile, n - (tiles - 1) * tile}:
                assert (_tile_coverage(length, esize, vector_ok) == 1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_triad_schedule_and_alignment_never_change_the_result(dtype):
    n = 128 * 513
    buf = torch.from_numpy(_normal(3, n + 1)).to(TORCH[dtype])
    b, c = buf[:-1].clone(), buf[1:].clone()
    base = stream_triad(b, c)
    assert torch.equal(base, stream_triad_plain(b, c))
    for rows in (None, 1, 3, 256):
        for pipelined in (True, False):
            assert torch.equal(stream_triad(b, c, block_rows=rows,
                                            pipelined=pipelined), base)
    # views that start one element past a 16-byte boundary
    assert torch.equal(stream_triad(buf[1:], buf[:-1]),
                       stream_triad_plain(buf[1:], buf[:-1]))


def test_triad_rejects_unaligned_and_mismatched():
    with pytest.raises(ValueError, match="lane-aligned"):
        stream_triad(torch.ones(100), torch.ones(100))
    with pytest.raises(ValueError, match="1-D"):
        stream_triad(torch.ones(128), torch.ones(256))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        stream_triad(torch.ones(128, dtype=torch.float64),
                     torch.ones(128, dtype=torch.float64))
    with pytest.raises(ValueError, match="cpu or cuda"):
        stream_triad(torch.ones(128, device="meta"),
                     torch.ones(128, device="meta"))


@pytest.mark.parametrize("n,dtype_bytes", [(1024, 4), (1 << 27, 4),
                                           (4096, 2)])
def test_triad_bytes_model_equals_reference(n, dtype_bytes):
    assert triad_bytes(n, dtype_bytes) == jax_triad_bytes(n, dtype_bytes)


def test_triad_declares_its_events():
    n = 128 * 5
    with events.collect() as ev:
        stream_triad(torch.ones(n, dtype=torch.bfloat16),
                     torch.ones(n, dtype=torch.bfloat16))
    assert ev["FLOPS_TOTAL"] == ev["FLOPS_F32"] == 2 * n
    assert ev["HBM_ARG_BYTES"] == 2 * n * 2
    assert ev["HBM_OUT_BYTES"] == n * 2
    assert ev["BYTES_ACCESSED"] == triad_bytes(n, 2)
    assert ev["LAUNCHES"] == 1


# ---------------------------------------------------------------------------
# Jacobi 7-point stencil
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(10, 18, 130), (18, 34, 130),
                                   (12, 20, 258)])
def test_jacobi_naive_matches_pallas_and_oracle(shape):
    x = _normal(1, *shape)
    got = jacobi7_naive(torch.from_numpy(x)).numpy()
    assert got.shape == tuple(s - 2 for s in shape)
    np.testing.assert_allclose(got, np.asarray(jax_naive(jnp.asarray(x))),
                               **STENCIL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.jacobi7_sweep(jnp.asarray(x))), **STENCIL_TOL)


@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_jacobi_wavefront_matches_pallas_and_oracle(sweeps):
    x = _normal(2, 16, 26, 130)
    got = jacobi7_wavefront(torch.from_numpy(x), sweeps=sweeps).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_wavefront(jnp.asarray(x), sweeps=sweeps)),
        **STENCIL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.jacobi7_valid(jnp.asarray(x), sweeps)),
        **STENCIL_TOL)


@pytest.mark.parametrize("block_x", [1, 3, 8])
def test_jacobi_results_do_not_depend_on_block_x(block_x):
    x = _normal(3, 14, 22, 40)
    got = jacobi7_wavefront(torch.from_numpy(x), sweeps=2,
                            block_x=block_x).numpy()
    np.testing.assert_array_equal(
        got, jacobi7_wavefront(torch.from_numpy(x), sweeps=2).numpy())
    np.testing.assert_allclose(
        got, np.asarray(jax_wavefront(jnp.asarray(x), sweeps=2,
                                      block_x=block_x)), **STENCIL_TOL)


def test_jacobi_wavefront_equals_composed_naive_sweeps():
    x = torch.from_numpy(_normal(4, 14, 22, 30))
    two = jacobi7_naive(jacobi7_naive(x))
    assert torch.equal(jacobi7_wavefront(x, sweeps=2), two)
    assert torch.equal(jacobi7_valid_plain(x, 2),
                       jacobi7_sweep_plain(jacobi7_sweep_plain(x)))


def _plane_streaming_emulation(x, sweeps, tile, vec, omega=1.0 / 6.0):
    """``csrc/jacobi7.cu``'s 2.5D schedule in fp32 numpy, column by column.

    Planes are flat ``(by+2T) x pitch`` arrays (rows padded to 4); thread
    ``t`` of a CTA owns the 4-point chunk at ``4t`` of every plane (row
    ``t // (pitch/4)``), and a warp is 32 consecutive threads.  A column's
    input box (its true output extent plus T a side) streams along x:
    input plane p lands in ring slot p % RING_PLANES, copied row by row
    (4-element vectors with a zero-filled partial last one when ``vec``,
    else element by element).  Once plane p has landed, every thread
    loads its chunk of it, and level s computes its plane p - 2s on every
    chunk that meets the points at least s from the box's edge: x-1, x
    and x+1 of level s-1 from the thread's own values of the last three
    steps (its registers), z-1 and z+1 past the chunk's ends from the
    neighbouring threads' values (shuffles; the first and last lane of a
    warp read level s-1's previous plane instead), y+-1 from that plane
    (the ring, or one of the level's two buffers); levels below T store
    their plane in buffer i % 2, level T writes the points inside its
    domain to the output (through the ring slot of plane p-2 unless the
    output rows are whole 32-byte sectors: the slot is then clobbered,
    and nothing may read it again).  Shared planes and registers start
    as NaN, and a register no step wrote is NaN, so reading anything no
    copy or level wrote for this use breaks the result.  Asserts that each step reads
    the planes it expects and that a copy never lands in a slot a later
    step reads; returns the output and how many times each input point
    was read."""
    t = sweeps
    xs, ys, zs = x.shape
    ox, oy, oz = xs - 2 * t, ys - 2 * t, zs - 2 * t
    bx, by, bz = tile
    pitch = -(-(bz + 2 * t) // 4) * 4
    cpr, rows = pitch // 4, by + 2 * t
    plane = rows * pitch
    tid = np.arange(-(-rows * cpr // 32) * 32)          # whole warps
    jr, kz = tid // cpr, 4 * (tid % cpr)
    c = np.minimum(4 * tid, plane - 4)                  # idle threads clamp
    pts = c[:, None] + np.arange(4)                     # [threads, 4]
    first, last = tid % 32 == 0, tid % 32 == 31
    out = np.full((ox, oy, oz), np.nan, np.float32)
    reads = np.zeros(x.shape, np.int64)
    writes = np.zeros(out.shape, np.int64)
    om, nan = np.float32(omega), np.float32(np.nan)
    direct = oz % 8 == 0 and bz % 8 == 0      # output rows whole sectors
    for x0 in range(0, ox, bx):
        for y0 in range(0, oy, by):
            for z0 in range(0, oz, bz):
                lx = min(bx, ox - x0) + 2 * t
                ly = min(by, oy - y0) + 2 * t
                lz = min(bz, oz - z0) + 2 * t
                live = {s: (jr >= s) & (jr < ly - s) & (kz + 4 > s)
                        & (kz < lz - s) for s in range(1, t + 1)}
                ring = np.full((RING_PLANES, plane), nan, np.float32)
                held = [-1] * RING_PLANES
                levels = np.full((max(t - 1, 0), 2, plane), nan, np.float32)
                lheld = [[-1, -1] for _ in range(t - 1)]
                # registers: level s's chunk two steps ago and one step ago
                prev2 = np.full((t, len(tid), 4), nan, np.float32)
                prev1 = prev2.copy()

                def fetch(p, step):
                    slot = p % RING_PLANES
                    # no step from `step` on reads the plane it replaces
                    assert held[slot] < max(step - 1, 0)
                    dst, src = ring[slot], x[x0 + p, y0:y0 + ly]
                    width = 4 if vec else 1
                    for j in range(ly):
                        for v in range(0, lz, width):
                            n = min(width, lz - v)
                            d = j * pitch + v
                            dst[d:d + n] = src[j, z0 + v:z0 + v + n]
                            dst[d + n:d + width] = 0.0      # zero-fill
                    reads[x0 + p, y0:y0 + ly, z0:z0 + lz] += 1
                    held[slot] = p

                for p in range(RING_PLANES - 3):
                    if p < lx:
                        fetch(p, 0)
                for p in range(lx):
                    assert held[p % RING_PLANES] == p        # has landed
                    if p + RING_PLANES - 3 < lx:
                        fetch(p + RING_PLANES - 3, p)
                    now = np.full_like(prev1, nan)
                    now[0] = ring[p % RING_PLANES][pts]
                    for s in range(1, t + 1):
                        i = p - 2 * s
                        if i < 0:
                            continue
                        if s == 1:
                            assert held[(i + 1) % RING_PLANES] == i + 1
                            ctr = ring[(i + 1) % RING_PLANES]
                        else:
                            assert lheld[s - 2][(i + 1) % 2] == i + 1
                            ctr = levels[s - 2][(i + 1) % 2]
                        mid = prev1[s - 1]
                        zl = np.roll(mid[:, 3], 1)          # lane - 1
                        zr = np.roll(mid[:, 0], -1)         # lane + 1
                        sel = live[s]
                        cc, pp = c[sel], pts[sel]
                        # every read stays inside the plane
                        assert (pp - pitch).min() >= 0 and \
                            (pp + pitch).max() < plane and \
                            (cc + 4).max() < plane
                        zl = np.where(first, ctr[c - 1], zl)[sel]
                        zr = np.where(last, ctr[np.minimum(c + 4, plane - 1)],
                                      zr)[sel]
                        md = mid[sel]
                        v = prev2[s - 1][sel] + now[s - 1][sel]
                        v = v + ctr[pp - pitch]
                        v = v + ctr[pp + pitch]
                        v = v + np.concatenate([zl[:, None], md[:, :3]], 1)
                        v = v + np.concatenate([md[:, 1:], zr[:, None]], 1)
                        v = v * om
                        if s < t:
                            levels[s - 1][i % 2][pp] = v
                            lheld[s - 1][i % 2] = i
                            now[s][sel] = v
                            continue
                        if not direct:
                            # the stores go out transposed through the
                            # slot of plane p-2: nothing may read it again
                            ring[(p - 2) % RING_PLANES] = nan
                            held[(p - 2) % RING_PLANES] = -1
                        z = kz[sel][:, None] + np.arange(4)
                        inside = (z >= t) & (z < lz - t)
                        r = np.broadcast_to(jr[sel][:, None] - t, z.shape)
                        idx = (x0 + i, y0 + r[inside], z0 + z[inside] - t)
                        out[idx] = v[inside]
                        writes[idx] += 1
                    prev2, prev1 = prev1, now
    assert (writes == 1).all()
    return out, reads


STREAM_CASES = [
    # shape, tiles: (37, 45, 99) is no multiple of any tile (ragged edge
    # columns, z rows unaligned: 4-byte copies); (30, 26, 44) takes the
    # 16-byte copies with a partial last vector; columns from one plane
    # deep to the whole x extent
    ((37, 45, 99), [(64, 16, 64), (4, 8, 32), (3, 5, 7), (16, 16, 16)]),
    ((30, 26, 44), [(64, 16, 64), (8, 8, 12), (5, 7, 16), (1, 3, 4)]),
]


@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
@pytest.mark.parametrize("shape,tiles", STREAM_CASES)
def test_plane_streaming_schedule_matches_plain_and_pallas(shape, tiles,
                                                           sweeps):
    x = _normal(9 + sweeps, *shape)
    plain = jacobi7_valid_plain(torch.from_numpy(x), sweeps).numpy()
    jax_fn = jax_naive if sweeps == 1 else functools.partial(
        jax_wavefront, sweeps=sweeps)
    pallas = np.asarray(jax_fn(jnp.asarray(x)))
    for tile in tiles:
        vec = shape[2] % 4 == 0 and tile[2] % 4 == 0
        got, reads = _plane_streaming_emulation(x, sweeps, tile, vec)
        # the order of the sums is the plain sweep's: bit-equal, any tile
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_allclose(got, pallas, **STENCIL_TOL)
        # each column reads its box once: kernel_bytes counts exactly that
        out_bytes = 4 * plain.size
        assert 4 * int(reads.sum()) + out_bytes == \
            kernel_bytes(shape, sweeps, tile)


@pytest.mark.parametrize("shape,sweeps,block_x", [
    ((64, 128, 256), 4, 8), ((24, 48, 96), 2, 8), ((512, 512, 512), 4, 16),
    ((512, 512, 512), 1, 1)])
def test_traffic_model_equals_reference(shape, sweeps, block_x):
    assert traffic_model(shape, sweeps, block_x=block_x) == \
        jax_traffic_model(shape, sweeps, block_x=block_x)
    assert traffic_model(shape, sweeps, 2, block_x) == \
        jax_traffic_model(shape, sweeps, 2, block_x)


def test_kernel_bytes_counts_halos_per_tile():
    # one tile covers the whole output: the input read once, output once
    shape, t = (20, 30, 40), 2
    out = [s - 2 * t for s in shape]
    assert kernel_bytes(shape, t, tuple(out)) == 4 * (
        np.prod(shape) + np.prod(out))
    # two tiles along x: the halo of 2T planes is read twice
    tile = (out[0] // 2, out[1], out[2])
    assert kernel_bytes(shape, t, tile) == 4 * (
        (shape[0] + 2 * t) * shape[1] * shape[2] + np.prod(out))
    assert lattice_updates(shape, t) == np.prod([s - 2 for s in shape]) + \
        np.prod(out)


def test_smem_footprint_and_refusal_of_a_tile_that_does_not_fit():
    # a ring of 6 input planes and 2 planes for each of sweeps 1..T-1,
    # each the y-z box (by+2T) x (bz+2T) with rows padded to 4; one thread
    # a 4-point chunk of a plane
    assert smem_footprint(4, (8, 16, 64)) == 4 * (6 + 2 * 3) * 24 * 72
    assert smem_footprint(1, (8, 16, 64)) == 4 * 6 * 18 * 68
    assert smem_footprint(3, (3, 5, 7)) == 4 * (6 + 2 * 2) * 11 * 16
    assert block_threads(4, (8, 16, 64)) == 24 * 18
    assert block_threads(1, (8, 16, 64)) == 18 * 17
    # the x extent streams through and costs neither
    assert smem_footprint(4, (64, 16, 64)) == smem_footprint(4, (8, 16, 64))
    assert block_threads(4, (64, 16, 64)) == block_threads(4, (8, 16, 64))
    assert smem_footprint(4, (64, 16, 64)) <= SMEM_PER_BLOCK // 2
    assert smem_footprint(4, (64, 32, 64)) <= SMEM_PER_BLOCK
    assert block_threads(4, (64, 32, 64)) <= MAX_THREADS
    # refused: planes over 227 KiB; a plane of more chunks than threads
    assert smem_footprint(4, (8, 64, 128)) > SMEM_PER_BLOCK
    assert smem_footprint(1, (8, 64, 128)) <= SMEM_PER_BLOCK < \
        4 * block_threads(1, (8, 64, 128)) * 4 * 16
    assert block_threads(1, (8, 64, 128)) > MAX_THREADS
    x = torch.zeros(40, 80, 140)
    for t, tile in ((4, (8, 64, 128)), (1, (8, 64, 128))):
        with pytest.raises(ValueError, match="wrong placement"):
            jacobi7_wavefront(x, sweeps=t, tile=tile)
    with pytest.raises(ValueError, match="leave nothing"):
        jacobi7_wavefront(torch.zeros(8, 20, 20), sweeps=4)
    with pytest.raises(TypeError, match="fp32"):
        jacobi7_naive(torch.zeros(8, 8, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="cpu or cuda"):
        jacobi7_naive(torch.zeros(8, 8, 8, device="meta"))


def test_jacobi_declares_its_events():
    shape, t, tile = (20, 30, 70), 3, (4, 16, 64)
    with events.collect() as ev:
        jacobi7_sweeps(torch.zeros(shape), t, tile=tile)
    out = 4 * np.prod([s - 2 * t for s in shape])
    assert ev["BYTES_ACCESSED"] == kernel_bytes(shape, t, tile)
    assert ev["HBM_OUT_BYTES"] == out
    assert ev["FLOPS_TOTAL"] == ev["FLOPS_F32"] == \
        6 * lattice_updates(shape, t)
    assert ev["LAUNCHES"] == 1
