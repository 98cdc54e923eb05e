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
  element exactly once.
"""

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
from repro_torch.kernels.jacobi7 import (SMEM_PER_BLOCK, jacobi7_naive,
                                         jacobi7_sweep_plain, jacobi7_sweeps,
                                         jacobi7_valid_plain,
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
    assert smem_footprint(4, (8, 16, 64)) == 4 * (16 * 24 * 72
                                                  + 14 * 22 * 70)
    assert smem_footprint(1, (8, 16, 64)) == 4 * 10 * 18 * 66
    assert smem_footprint(4, (8, 16, 64)) <= SMEM_PER_BLOCK
    assert smem_footprint(4, (16, 16, 64)) > SMEM_PER_BLOCK
    x = torch.zeros(40, 40, 90)
    with pytest.raises(ValueError, match="wrong placement"):
        jacobi7_wavefront(x, sweeps=4, tile=(16, 16, 64))
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
