"""The port's SSD scan and Mamba2 block against the JAX package, on the CPU.

* ``repro_torch.kernels.ssd_scan`` (on CPU tensors: the chunked plain twin)
  against the Pallas ``ssd_scan`` in interpret mode (``ops.ssd_scan`` and
  the flat entry ``ssd_scan_flat``) and the sequential oracle
  ``ref.ssd_scan``,
  over (b, s, h, dk, dv, chunk) with S not a chunk multiple and S < chunk,
  normalize on and off, and a carried initial state against
  ``_chunked_linear_attention``;
* ``decode_step_linear_attention``, ``_causal_conv`` with a tail;
* ``apply_mamba2_block`` with state, and ``mamba2_decode``, at the
  ``zamba2-1.2b`` SMOKE widths with the JAX block's parameters.

Tolerance: the reference kernels' fp32 ``rtol=2e-4, atol=2e-5``
(``tests/test_kernels.py:17``).  Inputs give scores q.k of unit variance;
normalized cases take q, k >= 0, so the normalizer q.n stays away from 0
(there, fp32 cancellation alone exceeds any tight tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.zamba2_1_2b import SMOKE as JAX_SMOKE
from repro.kernels import ops, ref
from repro.kernels.ssd_scan import ssd_scan_flat as jax_ssd_scan_flat
from repro.models import linear_scan as jax_ls
from repro.models import ssm as jax_ssm
from repro_torch.configs.zamba2_1_2b import SMOKE
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import linear_scan, ssm

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(seed, b, s, h, dk, dv, positive=False):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            * dk ** -0.25 for _ in range(2))
    if positive:
        q, k = np.abs(q), np.abs(k)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    log_f, log_i = (-np.logaddexp(rng.standard_normal((b, s, h)), 0.0)
                    .astype(np.float32) for _ in range(2))
    return q, k, v, log_f, log_i


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


SWEEP = [
    # b, s, h, dk, dv, chunk
    (1, 128, 2, 16, 16, 32),
    (2, 100, 2, 16, 32, 32),       # S not a chunk multiple
    (1, 20, 3, 32, 16, 64),        # S < chunk
    (2, 64, 1, 32, 32, 64),        # chunk == S
]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("b,s,h,dk,dv,chunk", SWEEP)
def test_ssd_scan_matches_pallas_and_oracle(b, s, h, dk, dv, chunk,
                                            normalize):
    arrs = _inputs(s + dk + h, b, s, h, dk, dv, positive=normalize)
    y, (c, n) = ssd.ssd_scan(*_t(arrs), chunk=chunk, normalize=normalize)
    jy, (jc, jn) = ops.ssd_scan(*_j(arrs), chunk=chunk, normalize=normalize,
                                interpret=True)
    ry, (rc, rn) = ref.ssd_scan(*_j(arrs), normalize=normalize)
    for got, kernel, oracle in ((y, jy, ry), (c, jc, rc), (n, jn, rn)):
        assert got.dtype == torch.float32
        _close(got, kernel)
        _close(got, oracle)
    # the port's own oracle is the reference's
    oy, (oc, on) = ssd.ssd_scan_ref(*_t(arrs), normalize=normalize)
    _close(oy, ry)
    _close(oc, rc)
    _close(on, rn)


def test_flat_layout_matches_the_pallas_entry():
    """The Pallas entry's flat [BH,S,d] layout is the view [BH,S,1,d]; a
    scan split in two with the state carried equals the whole."""
    q, k, v, lf, li = _inputs(7, 1, 70, 6, 16, 32)
    flat = [np.ascontiguousarray(a[0].swapaxes(0, 1)) for a in (q, k, v)]
    flat += [np.ascontiguousarray(a[0].T) for a in (lf, li)]   # [BH, S]
    view = [t[:, :, None] for t in _t(flat)]
    y, (c, n) = ssd.ssd_scan(*view, chunk=32)
    jy, (jc, jn) = jax_ssd_scan_flat(*_j(flat), chunk=32, interpret=True)
    for got, want in ((y[:, :, 0], jy), (c[:, 0], jc), (n, jn)):
        _close(got, want)
    y1, st = ssd.ssd_scan(*[t[:, :40] for t in view], chunk=32)
    y2, (c2, n2) = ssd.ssd_scan(*[t[:, 40:] for t in view], chunk=32,
                                initial_state=st)
    _close(torch.cat([y1, y2], 1), y)
    _close(c2, c)
    _close(n2, n)


@pytest.mark.parametrize("normalize", [False, True])
def test_initial_state_matches_jax_chunked_and_sequential(normalize):
    b, s, h, dk, dv = 2, 45, 3, 16, 24
    arrs = _inputs(11, b, s, h, dk, dv, positive=normalize)
    rng = np.random.default_rng(12)
    c0 = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    n0 = np.abs(rng.standard_normal((b, h, dk))).astype(np.float32)
    y, (c, n) = ssd.ssd_scan(*_t(arrs), chunk=16, normalize=normalize,
                             initial_state=tuple(_t((c0, n0))))
    jy, (jc, jn) = jax_ls._chunked_linear_attention(
        *_j(arrs), chunk_size=16, normalize=normalize,
        initial_state=tuple(_j((c0, n0))))
    sy, (sc, sn) = jax_ls.sequential_linear_attention(
        *_j(arrs), normalize=normalize, initial_state=tuple(_j((c0, n0))))
    for got, chunked, seq in ((y, jy, sy), (c, jc, sc), (n, jn, sn)):
        _close(got, chunked)
        _close(got, seq)
    # the plain form and the oracle agree on the port's side too
    oy, _ = linear_scan.sequential_linear_attention(
        *_t(arrs), normalize=normalize, initial_state=tuple(_t((c0, n0))))
    _close(oy, sy)


def test_chunk_size_changes_only_rounding():
    arrs = _t(_inputs(13, 1, 128, 2, 16, 16))
    y32, _ = ssd.ssd_scan(*arrs, chunk=32)
    y64, _ = ssd.ssd_scan(*arrs, chunk=64)
    _close(y32, y64)


def test_ssd_scan_validates_and_counts_no_cpu_launch():
    q, k, v, lf, li = _t(_inputs(14, 1, 8, 2, 4, 4))
    before = ssd.ssd_scan.launches
    with pytest.raises(ValueError, match="log_f"):
        ssd.ssd_scan(q, k, v, lf[:, :4], li)
    with pytest.raises(ValueError, match="initial_state"):
        ssd.ssd_scan(q, k, v, lf, li, initial_state=(torch.zeros(1, 2, 4, 4),
                                                     torch.zeros(1, 2, 5)))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ssd.ssd_scan(q.half(), k.half(), v.half(), lf, li)
    ssd.ssd_scan(q, k, v, lf, li)
    assert ssd.ssd_scan.launches == before       # CPU runs the plain twin
    # the FLOP model counts the causal half of each chunk's score tile
    assert ssd.ssd_flops(1, 1, 4, 2, 3, 4) == \
        4 * 4 * 2 * 3 + 4 * 5 * (2 + 3) + 2 * 4 * 2


def test_decode_step_matches_jax():
    rng = np.random.default_rng(15)
    b, h, dk, dv = 3, 4, 8, 12
    q, k = (rng.standard_normal((b, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, dv)).astype(np.float32)
    lf, li = (-np.abs(rng.standard_normal((b, h))).astype(np.float32)
              for _ in range(2))
    c0 = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    n0 = np.abs(rng.standard_normal((b, h, dk))).astype(np.float32)
    for normalize in (False, True):
        y, (c, n) = linear_scan.decode_step_linear_attention(
            *_t((q, k, v, lf, li)), tuple(_t((c0, n0))), normalize=normalize)
        jy, (jc, jn) = jax_ls.decode_step_linear_attention(
            *_j((q, k, v, lf, li)), tuple(_j((c0, n0))), normalize=normalize)
        for got, want in ((y, jy), (c, jc), (n, jn)):
            _close(got, want)


# ---------------------------------------------------------------------------
# the Mamba2 block at the zamba2-1.2b SMOKE widths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    jcfg = JAX_SMOKE.mamba_config()
    cfg = SMOKE.mamba_config()
    assert cfg._asdict() == jcfg._asdict()
    jp = jax.device_get(jax_ssm.init_mamba2_block(jax.random.PRNGKey(3),
                                                  jcfg))
    p = ssm.Mamba2Block(cfg, torch.float32, torch.device("cpu"))
    p.load_state_dict({name: torch.from_numpy(np.array(leaf, np.float32))
                       for name, leaf in _flat(jp).items()})
    return jcfg, jax.tree.map(jnp.asarray, jp), cfg, p


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_config_sizes_and_init_spread(block):
    jcfg, jp, cfg, p = block
    for prop in ("d_inner", "num_heads", "conv_channels", "in_proj_out"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    mine = ssm.Mamba2Block(cfg, torch.float32, torch.device("cpu"))
    mine.init(torch.Generator().manual_seed(0))
    for name, theirs in _flat(jax.device_get(jp)).items():
        got = mine.state_dict()[name]
        assert got.shape == theirs.shape, name
        if name in ("A_log", "D", "conv_b") or name.endswith("scale"):
            np.testing.assert_allclose(got.numpy(), theirs, **TOL)
        elif name == "dt_bias":
            # inverse softplus of dt in [1e-3, 1e-1]
            dt = torch.nn.functional.softplus(got)
            assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001
        else:
            assert abs(got.std().item() / theirs.std() - 1) < 0.2, name


def test_causal_conv_with_tail_matches_jax():
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    tail = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for t in (None, tail):
        got = ssm._causal_conv(*_t((x, w, b)),
                               tail=None if t is None else torch.from_numpy(t))
        want = jax_ssm._causal_conv(*_j((x, w, b)),
                                    tail=None if t is None else jnp.asarray(t))
        _close(got, want)


def test_mamba2_block_prefill_with_state_and_decode_match_jax(block):
    jcfg, jp, cfg, p = block
    rng = np.random.default_rng(17)
    b, s = 2, 37                         # > 2 chunks of 16, a ragged last
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    st0 = {"ssd": (rng.standard_normal(
        (b, cfg.num_heads, cfg.d_state, cfg.head_dim)).astype(np.float32),
        np.zeros((b, cfg.num_heads, cfg.d_state), np.float32)),
        "conv": rng.standard_normal(
            (b, cfg.conv_kernel - 1, cfg.conv_channels)).astype(np.float32)}
    jst = jax.tree.map(jnp.asarray, st0)
    tst = {"ssd": tuple(_t(st0["ssd"])), "conv": torch.from_numpy(
        st0["conv"])}
    with torch.inference_mode():
        y, st = ssm.apply_mamba2_block(p, torch.from_numpy(x), cfg,
                                       initial_state=tst, return_state=True)
    jy, jst = jax_ssm.apply_mamba2_block(jp, jnp.asarray(x), jcfg,
                                         initial_state=jst,
                                         return_state=True)
    _close(y, jy)
    _close(st["ssd"][0], jst["ssd"][0])
    _close(st["conv"], jst["conv"])
    for _ in range(3):
        xt = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        with torch.inference_mode():
            y, st = ssm.mamba2_decode(p, torch.from_numpy(xt), cfg, st)
        jy, jst = jax_ssm.mamba2_decode(jp, jnp.asarray(xt), jcfg, jst)
        _close(y, jy)
        _close(st["ssd"][0], jst["ssd"][0])
        _close(st["conv"], jst["conv"])


def test_segments_shorter_than_the_conv_carry_the_older_tail(block):
    """Prefill in segments of 5, 2 and 9 tokens equals one 16-token
    prefill: a 2-token segment keeps the tail's oldest input (the JAX
    block takes only the segment's own last K-1 inputs, so it cannot
    serve a segment shorter than K-1)."""
    _, _, cfg, p = block
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.standard_normal((1, 16, cfg.d_model))
                         .astype(np.float32))
    with torch.inference_mode():
        want, want_st = ssm.apply_mamba2_block(p, x, cfg, return_state=True)
        st, parts = None, []
        for lo, hi in ((0, 5), (5, 7), (7, 16)):
            y, st = ssm.apply_mamba2_block(p, x[:, lo:hi], cfg,
                                           initial_state=st,
                                           return_state=True)
            parts.append(y)
    _close(torch.cat(parts, 1), want)
    _close(st["conv"], want_st["conv"])
    _close(st["ssd"][0], want_st["ssd"][0])
