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


# ---------------------------------------------------------------------------
# the bf16 kernel's arithmetic: three passes, tensor-core rounding points
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _ssd_three_pass_emulation(q, k, v, log_f, log_i, *, chunk,
                              normalize=False, eps=1e-6, initial_state=None,
                              tensor_core=True):
    """The arithmetic of ``csrc/ssd_scan.cu``'s bf16 route, in torch on the
    CPU, in its three passes:

    (a) every chunk's local state on its own: the inclusive cumsum Bc of
        log_f, w_j = exp(total - Bc_j + li_j), ``dC = (k * w)^T v`` with
        ``k * w`` split into a bf16 hi and lo part (two products against
        the exact bf16 v, summed in fp32), ``dn = sum_j k_j w_j`` in fp32
        and the chunk's ``total``;
    (b) the pass over states: ``C_prev[c] = running`` (rounded to bf16 as
        the B operand of the inter-chunk product), ``running =
        exp(total_c) running + dC_c``; n alike in fp32; the last running
        state is (C, n);
    (c) every chunk's output: ``exp(Bc_t) (q_t @ C_prev)`` (the row scale
        applied to the fp32 product) plus ``P @ V`` with P = (q k^T, exact
        products summed in fp32) times the decay exp(Bc_t - Bc_j + li_j),
        masked before the exp; P rounded to bf16 for the product, its row
        sum taken in fp32 for the normalizer ``max(|exp(Bc_t) q_t . n_prev
        + rowsum|, eps)``.

    With ``tensor_core=False`` nothing is rounded: the three-pass order
    alone, in fp32.  Not emulated: the kernel takes a tile's decay as a
    row factor times a key factor where the tile's keys span at most 64 in
    Bc, which changes P by fp32 rounding (~1e-6 relative), far below the
    bf16 rounding of P."""
    r16 = _bf16 if tensor_core else (lambda x: x)
    b, s, h, dk = q.shape
    c = min(chunk, s)
    qf, kf, vf, lf, li = (a.float() for a in (q, k, v, log_f, log_i))
    spans = [slice(c0, min(s, c0 + c)) for c0 in range(0, s, c)]
    local = []                                        # (a)
    for sl in spans:
        bc = torch.cumsum(lf[:, sl], 1)               # [B,L,H]
        total = bc[:, -1]
        kw = kf[:, sl] * torch.exp(total[:, None] - bc + li[:, sl])[..., None]
        hi = r16(kw)
        dc = torch.einsum("blhk,blhv->bhkv", hi, vf[:, sl])
        if tensor_core:
            dc = dc + torch.einsum("blhk,blhv->bhkv", _bf16(kw - hi),
                                   vf[:, sl])
        local.append((bc, total, dc, kw.sum(1)))
    if initial_state is None:
        C = torch.zeros((b, h, dk, v.shape[3]))
        n = torch.zeros((b, h, dk))
    else:
        C, n = (a.float() for a in initial_state)
    prev = []                                         # (b)
    for _, total, dc, dn in local:
        prev.append((r16(C), n))
        C = torch.exp(total)[..., None, None] * C + dc
        n = torch.exp(total)[..., None] * n + dn
    ys = []                                           # (c)
    for sl, (bc, _, _, _), (cp, np_) in zip(spans, local, prev):
        g = torch.exp(bc)
        y = torch.einsum("bthk,bhkv->bthv", qf[:, sl], cp) * g[..., None]
        gap = bc[:, :, None] - bc[:, None, :] + li[:, None, sl]  # [B,t,j,H]
        tri = torch.tril(torch.ones(gap.shape[1], gap.shape[2],
                                    dtype=torch.bool))[None, :, :, None]
        p = torch.einsum("bthk,bjhk->btjh", qf[:, sl], kf[:, sl]) * \
            torch.where(tri, torch.exp(gap), 0.0)
        y = y + torch.einsum("btjh,bjhv->bthv", r16(p), vf[:, sl])
        if normalize:
            den = (torch.einsum("bthk,bhk->bth", qf[:, sl], np_) * g
                   + p.sum(2)).abs()
            y = y / den.clamp_min(eps)[..., None]
        ys.append(y)
    return torch.cat(ys, 1).to(v.dtype), (C, n)


def _emulation_inputs(seed, b, s, h, dk, dv, *, positive=False,
                      broadcast=False, state=False):
    """bf16 q, k (broadcast over heads as Mamba2 passes them), v; fp32
    gates; an fp32 carried state (C0 [B,H,dk,dv], n0 >= 0)."""
    rng = np.random.default_rng(seed)

    def qk():
        x = rng.standard_normal((b, s, 1 if broadcast else h, dk),
                                np.float32) * dk ** -0.25
        t = torch.from_numpy(np.abs(x) if positive else x).bfloat16()
        return t.expand(b, s, h, dk)

    q, k = qk(), qk()
    v = torch.from_numpy(rng.standard_normal((b, s, h, dv),
                                             np.float32)).bfloat16()
    lf, li = (torch.from_numpy(-np.logaddexp(
        rng.standard_normal((b, s, h)), 0.0).astype(np.float32))
        for _ in range(2))
    st = None
    if state:
        st = (torch.from_numpy(rng.standard_normal((b, h, dk, dv),
                                                   np.float32)),
              torch.from_numpy(np.abs(rng.standard_normal((b, h, dk),
                                                          np.float32))))
    return (q, k, v, lf, li), st


def _fp32_state_tol(want):
    """``chip_smoke.py::ssd_tol`` for an fp32 C or n: rtol 2e-4, atol 2e-5
    times max(1, max|want|)."""
    return dict(rtol=2e-4, atol=2e-5 * max(1.0, want.abs().max().item()))


BF16_EMULATION = [
    # name, (b, s, h, dk, dv), chunk, normalize, broadcast q/k, state
    ("zamba2 heads", (1, 512, 4, 64, 64), 256, False, True, False),
    ("zamba2 heads, carried state", (1, 512, 4, 64, 64), 256, False, True,
     True),
    ("ragged S", (2, 300, 2, 64, 64), 256, False, False, False),
    ("mLSTM dk=dv=512, normalize", (1, 300, 1, 512, 512), 256, True, False,
     False),
]


@pytest.mark.parametrize("name,shape,chunk,normalize,broadcast,state",
                         BF16_EMULATION, ids=[c[0] for c in BF16_EMULATION])
def test_ssd_bf16_tensor_core_emulation_meets_card_tolerance(
        name, shape, chunk, normalize, broadcast, state):
    """The bf16 route's arithmetic (``_ssd_three_pass_emulation``) against
    the sequential oracle ``ref.ssd_scan`` and, without a carried state,
    the Pallas kernel in interpret mode (with one, the JAX package's
    chunked form), both in fp32 on the same bf16 values.  The card holds
    the kernel to its plain version at bf16 rtol = atol = 3e-2 on y and at
    the fp32 ``ssd_tol`` on C and n (``chip_smoke.py::check_ssd``).
    Observed here (references in fp32, the emulation's y in bf16): y
    within 0.022 of both references at max|y| 6.8 (zamba2 heads), 0.028 at
    8.3 (with a carried state), 0.021 at 5.7 (ragged S), 0.014 at 3.4
    (mLSTM): about one bf16 ulp of the output; C within 1.0e-5 at max|C|
    1.6-2.3 and n within 2.2e-6, under the fp32 tolerance's atol of
    3.2e-5..4.7e-5 by a factor of 3 or more.  Rounding k*w to bf16 once
    instead of hi + lo puts C ~3e-3 off, ~70x that tolerance (this
    emulation with the lo product dropped); C_prev rounded to bf16 leaves
    y's error unchanged at these magnitudes."""
    args, st = _emulation_inputs(len(name), *shape, positive=normalize,
                                 broadcast=broadcast, state=state)
    y, (c, n) = _ssd_three_pass_emulation(*args, chunk=chunk,
                                          normalize=normalize,
                                          initial_state=st)
    assert y.dtype == torch.bfloat16
    jargs = _j([a.float().numpy() for a in args])
    jst = None if st is None else tuple(_j([a.numpy() for a in st]))
    wants = [ref.ssd_scan(*jargs, normalize=normalize, initial_state=jst)]
    if st is None:
        wants.append(ops.ssd_scan(*jargs, chunk=chunk, normalize=normalize,
                                  interpret=True))
    else:
        wants.append(jax_ls._chunked_linear_attention(
            *jargs, chunk_size=chunk, normalize=normalize,
            initial_state=jst))
    for wy, (wc, wn) in wants:
        wy, wc, wn = (torch.from_numpy(np.array(a)) for a in (wy, wc, wn))
        torch.testing.assert_close(y.float(), wy, rtol=3e-2, atol=3e-2)
        torch.testing.assert_close(c, wc, **_fp32_state_tol(wc))
        torch.testing.assert_close(n, wn, **_fp32_state_tol(wn))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("state", [False, True])
def test_ssd_three_pass_decomposition_equals_the_chunked_plain_form(
        state, normalize):
    """In fp32 with nothing rounded, the kernel's order (every chunk's
    local state, the pass over states, then every chunk's output) equals
    ``_chunked_linear_attention`` within the fp32 tolerance, with and
    without a carried state, over a ragged last chunk."""
    args, st = _emulation_inputs(19, 2, 100, 3, 16, 24, positive=normalize,
                                 state=state)
    args = [a.float() for a in args]
    y, (c, n) = _ssd_three_pass_emulation(*args, chunk=32,
                                          normalize=normalize,
                                          initial_state=st,
                                          tensor_core=False)
    want_y, (want_c, want_n) = linear_scan._chunked_linear_attention(
        *args, chunk_size=32, normalize=normalize, initial_state=st)
    for got, want in ((y, want_y), (c, want_c), (n, want_n)):
        _close(got, want)


def test_copy_width_reads_alignment_from_pointers_and_strides():
    """16-byte copies for the model layout (q, k broadcast views into the
    projection, v contiguous), 4-byte for even rows that start on 4 bytes,
    refusal for rows of an odd element count."""
    xbc = torch.zeros(2, 10, 4224, dtype=torch.bfloat16)   # zamba2's layout
    q = xbc[..., 4160:].reshape(2, 10, 1, 64).expand(2, 10, 64, 64)
    k = xbc[..., 4096:4160].reshape(2, 10, 1, 64).expand(2, 10, 64, 64)
    v = torch.zeros(2, 10, 64, 64, dtype=torch.bfloat16)
    assert ssd.copy_width(q, k, v) == 16
    odd20 = torch.zeros(1, 9, 3, 20, dtype=torch.bfloat16)  # rows of 40 B
    assert ssd.copy_width(odd20, odd20, v[:1, :9, :3]) == 4
    assert ssd.copy_width(v[..., 2:34], v[..., 2:34], v[..., 2:34]) == 4
    shifted = torch.zeros(1, 9, 3, 66, dtype=torch.bfloat16)[..., 1:65]
    odd = torch.zeros(1, 9, 3, 17, dtype=torch.bfloat16)
    for bad in (shifted, odd):                  # rows on 2 bytes; odd rows
        with pytest.raises(ValueError, match="16 or 4 bytes"):
            ssd.copy_width(bad, bad, bad)
    # a dim of size 1 never moves a row, whatever its stride
    one = torch.zeros(1, 9, 1, 64, dtype=torch.bfloat16).as_strided(
        (1, 9, 1, 64), (3, 64, 5, 1))
    assert ssd.copy_width(one, one, one) == 16


def test_ssd_scan_declares_fp32_flops_only_where_they_run_in_fp32():
    """The plain twin (a CPU call) computes in fp32, so its FLOPs count in
    FLOPS_F32 whatever the input dtype; a tensor-core launch declares
    ``f32=False`` and leaves FLOPS_F32 alone."""
    from repro_torch.core import events
    q, k, v, lf, li = _t(_inputs(20, 1, 8, 2, 4, 4))
    with events.collect() as ev:
        ssd.ssd_scan(q.bfloat16(), k.bfloat16(), v.bfloat16(), lf, li,
                     chunk=4)
        events.record_launch(flops=10.0, arg_bytes=1.0, out_bytes=1.0,
                             f32=False)
    flops = ssd.ssd_flops(1, 2, 8, 4, 4, 4)
    assert ev.counts["FLOPS_TOTAL"] == flops + 10.0
    assert ev.counts["FLOPS_F32"] == flops
    assert ev.counts["LAUNCHES"] == 2
