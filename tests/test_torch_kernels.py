"""The port's kernel modules against the JAX package's Pallas kernels.

On this CPU host each wrapper runs its plain PyTorch version (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them against
the same plain versions).  Here the plain versions are held to the Pallas
kernels run in interpret mode and to the JAX oracles in
``repro/kernels/ref.py``, on the same numpy-seeded inputs:

* flash prefill and paged decode (fp and int8 pages), fp32,
  rtol=atol=1e-5 (the tolerance of ``tests/test_kernels.py``,
  ``tests/test_paged_decode.py`` and ``tests/test_prefix_cache.py``);
* fp32 pages under a bf16 query (``kv_dtype="fp32"`` on a bf16 model),
  rtol=atol=1e-2: one bf16 rounding of the output apart;
* the int8 KV quantizer: codes bit-equal to the JAX package's;
* argmax, exactly, including ties and rows of -inf.

Three kernels' numerics are emulated here, since their CUDA code runs
only on the card: the bf16 flash kernel's tensor-core rounding (P rounded
to bf16 before PV, fp32 accumulation, bf16 output), held to the plain
version and the Pallas kernel within the card's bf16 tolerance; the
argmax kernel's split of a row over a cluster of CTAs (its plan, each
CTA's scalar head, 16-byte body and scalar tail, and the combine), held
to ``jnp.argmax`` on ties and NaN at the split boundaries; and both paged
kernels' split of a row's pages over a cluster (their plan, each CTA's
page range and partial softmax, and the combine in any order), held to
the plain versions and the Pallas kernels: int8 pages and fp32 at the
fp32 tolerance, bf16 outputs (bf16 pages, or fp32 pages under a bf16
query) one bf16 rounding apart.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro.kernels.paged_decode import \
    paged_decode_attention_grouped as jax_paged
from repro.kernels.paged_decode import \
    paged_decode_attention_q8_grouped as jax_paged_q8
from repro.models.attention import quantize_kv_rows as jax_quantize
from repro.kernels.sampling import block_argmax as jax_argmax
from repro_torch.kernels import _build, sampling
from repro_torch.kernels.flash_attention import (NEG_INF,
                                                 flash_attention_bhsd,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_decode import (
    MAX_SPLIT, SMEM_PER_BLOCK, fp_smem_bytes, paged_decode_attention_grouped,
    paged_decode_attention_q8_grouped, paged_decode_plain,
    paged_decode_q8_plain, q8_smem_bytes, split_plan)
from repro_torch.models.attention import quantize_kv_rows

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# flash prefill
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # b, h, kvh, sq, sk, dh, causal, q_offset, kv_valid
    (3, 4, 2, 40, 40, 16, True, 0, [40, 0, 13]),      # ragged, a 0 row
    (3, 4, 2, 40, 40, 16, False, 0, [40, 0, 13]),     # non-causal ragged
    (2, 4, 2, 19, 50, 16, True, 31, [50, 44]),        # q_offset, Sq < Sk
    (1, 7, 1, 37, 37, 8, True, 0, None),              # SMOKE's G=7, Dh=8
]


@pytest.mark.parametrize("b,h,kvh,sq,sk,dh,causal,q_offset,kv_valid",
                         FLASH_CASES)
def test_flash_plain_matches_pallas_and_oracle(b, h, kvh, sq, sk, dh, causal,
                                               q_offset, kv_valid):
    rng = np.random.default_rng(sq * 7 + sk + h)
    q, k, v = (_normal(rng, b, h, sq, dh), _normal(rng, b, kvh, sk, dh),
               _normal(rng, b, kvh, sk, dh))
    kvv = None if kv_valid is None else np.asarray(kv_valid, np.int32)
    got = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=q_offset,
        kv_valid=None if kvv is None else torch.from_numpy(kvv))
    want_pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, q_offset=q_offset,
                            kv_valid=None if kvv is None else jnp.asarray(kvv),
                            bq=32, bk=32, interpret=True)
    want_ref = ref.flash_attention(
        jnp.asarray(q).transpose(0, 2, 1, 3), jnp.asarray(k).transpose(
            0, 2, 1, 3), jnp.asarray(v).transpose(0, 2, 1, 3),
        causal=causal, q_offset=q_offset,
        kv_valid=None if kvv is None else jnp.asarray(kvv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        want_ref).transpose(0, 2, 1, 3), **TOL)
    if kv_valid is not None and 0 in kv_valid:
        assert not got[kv_valid.index(0)].any()     # no live key -> 0


def _flash_bf16_tensor_core_emulation(q, k, v, *, causal, kv_valid,
                                      bk=64):
    """The arithmetic of the bf16 kernel in ``csrc/flash_attention.cu``, in
    torch on the CPU: bf16 q, k, v; S = Q K^T exact products summed in fp32;
    masks as the TPU kernel's; an online softmax over 64-key tiles in the
    log2 domain; P in fp32 for the denominator and rounded to bf16 for the
    PV product, which accumulates in fp32; the output rounded to bf16."""
    b, h, sq, dh = q.shape
    g = h // k.shape[1]
    sk = k.shape[2]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scale_log2 = (1.0 / math.sqrt(dh)) * 1.4426950408889634
    qpos = torch.arange(sq)
    m = torch.full((b, h, sq, 1), NEG_INF)
    den = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, dh))
    for j0 in range(0, sk, bk):
        kpos = torch.arange(j0, min(j0 + bk, sk))
        s = q.float() @ kf[:, :, j0:j0 + bk].transpose(-1, -2)
        ok = (kpos[None, :] < kv_valid[:, None])[:, None, None, :]
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])[None, None]
        s = torch.where(ok, s * scale_log2, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new), 0.0)
        den = den * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, j0:j0 + bk]
        m = m_new
    return (acc / den.clamp_min(1e-20)).to(torch.bfloat16)


def test_flash_bf16_tensor_core_rounding_meets_card_tolerance():
    """bf16 at Sk = 512, Dh = 64, G = 2, ragged kv_valid with a 0 row: the
    tensor-core kernel's rounding against the plain version (fp32 math on
    the bf16 inputs) and the Pallas kernel in interpret mode.  The card
    holds the kernel to the plain version at rtol = atol = 3e-2
    (``chip_smoke.py``); observed here: max |emulated - plain| 7.8e-3,
    max |emulated - Pallas| 7.8e-3 (one bf16 ulp in [1, 2); max |out| is
    2.7, and plain and Pallas differ by 9.8e-4), so the tolerance is met
    with a factor of ~4 to spare."""
    rng = np.random.default_rng(15)
    b, h, kvh, s, dh = 3, 2, 1, 512, 64
    q, k, v = (torch.from_numpy(_normal(rng, b, n, s, dh)).to(torch.bfloat16)
               for n in (h, kvh, kvh))
    kvv = torch.tensor([512, 301, 0], dtype=torch.int32)
    got = _flash_bf16_tensor_core_emulation(q, k, v, causal=True,
                                            kv_valid=kvv)
    plain = flash_attention_plain(q, k, v, causal=True, kv_valid=kvv)
    pallas = jax_flash(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                         for t in (q, k, v)),
                       causal=True, kv_valid=jnp.asarray(kvv.numpy()),
                       bq=32, bk=32, interpret=True)
    pallas = torch.from_numpy(np.array(pallas.astype(jnp.float32)))
    for want in (plain.float(), pallas):
        torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
        assert (got.float() - want).abs().max().item() <= 1e-2
    assert not got[2].float().any()                 # no live key -> 0


def test_flash_wrapper_takes_strided_bshd_views_on_cpu():
    """The model hands BSHD tensors transposed to BHSD; the wrapper accepts
    the views and, for CPU tensors, returns exactly the plain result."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_normal(rng, 2, 20, 4, 16))       # [B,S,H,Dh]
    k = torch.from_numpy(_normal(rng, 2, 20, 2, 16))
    v = torch.from_numpy(_normal(rng, 2, 20, 2, 16))
    lens = torch.tensor([20, 9], dtype=torch.int32)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = flash_attention_bhsd(qt, kt, vt, kv_valid=lens)
    want = flash_attention_plain(qt.contiguous(), kt.contiguous(),
                                 vt.contiguous(), kv_valid=lens)
    assert torch.equal(got, want)


def test_flash_wrapper_rejects_what_it_does_not_take():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(TypeError):
        flash_attention_bhsd(q, k.double(), k.double())
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_bhsd(q, torch.zeros(1, 3, 8, 16),
                             torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="kv_valid"):
        flash_attention_bhsd(q, k, k, kv_valid=torch.tensor([8]))  # int64
    # a tensor that is neither on the CPU nor on a card never reaches the
    # plain version: no silent fallback
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention_bhsd(q.to("meta"), k.to("meta"), k.to("meta"))


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def _paged_case(rng, lens, kvh, g, dh, ps, np_w):
    """Random pool, shuffled (non-contiguous) page ids per row, in-range
    garbage in the table entries past each row's live pages."""
    b = len(lens)
    p_total = b * np_w + 1
    ids = rng.permutation(np.arange(1, p_total))[:b * np_w].reshape(b, np_w)
    for i, n in enumerate(lens):
        live = -(-n // ps)
        ids[i, live:] = rng.integers(0, p_total, np_w - live)
    return (_normal(rng, b, kvh, g, dh), _normal(rng, p_total, ps, kvh, dh),
            _normal(rng, p_total, ps, kvh, dh), ids.astype(np.int32),
            np.asarray(lens, np.int32), _normal(rng, b, kvh, dh),
            _normal(rng, b, kvh, dh))


PAGED_CASES = [
    # lens, kvh, g, dh, ps, np_w
    ([0, 1, 10, 28], 2, 7, 16, 8, 4),    # empty, one token, partial, multi
    ([16, 3, 9], 1, 7, 8, 8, 3),         # exactly full pages; SMOKE heads
    ([5, 31, 0, 12], 2, 4, 16, 16, 2),
]


@pytest.mark.parametrize("lens,kvh,g,dh,ps,np_w", PAGED_CASES)
def test_paged_plain_matches_pallas(lens, kvh, g, dh, ps, np_w):
    rng = np.random.default_rng(sum(lens) + ps)
    args = _paged_case(rng, lens, kvh, g, dh, ps, np_w)
    got = paged_decode_plain(*(torch.from_numpy(a) for a in args))
    want = jax_paged(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the reference oracle, in the model layout
    q4, kp, vp, pt, ln, kn, vn = args
    b, _, _, _ = q4.shape
    live = np.arange(np_w)[None, :] * ps < ln[:, None]
    oracle = ref.paged_decode(
        jnp.asarray(q4.reshape(b, 1, kvh * g, dh)), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(np.where(live, pt, 0)), jnp.asarray(ln),
        jnp.asarray(kn[:, None]), jnp.asarray(vn[:, None]))
    np.testing.assert_allclose(got.numpy().reshape(b, 1, kvh * g, dh),
                               np.asarray(oracle), **TOL)
    for i, n in enumerate(lens):
        if n == 0:                         # an empty row outputs v_new
            np.testing.assert_allclose(
                got[i].numpy(), np.broadcast_to(vn[i][:, None], (kvh, g, dh)),
                **TOL)


def test_paged_wrapper_dispatches_cpu_and_validates():
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a) for a in
            _paged_case(rng, [3, 7], 2, 4, 16, 4, 3)]
    assert torch.equal(paged_decode_attention_grouped(*args),
                       paged_decode_plain(*args))
    bad = list(args)
    bad[3] = bad[3].long()                 # page table must be int32
    with pytest.raises(TypeError, match="int32"):
        paged_decode_attention_grouped(*bad)
    bad = list(args)
    bad[5] = bad[5][:1]                    # k_new of the wrong batch
    with pytest.raises(ValueError, match="k_new"):
        paged_decode_attention_grouped(*bad)
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_decode_attention_grouped(*(a.to("meta") for a in args))


def test_paged_fp32_pages_under_bf16_query_match_pallas():
    """``kv_dtype="fp32"`` on a bf16 model: the pages stay fp32 while q and
    k_new/v_new are bf16; both versions cast every load to fp32."""
    rng = np.random.default_rng(21)
    q4, kp, vp, pt, ln, kn, vn = _paged_case(rng, [0, 1, 10, 28], 2, 7, 16,
                                             8, 4)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q4, kn, vn)]
    args = (bf[0], torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(pt), torch.from_numpy(ln), bf[1], bf[2])
    got = paged_decode_attention_grouped(*args)
    assert got.dtype == torch.bfloat16
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf]
    want = jax_paged(jb[0], jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
                     jnp.asarray(ln), jb[1], jb[2], interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# int8 paged decode
# ---------------------------------------------------------------------------

def _q8_case(rng, lens, kvh, g, dh, ps, np_w):
    """int8 codes and [P,ps] scales in place of fp pages (the scales of
    ``tests/test_prefix_cache.py``), the rest as :func:`_paged_case`."""
    q4, _, _, pt, ln, kn, vn = _paged_case(rng, lens, kvh, g, dh, ps, np_w)
    p_total = len(lens) * np_w + 1
    kp, vp = (rng.integers(-127, 128, (p_total, ps, kvh, dh)).astype(np.int8)
              for _ in range(2))
    ksc, vsc = (rng.uniform(0.005, 0.05, (p_total, ps)).astype(np.float32)
                for _ in range(2))
    return q4, kp, vp, ksc, vsc, pt, ln, kn, vn


Q8_CASES = [
    # lens, kvh, g, dh, ps, np_w
    ([0, 1, 10, 28], 2, 7, 16, 8, 4),    # empty, one token, partial, multi
    ([16, 3, 9], 1, 7, 8, 8, 3),         # full pages; SMOKE's heads
    ([5, 31, 0, 12], 2, 4, 16, 16, 2),
    ([33, 64, 1], 2, 7, 64, 16, 5),      # qwen2-0.5b's head dim
]


@pytest.mark.parametrize("lens,kvh,g,dh,ps,np_w", Q8_CASES)
def test_paged_q8_plain_matches_pallas_and_oracle(lens, kvh, g, dh, ps, np_w):
    rng = np.random.default_rng(sum(lens) + 7 * ps + dh)
    args = _q8_case(rng, lens, kvh, g, dh, ps, np_w)
    q4, kp, vp, ksc, vsc, pt, ln, kn, vn = args
    got = paged_decode_q8_plain(*(torch.from_numpy(a) for a in args))
    want = jax_paged_q8(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the quantized oracle, in the model layout, over the live pages only
    b = len(lens)
    live = np.arange(np_w)[None, :] * ps < ln[:, None]
    oracle = ref.paged_decode_q8(
        jnp.asarray(q4.reshape(b, 1, kvh * g, dh)), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(np.where(live, pt, 0)), jnp.asarray(ln),
        jnp.asarray(kn[:, None]), jnp.asarray(vn[:, None]),
        k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
    np.testing.assert_allclose(got.numpy().reshape(b, 1, kvh * g, dh),
                               np.asarray(oracle), **TOL)
    for i, n in enumerate(lens):
        if n == 0:                         # an empty row outputs v_new
            np.testing.assert_allclose(
                got[i].numpy(), np.broadcast_to(vn[i][:, None], (kvh, g, dh)),
                **TOL)


def test_paged_q8_wrapper_dispatches_cpu_and_validates():
    rng = np.random.default_rng(6)
    args = [torch.from_numpy(a) for a in
            _q8_case(rng, [3, 7], 2, 4, 16, 4, 3)]
    assert torch.equal(paged_decode_attention_q8_grouped(*args),
                       paged_decode_q8_plain(*args))
    bad = list(args)
    bad[1] = bad[1].float()                # fp pages are the fp kernel's
    with pytest.raises(TypeError, match="int8"):
        paged_decode_attention_q8_grouped(*bad)
    bad = list(args)
    bad[3] = bad[3][:, :2]                 # scales must be [P, ps]
    with pytest.raises(ValueError, match="k_scale"):
        paged_decode_attention_q8_grouped(*bad)
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_decode_attention_q8_grouped(*(a.to("meta") for a in args))
    fp = [args[0], args[1], args[2], *args[5:]]
    with pytest.raises(TypeError, match="pages"):   # int8 into the fp kernel
        paged_decode_attention_grouped(*fp)


# (b, kvh, np_w) -> CTAs a row: the portable cluster of 8 when the launch
# has few rows, fewer when the table is narrower or the launch would pass
# one wave of ~132 CTAs
Q8_PLANS = [(8, 2, 34, 8), (8, 2, 64, 8), (1, 1, 1, 1), (3, 2, 5, 5),
            (32, 2, 64, 3), (64, 2, 64, 2), (66, 2, 64, 1), (200, 8, 64, 1)]


def q8_page_range(rank, split, n_pages):
    """The live pages ``[j0, j1)`` that CTA ``rank`` of a row's ``split``
    takes (``csrc/paged_split.cuh::page_range``, computed on the device
    from ``lengths``)."""
    return rank * n_pages // split, (rank + 1) * n_pages // split


@pytest.mark.parametrize("b,kvh,np_w,split", Q8_PLANS)
def test_q8_split_plan_reads_only_shapes(b, kvh, np_w, split):
    # the plan (both paged kernels') takes shapes and nothing else:
    # lengths live on the card
    assert list(inspect.signature(split_plan).parameters) == \
        ["b", "kvh", "np_w"]
    got = split_plan(b, kvh, np_w)
    assert got == split
    assert 1 <= got <= MAX_SPLIT == 8 and got <= np_w
    # every live-page count a row can have splits into consecutive ranges
    # that cover it, balanced to within one page
    for n in range(np_w + 1):
        ranges = [q8_page_range(r, got, n) for r in range(got)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))
        sizes = [j1 - j0 for j0, j1 in ranges]
        assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


def test_q8_smem_footprint_fits_every_shape_the_card_checks():
    # ring of 4 pages (codes + scales) and the partials of G heads
    assert q8_smem_bytes(16, 64, 7) == 4 * (2 * 16 * 64 + 128) + 4 * 7 * 66
    assert q8_smem_bytes(3, 16, 1) == 4 * (2 * 3 * 16 + 32) + 4 * 18
    # every shape the card checks fits 48 KB; pages of 32 at Dh 128 with
    # G = 32 do not (nor did they for the fp32-staging kernel before)
    for ps, dh, g in ((16, 64, 7), (16, 128, 32), (8, 64, 7), (32, 32, 4),
                      (32, 128, 7)):
        assert q8_smem_bytes(ps, dh, g) <= 48 * 1024
    assert q8_smem_bytes(32, 128, 32) > 48 * 1024


def _split_emulation(q4, k_rows, v_rows, ksc, vsc, pt, ln, kn, vn, split,
                     order_rng):
    """Both paged kernels' cluster split in fp32 numpy: CTA ``r`` of a row
    takes the live pages ``q8_page_range(r, split, n_pages)`` (``n_pages``
    from ``lengths``, at most the table's width) through the page table
    and keeps a partial (m, l, acc) per query head, the neutral (-2e38, 0,
    0) when its range is empty; rank 0 merges the partials in a random
    order, folds the new token in last and divides by max(l, 1e-20).
    ``k_rows``/``v_rows`` are the pages as fp32 (int8 codes, or fp pages
    cast as the kernel reads them) and ``ksc``/``vsc`` their ``[P,ps]``
    scales (ones for fp pages)."""
    q4, kn, vn = (a.astype(np.float32) for a in (q4, kn, vn))
    b, kvh, g, dh = q4.shape
    ps, np_w = k_rows.shape[1], pt.shape[1]
    neg = np.float32(NEG_INF)
    out = np.empty_like(q4)
    for bi in range(b):
        n_pages = min(-(-max(int(ln[bi]), 0) // ps), np_w)
        ranges = [q8_page_range(r, split, n_pages) for r in range(split)]
        for h in range(kvh):
            q = q4[bi, h] * np.float32(1.0 / math.sqrt(dh))      # [g, dh]
            parts = []
            for j0, j1 in ranges:
                m = np.full(g, neg, np.float32)
                l = np.zeros(g, np.float32)
                acc = np.zeros((g, dh), np.float32)
                for j in range(j0, j1):
                    assert j * ps < ln[bi]      # only live pages are read
                    page = pt[bi, j]
                    live = j * ps + np.arange(ps) < ln[bi]
                    s = (q @ k_rows[page, :, h].T) * ksc[page][None]
                    s = np.where(live[None], s, neg)            # [g, ps]
                    m_new = np.maximum(m, s.max(-1))
                    alpha = np.exp(m - m_new)
                    p = np.where(live[None], np.exp(s - m_new[:, None]), 0)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + (p * vsc[page][None]) \
                        @ v_rows[page, :, h]
                    m = m_new
                parts.append((m, l, acc))
            m = np.max([pm for pm, _, _ in parts], axis=0)
            l = np.zeros(g, np.float32)
            acc = np.zeros((g, dh), np.float32)
            for i in order_rng.permutation(split):    # any merge order
                pm, pl_, pa = parts[i]
                w = np.exp(pm - m)
                l = l + pl_ * w
                acc = acc + pa * w[:, None]
            s_t = q @ kn[bi, h]                                   # [g]
            m_new = np.maximum(m, s_t)
            alpha = np.exp(m - m_new)
            p_t = np.exp(s_t - m_new)
            den = np.maximum(l * alpha + p_t, np.float32(1e-20))
            out[bi, h] = (acc * alpha[:, None]
                          + p_t[:, None] * vn[bi, h][None]) / den[:, None]
    return out


Q8_SPLIT_CASES = [
    # lens, kvh, g, dh, ps, np_w: rows of 0 pages, 1 partial page, fewer
    # pages than the cluster and many more; tables far wider than the
    # live pages
    ([0, 3, 20, 70, 129], 2, 7, 16, 8, 40),
    ([0, 1, 64, 17], 1, 4, 64, 16, 24),
    ([5, 0, 33], 2, 3, 32, 4, 9),
]


@pytest.mark.parametrize("lens,kvh,g,dh,ps,np_w", Q8_SPLIT_CASES)
def test_q8_split_then_combine_matches_plain_and_pallas(lens, kvh, g, dh, ps,
                                                         np_w):
    rng = np.random.default_rng(sum(lens) * 3 + np_w)
    args = _q8_case(rng, lens, kvh, g, dh, ps, np_w)
    plain = paged_decode_q8_plain(*(torch.from_numpy(a) for a in args))
    pallas = np.asarray(jax_paged_q8(*(jnp.asarray(a) for a in args),
                                     interpret=True))
    # every split the plan can choose at this table width
    q4, kp, vp, ksc, vsc, pt, ln, kn, vn = args
    for split in range(1, min(MAX_SPLIT, np_w) + 1):
        got = _split_emulation(q4, kp.astype(np.float32),
                               vp.astype(np.float32), ksc, vsc, pt, ln, kn,
                               vn, split, rng)
        np.testing.assert_allclose(got, plain.numpy(), **TOL)
        np.testing.assert_allclose(got, pallas, **TOL)
        for i, n in enumerate(lens):
            if n == 0:                     # exactly v_new, every split
                np.testing.assert_array_equal(
                    got[i], np.broadcast_to(vn[i][:, None], (kvh, g, dh)))


def _bf16(a):
    """fp32 numpy rounded to bf16 and back, as the card stores it."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# the fp kernel's page dtype under each query dtype: bf16 pages under a
# bf16 model, fp32 under fp32, and kv_dtype="fp32" on a bf16 model
FP_PAGE_DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
                  ("bfloat16", "float32")]


@pytest.mark.parametrize("q_dtype,page_dtype", FP_PAGE_DTYPES)
@pytest.mark.parametrize("lens,kvh,g,dh,ps,np_w", Q8_SPLIT_CASES)
def test_fp_split_then_combine_matches_plain_and_pallas(lens, kvh, g, dh, ps,
                                                         np_w, q_dtype,
                                                         page_dtype):
    """The fp kernel's cluster split (``csrc/paged_decode.cu``): the same
    page ranges, partials and merge as the int8 kernel's, over K/V rows
    in the pages' dtype cast to fp32 as they are read (scales of 1)."""
    rng = np.random.default_rng(sum(lens) * 5 + np_w)
    q4, kp, vp, pt, ln, kn, vn = _paged_case(rng, lens, kvh, g, dh, ps, np_w)
    if q_dtype == "bfloat16":
        q4, kn, vn = _bf16(q4), _bf16(kn), _bf16(vn)
    if page_dtype == "bfloat16":
        kp, vp = _bf16(kp), _bf16(vp)
    tq = {"float32": torch.float32, "bfloat16": torch.bfloat16}[q_dtype]
    tp = {"float32": torch.float32, "bfloat16": torch.bfloat16}[page_dtype]
    jq = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[q_dtype]
    jp = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[page_dtype]
    targs = (torch.from_numpy(q4).to(tq), torch.from_numpy(kp).to(tp),
             torch.from_numpy(vp).to(tp), torch.from_numpy(pt),
             torch.from_numpy(ln), torch.from_numpy(kn).to(tq),
             torch.from_numpy(vn).to(tq))
    plain = paged_decode_attention_grouped(*targs)
    assert plain.dtype == tq
    pallas = jax_paged(jnp.asarray(q4).astype(jq), jnp.asarray(kp).astype(jp),
                       jnp.asarray(vp).astype(jp), jnp.asarray(pt),
                       jnp.asarray(ln), jnp.asarray(kn).astype(jq),
                       jnp.asarray(vn).astype(jq), interpret=True)
    pallas = np.asarray(pallas.astype(jnp.float32))
    ones = np.ones(kp.shape[:2], np.float32)
    # fp32 outputs at the fp32 tolerance; bf16 outputs one rounding apart
    tol = TOL if q_dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    for split in range(1, min(MAX_SPLIT, np_w) + 1):
        got = _split_emulation(q4, kp, vp, ones, ones, pt, ln, kn, vn, split,
                               rng)
        got = torch.from_numpy(got).to(tq).float().numpy()
        np.testing.assert_allclose(got, plain.float().numpy(), **tol)
        np.testing.assert_allclose(got, pallas, **tol)
        for i, n in enumerate(lens):
            if n == 0:                     # exactly v_new, every split
                np.testing.assert_array_equal(
                    got[i], np.broadcast_to(vn[i][:, None], (kvh, g, dh)))


def test_fp_smem_bytes_fit_every_shape_the_card_checks():
    # ring of 4 pages of K and V rows in the pages' dtype, then the
    # partials of G heads
    assert fp_smem_bytes(16, 64, 7, 2) == 4 * 2 * 16 * 64 * 2 + 4 * 7 * 66
    assert fp_smem_bytes(16, 128, 32, 4) == 4 * 2 * 16 * 128 * 4 \
        + 4 * 32 * 130
    # fp32 pages at Dh 128 pass the 48 KB a block has without the opt-in,
    # and every shape the card checks (pages of 8, 16 and 32 tokens, G up
    # to 32, fp32 or bf16 pages) fits the 227 KiB it may opt in to
    assert fp_smem_bytes(16, 128, 7, 4) > 48 * 1024
    for ps, dh, g in ((16, 64, 7), (16, 128, 32), (8, 64, 7), (32, 32, 4),
                      (16, 16, 7), (32, 128, 32)):
        for page_bytes in (2, 4):
            assert fp_smem_bytes(ps, dh, g, page_bytes) <= SMEM_PER_BLOCK
    assert fp_smem_bytes(128, 128, 32, 4) > SMEM_PER_BLOCK


# the fp cases chip_smoke.py checks: (lens, kvh, page size, table width)
FP_CARD_CASES = [
    ([n + 16 for n in (512, 384, 301, 256, 129, 64, 17, 1)], 2, 16, 34),
    ([600, 0, 5, 20, 47], 2, 16, 38), ([300, 1, 0, 65], 1, 16, 19),
    ([250, 7, 0, 40], 2, 8, 32), ([900, 33, 0, 64], 2, 32, 29),
    ([500, 16, 0, 3], 2, 16, 64)]


@pytest.mark.parametrize("lens,kvh,ps,np_w", FP_CARD_CASES)
def test_fp_split_plan_spreads_long_rows_over_the_cluster(lens, kvh, ps,
                                                          np_w):
    b = len(lens)
    split = split_plan(b, kvh, np_w)
    # one wave: under one CTA a row past the ~132 the launch aims at
    assert split == 1 or split * b * kvh < 132 + b * kvh
    if b * kvh <= 16:                 # few rows: the whole cluster each
        assert split == min(MAX_SPLIT, np_w)
    # the longest row's pages spread to within one page over the CTAs,
    # so no CTA walks more than ceil(n / S) of them
    n = min(-(-max(lens) // ps), np_w)
    sizes = [j1 - j0 for j0, j1 in
             (q8_page_range(r, split, n) for r in range(split))]
    assert sum(sizes) == n and max(sizes) == -(-n // split)
    assert split_plan(8, 2, 34) == 8            # 128 CTAs at the main shape


def test_quantize_kv_rows_codes_match_jax_bit_for_bit():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((5, 9, 2, 16)) * rng.uniform(
        0.01, 10.0, (5, 9, 1, 1))).astype(np.float32)
    # exact ties at the rounding boundary: amax 127 makes the scale 1.0, so
    # x.5 values must round half to even on both sides
    x[0, 0] = 0.0
    x[0, 0, 0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    x[0, 1] = 0.0                           # an all-zero row: eps scale
    codes, scale = quantize_kv_rows(torch.from_numpy(x))
    jcodes, jscale = jax_quantize(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=0,
                               atol=1e-7)
    assert codes[0, 0, 0, :6].tolist() == [127, 2, -4, 0, 0, 2]


# ---------------------------------------------------------------------------
# argmax
# ---------------------------------------------------------------------------

def _tied_logits(rng, b, v):
    x = rng.standard_normal((b, v)).astype(np.float32)
    x[0, [3, v - 40]] = 9.0             # equal maxima in different blocks
    x[1, :] = -np.inf                   # all -inf -> index 0
    x[2, [v - 2, v - 1]] = 9.0          # a tie at the row's end
    x[3] = np.round(x[3] * 2.0) / 2.0   # many ties below the max
    x[4, ::3] = 5.0                     # strided ties: index 0
    return x


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,v", [(8, 384), (5, 130), (6, 1000)])
def test_argmax_plain_matches_pallas_exactly(b, v, dtype):
    x = _tied_logits(np.random.default_rng(v + b), b, v)
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xj = xj.astype(jnp.bfloat16)
        xt = xt.to(torch.bfloat16)
    got = sampling.block_argmax(xt)
    want = jax_argmax(xj, block_rows=8, block_vocab=128, interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.argmax(xj, axis=-1)))


# (b, v) -> CTAs a row: 8 (the portable cluster) when the row is long and
# the batch small, fewer when a CTA would get under 4096 elements or the
# launch would pass ~2 CTAs per SM
ARGMAX_PLANS = [(1, 130, 1), (1, 32000, 8), (1, 151936, 8), (8, 130, 1),
                (8, 32000, 8), (8, 151936, 8), (64, 130, 1), (64, 32000, 5),
                (64, 151936, 5)]


@pytest.mark.parametrize("b,v,split", ARGMAX_PLANS)
def test_argmax_plan_splits_cover_the_row(b, v, split):
    got, chunk = sampling.argmax_plan(b, v)
    assert got == split
    assert 1 <= split <= sampling.ARGMAX_MAX_SPLIT
    assert chunk % 8 == 0                       # 16-byte splits of bf16
    bounds = [(r * chunk, min(v, (r + 1) * chunk)) for r in range(split)]
    assert all(lo < hi for lo, hi in bounds)    # every CTA non-empty
    assert bounds[0][0] == 0 and bounds[-1][1] == v
    assert all(a[1] == c[0] for a, c in zip(bounds, bounds[1:]))
    # the plan's rule: as many CTAs as the cluster, the 4096-element floor
    # a CTA and the ~264-CTA target allow (chunk rounding to 8 elements
    # never drops a CTA at these sizes)
    assert split == min(sampling.ARGMAX_MAX_SPLIT,
                        -(-v // sampling.ARGMAX_MIN_CHUNK),
                        -(-sampling.ARGMAX_TARGET_CTAS // b))


def _better(v1, i1, v2, i2):
    """``better()`` of ``csrc/argmax.cu``: NaN above numbers, then the
    larger value, then the lower index."""
    n1, n2 = np.isnan(v1), np.isnan(v2)
    if n1 or n2:
        return i1 < i2 if n1 and n2 else bool(n1)
    if v1 != v2:
        return v1 > v2
    return i1 < i2


def _split_argmax_emulation(x, offset, elem_bytes, order_rng):
    """The argmax kernel's split and combine on rows of ``x`` whose first
    element sits ``offset`` elements past a 16-byte boundary: per CTA the
    scalar head up to the boundary, 16-byte vectors, the scalar tail (which
    must tile the CTA's range exactly), its best candidate, then the
    cluster's combine in a random order."""
    b, v = x.shape
    vec = 16 // elem_bytes
    split, chunk = sampling.argmax_plan(b, v)
    out = []
    for row in x:
        cands = []
        for r in range(split):
            lo, hi = r * chunk, min(v, (r + 1) * chunk)
            mis = (offset + lo) % vec
            body = min(hi, lo + (vec - mis if mis else 0))
            nvec = (hi - body) // vec
            tail = body + nvec * vec
            head_i = list(range(lo, body))
            body_i = list(range(body, tail))
            tail_i = list(range(tail, hi))
            assert (offset + body) % vec == 0 or body == hi
            assert len(tail_i) < vec and len(head_i) < vec
            seen = np.asarray(head_i + body_i + tail_i)
            assert np.array_equal(seen, np.arange(lo, hi))
            best = (-np.inf, np.iinfo(np.int32).max)
            for i in order_rng.permutation(seen):     # any visiting order
                if _better(row[i], i, *best):
                    best = (row[i], i)
            cands.append(best)
        best = (-np.inf, np.iinfo(np.int32).max)
        for c in (cands[i] for i in order_rng.permutation(split)):
            if _better(*c, *best):
                best = c
        out.append(best[1])
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,v,offset", [(5, 32000, 0), (5, 32000, 1),
                                        (10, 130, 3), (5, 151936, 1),
                                        (64, 4200, 0)])
def test_argmax_split_then_combine_matches_jnp(b, v, offset, dtype):
    rng = np.random.default_rng(b * v + offset)
    x = sampling.argmax_boundary_logits(rng, b, v)
    xj = jnp.asarray(x)
    if dtype == "bfloat16":
        xj = xj.astype(jnp.bfloat16)
    want = np.asarray(jnp.argmax(xj, axis=-1))
    vals = np.asarray(xj.astype(jnp.float32))
    got = _split_argmax_emulation(vals, offset,
                                  2 if dtype == "bfloat16" else 4, rng)
    np.testing.assert_array_equal(got, want)


def test_argmax_over_a_row_with_nan_follows_jnp_not_the_pallas_kernel():
    """A recorded departure: the Pallas kernel drops every 128-column
    block that holds a NaN (``jnp.max`` is NaN there, ``x == NaN`` matches
    nothing and ``NaN > cur`` is false), so it disagrees with its own
    family oracle, ``jnp.argmax``; the port follows ``jnp.argmax`` and
    ``torch.argmax``: the first NaN wins."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((8, 300)).astype(np.float32)
    x[:, 200] = 50.0                       # the max, in block 1
    x[0, 5] = np.nan                       # a NaN in block 0
    x[1, 250] = np.nan                     # a NaN in the max's block
    got = sampling.block_argmax(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1))
    pallas = np.asarray(jax_argmax(jnp.asarray(x), block_rows=8,
                                   block_vocab=128, interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 5 and got[1] == 250
    assert pallas[0] == 200                # block 0 dropped: the max wins
    assert pallas[1] not in (200, 250)     # block 1 dropped with the max
    np.testing.assert_array_equal(pallas[2:], want[2:])


def test_sample_greedy_and_unported_methods():
    x = torch.from_numpy(_tied_logits(np.random.default_rng(1), 5, 64))
    assert torch.equal(sampling.sample(x), sampling.argmax_plain(x))
    # top_k / top_p are ported: a Gumbel draw, then the argmax kernel
    y = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, 64)).astype(np.float32))
    top3 = torch.topk(y, 3, dim=-1).indices
    for method in ("top_k", "top_p"):
        gen = torch.Generator().manual_seed(4)
        tok = sampling.sample(y, gen, method=method, temperature=0.8, k=3,
                              p=0.5)
        assert tok.dtype == torch.int32 and tok.shape == (5,)
        if method == "top_k":
            assert all(int(t) in top3[i].tolist() for i, t in enumerate(tok))
        with pytest.raises(ValueError, match="generator"):
            sampling.sample(x, method=method)
    with pytest.raises(ValueError, match="unknown sampling method"):
        sampling.sample(x, torch.Generator(), method="beam")
    with pytest.raises(ValueError):
        sampling.block_argmax(torch.zeros(3, 0))
    with pytest.raises(TypeError):
        sampling.block_argmax(torch.zeros(3, 4, dtype=torch.float64))


# ---------------------------------------------------------------------------
# the build helper (no nvcc runs here)
# ---------------------------------------------------------------------------

def test_build_paths_are_content_keyed_and_under_build_dir():
    root = _build.CSRC.parents[2]
    assert _build.build_dir() == root / "build" / "repro_torch"
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        so = _build._so_path(name)
        assert so.parent == _build.build_dir()
        assert so.name.startswith(f"{name}-") and so.suffix == ".so"
        assert so == _build._so_path(name)          # stable hash
    assert len({_build._so_path(n) for n in _build.SOURCES}) == \
        len(_build.SOURCES) == 7
