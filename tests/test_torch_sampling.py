"""The port's sampled decoding against the JAX package, on the CPU.

``filtered_logits`` is held to the reference's on the same seeded logits
(the same ``-inf`` mask exactly, finite values within 1e-6).  Sampled
tokens cannot be compared token for token: the port draws its Gumbel
shift from a ``torch.Generator`` and JAX from threefry.  So they are held
to the reference in distribution (20000 seeded draws over a 16-wide row
against ``softmax(filtered_logits)`` from the reference, by chi-square)
and, inside the port, to themselves: ``generate``, ``generate_reference``
and streaming return the same tokens under one seed, on the dense
(qwen2-0.5b ``SMOKE``, JAX params bridged over, ragged prompts) and the
hybrid (zamba2-1.2b ``SMOKE``, equal lengths) families.  Also: greedy
ignores the generator, the Gumbel draw never reaches ``u = 0``, and
``Engine.instrument`` fills the ``serve.prefill`` / ``serve.decode``
regions, which accumulate over ``generate`` calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen2_0_5b import SMOKE as JAX_SMOKE
from repro.configs.zamba2_1_2b import SMOKE as JAX_ZAMBA_SMOKE
from repro.core.features import default_features
from repro.kernels import sampling as jax_sampling
from repro.models.lm import LM as JaxLM
from repro_torch.bridge import params_from_jax
from repro_torch.configs.qwen2_0_5b import SMOKE
from repro_torch.configs.zamba2_1_2b import SMOKE as ZAMBA_SMOKE
from repro_torch.core.perfctr import PerfCtr
from repro_torch.kernels import sampling
from repro_torch.models.lm import LM
from repro_torch.serve.engine import (DECODE_REGION, PREFILL_REGION, Engine,
                                      ServeConfig)

torch.set_num_threads(1)

MAX_NEW = 8
#: the 0.999 quantile of chi-square at 15 degrees of freedom (a 16-wide
#: row); fewer kept cells have smaller quantiles, so this bound is loose
#: for them and exact at full width
CHI2_999_DF15 = 37.70
DRAWS = 20000


def _logits(seed, b=6, v=64):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(
        np.float32) * 2.0


FILTERS = [dict(temperature=0.7), dict(k=5), dict(p=0.8),
           dict(temperature=0.7, k=9, p=0.6), dict(k=1), dict(p=0.05),
           dict(k=100, p=1.0)]


@pytest.mark.parametrize("kw", FILTERS, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_filtered_logits_matches_the_reference(kw):
    x = _logits(0)
    got = sampling.filtered_logits(torch.from_numpy(x), **kw).numpy()
    want = np.asarray(jax_sampling.filtered_logits(jnp.asarray(x), **kw))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)
    assert fin.any(axis=1).all()                 # every row keeps a token


def test_defaults_are_exact_no_ops():
    x = torch.from_numpy(_logits(1))
    assert sampling.filtered_logits(x) is x
    assert torch.equal(sampling.filtered_logits(x, k=0, p=1.0), x)


def test_topk_and_topp_tokens_stay_in_the_set():
    x = _logits(2)
    xt = torch.from_numpy(x)
    top = np.asarray(jax.lax.top_k(jnp.asarray(x), 4)[1])
    nucleus = np.isfinite(np.asarray(
        jax_sampling.filtered_logits(jnp.asarray(x), p=0.5)))
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        tk = sampling.sample(xt, gen, method="top_k", k=4).numpy()
        tp = sampling.sample(xt, gen, method="top_p", p=0.5).numpy()
        for row in range(x.shape[0]):
            assert tk[row] in top[row]
            assert nucleus[row, tp[row]]


@pytest.mark.parametrize("method,kw", [("top_p", dict(p=1.0)),
                                       ("top_k", dict(k=6)),
                                       ("top_p", dict(p=0.7))])
def test_seeded_marginal_matches_the_reference_softmax(method, kw):
    """20000 draws of one 16-wide row (a batch of copies, one draw each)
    against ``softmax(filtered_logits)`` of the reference: cells the filter
    drops are never drawn, and the kept cells pass a chi-square test at
    the 0.999 quantile."""
    row = _logits(3, b=1, v=16)
    t = 0.8
    want = np.asarray(jax.nn.softmax(jax_sampling.filtered_logits(
        jnp.asarray(row), temperature=t, **kw), axis=-1))[0]
    batch = torch.from_numpy(np.repeat(row, DRAWS, axis=0))
    gen = torch.Generator().manual_seed(11)
    tok = sampling.sample(batch, gen, method=method, temperature=t, **kw)
    counts = np.bincount(tok.numpy(), minlength=16)
    assert counts[want == 0].sum() == 0
    kept = want > 0
    expect = want[kept] * DRAWS
    chi2 = float(((counts[kept] - expect) ** 2 / expect).sum())
    assert chi2 < CHI2_999_DF15, (chi2, counts, want)
    # the plain version draws the same tokens from the same stream
    gen = torch.Generator().manual_seed(11)
    ref = sampling.sample_ref(batch, gen, method=method, temperature=t, **kw)
    assert torch.equal(ref, tok)


def test_greedy_ignores_the_generator():
    x = torch.from_numpy(_logits(4))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    want = torch.argmax(x, dim=-1).to(torch.int32)
    assert torch.equal(sampling.sample(x, gen), want)
    assert torch.equal(sampling.sample(x), want)
    assert torch.equal(gen.get_state(), state)         # no draw taken


def test_gumbel_draw_stays_off_zero(monkeypatch):
    """``u`` lives on ``[finfo.tiny, 1)``: even a stream of zeros shifts
    by a finite amount (a 0 would give ``+inf`` and fix the token)."""
    real_rand = torch.rand

    def zeros(*shape, **kw):
        kw.pop("generator", None)
        return torch.zeros(*shape, **kw)

    monkeypatch.setattr(torch, "rand", zeros)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros((2, 8), dtype=dtype)
        shifted = sampling.gumbel_shift(x, torch.Generator())
        assert torch.isfinite(shifted).all() and shifted.dtype == dtype
    monkeypatch.setattr(torch, "rand", real_rand)
    # a row with -inf entries keeps them -inf and the finite ones finite
    x = torch.tensor([[0.0, -torch.inf, 1.0, -torch.inf]])
    s = sampling.gumbel_shift(x, torch.Generator().manual_seed(1))
    assert torch.equal(torch.isfinite(s), torch.isfinite(x))
    assert int(sampling.block_argmax(s)[0]) in (0, 2)


# ---------------------------------------------------------------------------
# the engine's three static-batch loops
# ---------------------------------------------------------------------------

def _bridged(jcfg, cfg):
    jlm = JaxLM(jcfg, default_features().with_(remat_policy="none"),
                dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * 0.1
    lm = LM(cfg, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, cfg))
    return lm


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, SMOKE.vocab, n).tolist() for n in (9, 3, 6)]
    return _bridged(JAX_SMOKE, SMOKE), prompts, dict(page_size=4)


@pytest.fixture(scope="module")
def hybrid():
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, ZAMBA_SMOKE.vocab, 20).tolist()
               for _ in range(3)]
    return _bridged(JAX_ZAMBA_SMOKE, ZAMBA_SMOKE), prompts, {}


@pytest.mark.parametrize("family", ["dense", "hybrid"])
@pytest.mark.parametrize("filt", [dict(top_k=20), dict(top_p=0.9)],
                         ids=["top_k", "top_p"])
def test_generate_reference_and_streaming_agree(family, filt, request):
    lm, prompts, extra = request.getfixturevalue(family)
    sc = ServeConfig(max_seq=64, temperature=0.7, seed=3, **extra, **filt)
    eng = Engine(lm, sc, device="cpu")
    fused = eng.generate(prompts, MAX_NEW)
    assert eng.host_syncs == 1
    ref = eng.generate_reference(prompts, MAX_NEW)
    assert eng.host_syncs == 1 + MAX_NEW             # one sync a token
    events = []
    streamed = eng.generate(prompts, MAX_NEW, stream_cb=lambda i, t, d:
                            events.append((i, list(t), d)))
    assert fused == ref == streamed
    assert [len(t) for t in fused] == [MAX_NEW] * len(prompts)
    assert len(events) == MAX_NEW * len(prompts)      # one per row per token
    assert all(d for i, t, d in events[-len(prompts):])
    # the same seed gives the same tokens, another seed other tokens
    assert Engine(lm, sc, device="cpu").generate(prompts, MAX_NEW) == fused
    other = Engine(lm, ServeConfig(max_seq=64, temperature=0.7, seed=4,
                                   **extra, **filt), device="cpu")
    assert other.generate(prompts, MAX_NEW) != fused
    # sampled tokens are not the greedy ones
    assert Engine(lm, ServeConfig(max_seq=64, **extra),
                  device="cpu").generate(prompts, MAX_NEW) != fused


def test_sampled_eos_stops_rows_alike_in_every_loop(dense):
    lm, prompts, extra = dense
    sc = dict(max_seq=64, temperature=0.7, top_p=0.9, seed=3, **extra)
    base = Engine(lm, ServeConfig(**sc), device="cpu").generate(prompts,
                                                                 MAX_NEW)
    eos = base[0][2]
    eng = Engine(lm, ServeConfig(eos_token=eos, **sc), device="cpu")
    got = eng.generate(prompts, MAX_NEW)
    assert got == eng.generate_reference(prompts, MAX_NEW)
    assert got == eng.generate(prompts, MAX_NEW, stream_cb=lambda *a: None)
    for row, full in zip(got, base):
        assert row == (full[:full.index(eos) + 1] if eos in full else full)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_instrument_fills_regions_that_accumulate(family, request):
    lm, prompts, extra = request.getfixturevalue(family)
    eng = Engine(lm, ServeConfig(max_seq=64, batch_slots=2, **extra),
                 device="cpu")
    want = eng.generate(prompts, MAX_NEW)
    ctr = PerfCtr(device="cpu")
    eng.instrument(ctr, prompt_len=5)
    regions = ctr.regions
    assert set(regions) == {PREFILL_REGION, DECODE_REGION}
    assert regions[PREFILL_REGION].calls == regions[DECODE_REGION].calls == 1
    for n in (2, 3):
        assert eng.generate(prompts, MAX_NEW) == want   # no state left
        assert regions[PREFILL_REGION].calls == n
        assert regions[DECODE_REGION].calls == n
    eng.generate_reference(prompts, MAX_NEW)
    assert regions[DECODE_REGION].calls == 4
    assert all(r.time_s > 0 for r in regions.values())
    assert "serve.decode" in ctr.report()
