"""The port's speculative decoding against the JAX package, on the CPU.

Mirrors ``tests/test_spec.py`` at its sizes (a 2-layer target, a 1-layer
draft, vocab 256, fp32; JAX ``LM.init`` parameters bridged over):

* ``SpecConfig.validate`` and ``launch/cli.py::spec_kwargs`` refuse the
  reference's bad pairings with its messages;
* greedy ``accept_speculative`` equals the reference's exactly; the
  rejection policy's carries equal the reference's within 1e-6 where the
  outcome does not hang on a draw (acceptance certain, ``p >= q``, or
  impossible, ``p_tok = 0``), ``spec_mask=False`` forces ``a = 0`` and
  carries ``p_0``, and the first emitted token is distributed as the
  target softmax;
* fp32 greedy speculative tokens (fused, streamed, a mixed spec/non-spec
  scheduler batch) equal the port's target-only tokens and the JAX
  engine's greedy tokens.  Streaming uses a *matched* draft (the target's
  first block, embedding, norm and head, with the target's upper blocks
  zeroed, as ``benchmarks/bench_spec.py`` builds one), so acceptance is
  above zero and blockwise delivery (fewer callback waves than tokens) is
  actually tested; an independent draft must give the same tokens too;
* cancel and expire on spec rows leave ``KVPool.check()`` and
  ``scheduler.check()`` closed, and the launcher's ``--draft`` summary.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.features import default_features
from repro.models.lm import LM as JaxLM
from repro.models.lm import LMConfig as JaxLMConfig
from repro.serve import Engine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve.spec import accept_speculative as jax_accept
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import sampling
from repro_torch.launch import cli
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                      ServeConfig)
from repro_torch.serve.spec import SpecConfig, accept_speculative

torch.set_num_threads(1)

TKW = dict(name="spec-t", family="dense", vocab=256, d_model=64,
           n_layers=2, num_heads=8, num_kv_heads=4, d_ff=128)
DKW = dict(name="spec-d", family="dense", vocab=256, d_model=32,
           n_layers=1, num_heads=4, num_kv_heads=2, d_ff=64)
TCFG, DCFG = LMConfig(**TKW), LMConfig(**DKW)
MCFG = dataclasses.replace(TCFG, name="spec-matched-d", n_layers=1)
SCFG = ServeConfig(max_seq=128, batch_slots=4, temperature=0.0,
                   page_size=16, admission_chunk=8)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7],
           [11, 12, 13, 14, 15, 16, 17, 18]]
MAX_NEW = 24
K = 4


def _jax_init(kw, seed):
    jlm = JaxLM(JaxLMConfig(**kw), default_features().with_(
        remat_policy="none"), dtype=jnp.float32)
    return jlm, jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(seed)))


def _port(cfg, np_params):
    lm = LM(cfg, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(np_params, cfg))
    return lm


@pytest.fixture(scope="module")
def models():
    jlm, tp = _jax_init(TKW, 0)
    _, dp = _jax_init(DKW, 1)
    return jlm, tp, _port(TCFG, tp), _port(DCFG, dp)


@pytest.fixture(scope="module")
def ref_tokens(models):
    jlm, tp, _, _ = models
    want = JaxEngine(jlm, jax.tree.map(jnp.asarray, tp), JaxServeConfig(
        max_seq=128, batch_slots=4, page_size=16)).generate(PROMPTS, MAX_NEW)
    return want


@pytest.fixture(scope="module")
def base_engine(models):
    return Engine(models[2], SCFG, device="cpu")


@pytest.fixture(scope="module")
def spec_engine(models):
    _, _, lm, dlm = models
    return Engine(lm, SCFG, device="cpu",
                  spec=SpecConfig(draft_config=DCFG, num_draft_tokens=K),
                  draft_lm=dlm)


@pytest.fixture(scope="module")
def matched():
    """A target whose blocks past the first are zero (its logits ARE the
    one-block computation) and the draft of that block plus the shared
    embedding, norm and head (``benchmarks/bench_spec.py:55-70``)."""
    _, tp = _jax_init(TKW, 0)
    tp = dict(tp, blocks=jax.tree.map(
        lambda a: np.concatenate([a[:1], np.zeros_like(a[1:])]),
        tp["blocks"]))
    _, dp = _jax_init(dict(TKW, name="spec-matched-d", n_layers=1), 1)
    dp = dict(dp, embed=tp["embed"], final_norm=tp["final_norm"],
              lm_head=tp["lm_head"],
              blocks=jax.tree.map(lambda a: a[:1], tp["blocks"]))
    return _port(TCFG, tp), _port(MCFG, dp)


# ---------------------------------------------------------------------------
# greedy parity: fused / streaming / scheduler
# ---------------------------------------------------------------------------

def test_fused_greedy_parity(spec_engine, base_engine, ref_tokens):
    target_only = base_engine.generate(PROMPTS, MAX_NEW)
    assert target_only == ref_tokens                  # the JAX engine's
    syncs0 = spec_engine.host_syncs
    out = spec_engine.generate(PROMPTS, MAX_NEW)
    assert out == ref_tokens
    stats = spec_engine.spec_stats
    assert stats["proposed"] > 0 and 0.0 <= stats["accept_rate"] <= 1.0
    # ceil(max_new / (K+1)) rounds run blind, then one read a round; the
    # last read carries the tokens
    blind = -(-MAX_NEW // (K + 1))
    assert stats["rounds"] >= blind
    assert spec_engine.host_syncs - syncs0 == stats["rounds"] - blind + 1


def test_streaming_with_the_matched_draft_is_blockwise(matched):
    lm, dlm = matched
    want = Engine(lm, SCFG, device="cpu").generate(PROMPTS, MAX_NEW)
    eng = Engine(lm, SCFG, device="cpu",
                 spec=SpecConfig(draft_config=MCFG, num_draft_tokens=K),
                 draft_lm=dlm)
    assert eng.generate(PROMPTS, MAX_NEW) == want
    assert eng.spec_stats["accept_rate"] > 0.5
    events = []
    syncs0 = eng.host_syncs
    out = eng.generate(PROMPTS, MAX_NEW, stream_cb=lambda i, toks, done:
                       events.append((i, list(toks), done)))
    assert out == want
    rebuilt = [[] for _ in PROMPTS]
    for i, toks, _done in events:
        rebuilt[i].extend(toks)
    assert rebuilt == want
    # blockwise: rows stream up to K+1 tokens a round, so there are
    # strictly fewer callback waves than tokens, and one sync a round
    assert len(events) < sum(len(t) for t in want)
    assert eng.host_syncs - syncs0 == eng.spec_stats["rounds"]
    last = {i: done for i, _t, done in events}
    assert all(last[i] for i in range(len(PROMPTS)))


def test_streaming_with_an_independent_draft(spec_engine, ref_tokens):
    events = []
    out = spec_engine.generate(PROMPTS, MAX_NEW, stream_cb=lambda i, t, d:
                               events.append((i, list(t), d)))
    assert out == ref_tokens
    rebuilt = [[] for _ in PROMPTS]
    for i, toks, _done in events:
        rebuilt[i].extend(toks)
    assert rebuilt == ref_tokens


def test_eos_stops_spec_rows_through_the_first_eos(spec_engine, models):
    _, _, lm, dlm = models
    base = spec_engine.generate(PROMPTS, MAX_NEW)
    eos = base[1][5]
    sc = dataclasses.replace(SCFG, eos_token=eos)
    eng = Engine(lm, sc, device="cpu", spec=spec_engine.spec, draft_lm=dlm)
    got = eng.generate(PROMPTS, MAX_NEW)
    assert got == Engine(lm, sc, device="cpu").generate(PROMPTS, MAX_NEW)
    assert got == eng.generate(PROMPTS, MAX_NEW, stream_cb=lambda *a: None)
    for row, full in zip(got, base):
        assert row == (full[:full.index(eos) + 1] if eos in full else full)


def _mixed_requests():
    return [Request(rid=0, prompt=[1, 2, 3], max_new_tokens=17, spec=True),
            Request(rid=1, prompt=[5, 6, 7, 8, 9], max_new_tokens=11,
                    spec=False),
            Request(rid=2, prompt=[9, 8], max_new_tokens=23, spec=True),
            Request(rid=3, prompt=[4] * 12, max_new_tokens=9, spec=True),
            Request(rid=4, prompt=[17, 3, 2, 11], max_new_tokens=19,
                    spec=False),
            Request(rid=5, prompt=[30, 31], max_new_tokens=15, spec=True)]


def test_scheduler_mixed_batch_parity(base_engine, spec_engine):
    s0 = BatchScheduler(base_engine)
    for r in _mixed_requests():
        s0.submit(r)
    ref = {rid: list(r.generated) for rid, r in s0.run().items()}
    s0.check()

    s1 = BatchScheduler(spec_engine)
    syncs0 = spec_engine.host_syncs
    for r in _mixed_requests():
        s1.submit(r)
    out = {rid: list(r.generated) for rid, r in s1.run().items()}
    s1.check()
    assert s1.pool.all_free(), "draft/target pages leaked after the run"
    assert out == ref
    m = s1.metrics
    # every spec-engine segment is one draft/verify round with one sync,
    # and K drafts are proposed per resident spec row per round
    assert m["spec_rounds"] == m["segments"] > 0
    assert spec_engine.host_syncs - syncs0 == m["segments"]
    assert m["draft_proposed"] > 0
    assert 0 <= m["draft_accepted"] <= m["draft_proposed"]


def test_cancel_and_expire_on_spec_rows_leave_the_closure(spec_engine,
                                                          monkeypatch):
    """The reference's chaos events ``cancel_request`` and
    ``expire_request`` at segment boundaries, by hand: flip a spec row's
    cancel flag after round 1 and a non-spec row's deadline after round 2
    (``tests/test_torch_chaos.py`` runs the events themselves)."""
    sched = BatchScheduler(spec_engine)
    reqs = [Request(rid=i, prompt=[3 + i, 7, 11], max_new_tokens=20,
                    spec=(i % 2 == 0)) for i in range(4)]
    for r in reqs:
        sched.submit(r)
    real = spec_engine.spec_segment
    calls = []

    def faulty(self, *args):
        calls.append(1)
        if len(calls) == 2:
            reqs[0].cancel()
        if len(calls) == 3:
            reqs[1].deadline_ms = 0.0
        sched.check()
        return real(*args)

    monkeypatch.setattr(spec_engine, "spec_segment",
                        types.MethodType(faulty, spec_engine))
    sched.run()
    sched.check()
    assert sched.pool.all_free(), "faulted spec rows leaked pages"
    assert all(sched.requests[r.rid].terminal for r in reqs)
    assert sched.requests[0].status == "cancelled"
    assert sched.requests[1].status == "expired"
    assert {e["type"] for e in sched.ft_events} >= {"cancel", "expiry"}
    assert len(reqs[0].generated) < 20 and len(reqs[1].generated) < 20
    assert [len(reqs[i].generated) for i in (2, 3)] == [20, 20]


def test_int8_spec_scheduler_keeps_its_invariants(models):
    _, _, lm, dlm = models
    eng = Engine(lm, dataclasses.replace(SCFG, kv_dtype="int8"),
                 device="cpu", spec=SpecConfig(draft_config=DCFG,
                                               num_draft_tokens=3),
                 draft_lm=dlm)
    sched = BatchScheduler(eng)
    for r in _mixed_requests():
        sched.submit(r)
    out = sched.run()
    sched.check()
    assert sched.pool.all_free()
    assert {rid: len(r.generated) for rid, r in out.items()} == {
        r.rid: r.max_new_tokens for r in _mixed_requests()}
    assert eng.host_syncs == sched.metrics["segments"]


def test_rejection_engine_smoke_and_loops_agree(models):
    _, _, lm, dlm = models
    scfg = dataclasses.replace(SCFG, temperature=0.7)
    eng = Engine(lm, scfg, device="cpu",
                 spec=SpecConfig(draft_config=DCFG, num_draft_tokens=3),
                 draft_lm=dlm)
    assert eng.spec_policy == "rejection"
    out = eng.generate(PROMPTS, max_new_tokens=12)
    assert [len(t) for t in out] == [12, 12, 12]
    assert all(0 <= tok < TCFG.vocab for t in out for tok in t)
    assert eng.spec_stats["proposed"] > 0
    # fused and streamed rounds consume the generator alike
    assert eng.generate(PROMPTS, 12, stream_cb=lambda *a: None) == out
    other = Engine(lm, dataclasses.replace(scfg, seed=1), device="cpu",
                   spec=eng.spec, draft_lm=dlm)
    assert other.generate(PROMPTS, 12) != out


# ---------------------------------------------------------------------------
# accept_speculative math
# ---------------------------------------------------------------------------

def test_greedy_accept_longest_prefix_and_carry():
    v, k = 8, 3
    tgt = torch.tensor([[1, 2, 3, 4]])             # argmax chain o_0..o_3
    target_logits = torch.nn.functional.one_hot(tgt, v).float() * 5.0
    for match in range(k + 1):
        drafts = torch.tensor([[1, 2, 3][:match] + [7] * (k - match)],
                              dtype=torch.int32)
        acc, carry = accept_speculative(
            drafts, torch.zeros((1, k, v)), target_logits, policy="greedy")
        assert int(acc[0]) == match and acc.dtype == torch.int32
        # carry is o_a verbatim: the next argmax continues the target chain
        assert int(torch.argmax(carry[0])) == int(tgt[0, match])


@pytest.mark.parametrize("seed", range(3))
def test_greedy_accept_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    b, k, v = 6, 4, 32
    o = rng.standard_normal((b, k + 1, v)).astype(np.float32)
    q = rng.standard_normal((b, k, v)).astype(np.float32)
    d = np.argmax(o[:, :k], axis=-1).astype(np.int32)
    # break the match at a row-dependent position (row b keeps b drafts)
    for row in range(b):
        if row < k:
            d[row, row] = (d[row, row] + 1) % v
    mask = np.array([True, True, False, True, True, True])
    got = accept_speculative(torch.from_numpy(d), torch.from_numpy(q),
                             torch.from_numpy(o), policy="greedy",
                             spec_mask=torch.from_numpy(mask))
    want = jax_accept(jnp.asarray(d), jnp.asarray(q), jnp.asarray(o),
                      policy="greedy", spec_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].tolist() == [0, 1, 0, 3, 4, 4]


def test_accept_spec_mask_false_forces_plain_target():
    v, k, t = 8, 2, 0.7
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, k, v)).astype(np.float32))
    o = torch.from_numpy(rng.standard_normal((1, k + 1, v)).astype(
        np.float32))
    acc, carry = accept_speculative(
        torch.zeros((1, k), dtype=torch.int32), q, o,
        torch.Generator().manual_seed(0), policy="rejection",
        temperature=t, spec_mask=torch.tensor([False]))
    assert int(acc[0]) == 0
    # the carried distribution is the plain p_0, not the residual
    torch.testing.assert_close(torch.softmax(carry[0] / t, -1),
                               torch.softmax(o[0, 0] / t, -1),
                               rtol=1e-5, atol=1e-6)


def _rejection_pair(d, q, o, t, mask=None):
    kw = {} if mask is None else dict(spec_mask=mask)
    got = accept_speculative(torch.from_numpy(d), torch.from_numpy(q),
                             torch.from_numpy(o),
                             torch.Generator().manual_seed(5),
                             policy="rejection", temperature=t, **kw)
    jkw = {} if mask is None else dict(spec_mask=jnp.asarray(mask.numpy()))
    want = jax_accept(jnp.asarray(d), jnp.asarray(q), jnp.asarray(o),
                      jax.random.PRNGKey(5), policy="rejection",
                      temperature=t, **jkw)
    return ([x.numpy() for x in got], [np.asarray(x) for x in want])


def _same_carry(carry, want, t):
    """The carried logits ``T * log(dist)``: the same ``-inf`` mask, finite
    values within 1e-6 relative (fp32 ``exp``/``log`` differ by a few ulps
    between libraries, ~5e-7 at |carry| ~ 4), and the distribution they
    carry, ``softmax(carry / T)``, within 1e-6 absolute."""
    np.testing.assert_array_equal(np.isfinite(carry), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(carry[fin], want[fin], rtol=1e-6, atol=0)
    dist = torch.softmax(torch.from_numpy(carry) / t, -1).numpy()
    wdist = np.asarray(jax.nn.softmax(jnp.asarray(want) / t, axis=-1))
    np.testing.assert_allclose(dist, wdist, rtol=0, atol=1e-6)


def test_rejection_carries_equal_the_reference_when_no_draw_decides():
    """Certain acceptance (the target's distributions at the draft
    positions equal the draft's, so ``p >= q``: every ``u < 1`` accepts)
    gives a = K and the bonus ``p_K``; impossible acceptance (``p_tok =
    0``) gives a = 0 and the residual ``norm(max(p_0 - q_1, 0))``."""
    rng = np.random.default_rng(7)
    b, k, v, t = 4, 3, 16, 0.8
    q = rng.standard_normal((b, k, v)).astype(np.float32)
    o = rng.standard_normal((b, k + 1, v)).astype(np.float32)
    d = rng.integers(0, v, (b, k)).astype(np.int32)
    certain = o.copy()
    certain[:, :k] = q
    (acc, carry), (wacc, wcarry) = _rejection_pair(d, q, certain, t)
    assert acc.tolist() == [k] * b
    np.testing.assert_array_equal(acc, wacc)
    _same_carry(carry, wcarry, t)
    impossible = o.copy()
    np.put_along_axis(impossible[:, :1], d[:, :1, None], -np.inf, axis=-1)
    (acc, carry), (wacc, wcarry) = _rejection_pair(d, q, impossible, t)
    assert acc.tolist() == [0] * b
    np.testing.assert_array_equal(acc, wacc)
    np.testing.assert_array_equal(np.isfinite(carry), np.isfinite(wcarry))
    fin = np.isfinite(wcarry)
    assert (~fin).any()                    # dist is 0 where p_0 < q_1
    _same_carry(carry, wcarry, t)
    # the -inf carry rows sample only tokens of finite mass
    gen = torch.Generator().manual_seed(2)
    tok = sampling.sample(torch.from_numpy(carry), gen, method="top_p",
                          temperature=t).numpy()
    assert all(fin[i, tok[i]] for i in range(b))


def test_rejection_first_token_matches_target_distribution():
    """The emitted token (the accepted draft, else the residual draw) is
    distributed as the target softmax: 4096 seeded trials, the reference
    test's L1 bound."""
    v, t, n = 16, 0.8, 4096
    rng = np.random.default_rng(3)
    q_logits = rng.standard_normal((1, 1, v)).astype(np.float32)
    o_logits = rng.standard_normal((1, 2, v)).astype(np.float32)
    q = torch.from_numpy(np.repeat(q_logits, n, axis=0))
    o = torch.from_numpy(np.repeat(o_logits, n, axis=0))
    gen = torch.Generator().manual_seed(17)
    d = sampling.sample(q[:, 0], gen, method="top_p", temperature=t)
    acc, carry = accept_speculative(d[:, None], q, o, gen,
                                    policy="rejection", temperature=t)
    alt = sampling.sample(carry, gen, method="top_p", temperature=t)
    toks = torch.where(acc == 1, d, alt).numpy()
    hist = np.bincount(toks, minlength=v) / n
    want = np.asarray(jax.nn.softmax(jnp.asarray(o_logits[0, 0]) / t))
    assert np.abs(hist - want).sum() < 0.12, (hist, want)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_spec_config_validation_errors():
    good = SpecConfig(draft_config=DCFG, num_draft_tokens=4)
    good.validate(TCFG, SCFG)                  # sanity: the pairing is ok
    assert good.signature() == ("spec-d", 4, "auto")
    with pytest.raises(ValueError, match=">= 1"):
        SpecConfig(draft_config=DCFG, num_draft_tokens=0).validate(TCFG)
    with pytest.raises(ValueError, match="accept_policy"):
        SpecConfig(draft_config=DCFG, accept_policy="maybe").validate(TCFG)
    with pytest.raises(ValueError, match="vocab mismatch"):
        SpecConfig(draft_config=dataclasses.replace(
            DCFG, vocab=512)).validate(TCFG)
    with pytest.raises(ValueError, match="attention-cache"):
        SpecConfig(draft_config=dataclasses.replace(
            DCFG, family="hybrid")).validate(TCFG)
    with pytest.raises(ValueError, match="paged engine"):
        good.validate(TCFG, dataclasses.replace(SCFG, page_size=0))
    with pytest.raises(ValueError, match="temperature 0"):
        SpecConfig(draft_config=DCFG, accept_policy="greedy").validate(
            TCFG, dataclasses.replace(SCFG, temperature=0.5))
    with pytest.raises(ValueError, match="temperature > 0"):
        SpecConfig(draft_config=DCFG, accept_policy="rejection").validate(
            TCFG, SCFG)
    with pytest.raises(ValueError, match="temperature-only"):
        good.validate(TCFG, dataclasses.replace(SCFG, temperature=0.5,
                                                top_k=5))


def test_cli_spec_kwargs_validation():
    def ns(**kw):
        base = dict(draft=None, spec_tokens=4, accept_policy="auto",
                    smoke_dims=True)
        base.update(kw)
        return types.SimpleNamespace(**base)

    assert cli.spec_kwargs(ns(), TCFG, SCFG) == {}
    with pytest.raises(ValueError, match="need --draft"):
        cli.spec_kwargs(ns(spec_tokens=6), TCFG, SCFG)
    with pytest.raises(ValueError, match="vocab mismatch"):
        cli.spec_kwargs(ns(draft="qwen2-0.5b", smoke_dims=False),
                        TCFG, SCFG)
    with pytest.raises(ValueError, match="attention-cache"):
        cli.spec_kwargs(ns(draft="zamba2-1.2b"), TCFG, SCFG)
    kw = cli.spec_kwargs(ns(draft="qwen2-0.5b"), TCFG, SCFG)
    assert kw["spec"].draft_config.vocab == TCFG.vocab


def test_engine_rejects_spec_without_a_fitting_draft(models):
    _, _, lm, dlm = models
    spec = SpecConfig(draft_config=DCFG, num_draft_tokens=4)
    with pytest.raises(ValueError, match="draft_lm"):
        Engine(lm, SCFG, device="cpu", spec=spec)
    with pytest.raises(ValueError, match="spec.draft_config"):
        Engine(lm, SCFG, device="cpu", spec=spec, draft_lm=lm)
    with pytest.raises(ValueError, match="paged engine"):
        Engine(lm, dataclasses.replace(SCFG, page_size=0), device="cpu",
               spec=spec, draft_lm=dlm)


def test_serve_launcher_speculative_and_instrumented(tmp_path):
    path = tmp_path / "spec.json"
    assert serve_launcher.main([
        "--arch", "qwen2-0.5b", "--smoke-dims", "--device", "cpu",
        "--page-size", "8", "--temperature", "0.7", "--draft", "qwen2-0.5b",
        "--spec-tokens", "3", "--instrument", "--requests", "4",
        "--max-new", "6", "--json", str(path)]) == 0
    d = json.loads(path.read_text())
    assert d["requests"] == 4 and d["new_tokens"] == 4 * 6
    spec = d["spec"]
    assert spec["draft"] == "qwen2-0.5b" and spec["k"] == 3
    assert spec["rounds"] == d["segments"] == d["host_syncs"] > 0
    assert 0.0 <= spec["accept_rate"] <= 1.0
    regions = d["regions"]
    assert set(regions) == {"serve.prefill", "serve.decode"}
    # one probe each, then every admission's two prefills (target and
    # draft) and every segment
    assert regions["serve.prefill"]["calls"] == 1 + 2 * d["admissions"]
    assert regions["serve.decode"]["calls"] == 1 + d["segments"]
    assert all(r["time_s"] > 0 for r in regions.values())
    with pytest.raises(SystemExit):            # spec needs a paged engine
        serve_launcher.main(["--arch", "qwen2-0.5b", "--smoke-dims",
                             "--device", "cpu", "--draft", "qwen2-0.5b"])
