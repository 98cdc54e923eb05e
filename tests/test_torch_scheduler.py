"""The port's ``BatchScheduler`` against the JAX scheduler, on the CPU.

qwen2-0.5b ``SMOKE`` in fp32 with the JAX ``LM.init`` parameters bridged
over (the embedding table scaled by 0.1 on both sides, so the random model
does not just echo its last input token).  More requests than slots, so
admission happens mid-flight; a shared prompt prefix, so the prefix cache
maps pages read-only and copies the fork page; ragged prompts and budgets.
Over dense and paged engines, page storage in the model dtype, fp32 and
int8, and the prefix cache on and off, every request's greedy tokens and
the admission / prefix metrics must equal the JAX scheduler's.

The hybrid family (zamba2-1.2b ``SMOKE``, dense KV): ragged prompts
admitted one row at a time at their exact length give the JAX scheduler's
tokens and each request the tokens of a one-prompt ``generate``.

Then the reference's request-lifecycle scenarios that need no snapshot or
chaos (``tests/test_robustness.py``: deadlines, cancel, shed, bounded
bypass, drain), run through both schedulers with the same outcomes; the
launcher's JSON summary; and the engine's validation rules.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen2_0_5b import SMOKE as JAX_SMOKE
from repro.configs.zamba2_1_2b import SMOKE as JAX_ZAMBA_SMOKE
from repro.core.features import default_features
from repro.models.lm import LM as JaxLM
from repro.models.lm import LMConfig as JaxLMConfig
from repro.serve import engine as jax_engine
from repro.serve.admission import AdmissionRejected as JaxAdmissionRejected
from repro_torch.bridge import params_from_jax
from repro_torch.configs.qwen2_0_5b import SMOKE
from repro_torch.configs.zamba2_1_2b import SMOKE as ZAMBA_SMOKE
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve import engine
from repro_torch.serve.admission import AdmissionRejected
from repro_torch.serve.spec import SpecConfig

torch.set_num_threads(1)

METRICS = ("admissions", "prefix_hits", "prefilled_tokens", "pages_shared",
           "cow_copies", "segments", "decode_steps", "prompt_tokens")


def _pair(jcfg, cfg, seed, embed_scale=1.0):
    jlm = JaxLM(jcfg, default_features().with_(remat_policy="none"),
                dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(seed)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * embed_scale
    lm = LM(cfg, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, cfg))
    return jlm, jax.tree.map(jnp.asarray, jparams), lm


@pytest.fixture(scope="module")
def smoke():
    return _pair(JAX_SMOKE, SMOKE, 0, embed_scale=0.1)


def _workload():
    """(prompt, budget) per rid: a 12-token shared prefix behind five of
    the seven prompts (a full-page hit at page size 8, and in-page forks
    that copy the fork page), two unrelated prompts, ragged budgets."""
    rng = np.random.default_rng(5)
    shared = rng.integers(1, SMOKE.vocab, 12).tolist()

    def tail(n):
        return rng.integers(1, SMOKE.vocab, n).tolist()

    prompts = [shared + tail(5), shared + tail(3), tail(7),
               shared[:10] + tail(4), shared + tail(5), tail(4),
               shared + tail(6)]
    budgets = [5, 3, 7, 2, 6, 4, 5]
    return list(zip(prompts, budgets))


def _run(mod, eng, work):
    sched = mod.BatchScheduler(eng)
    for rid, (prompt, budget) in enumerate(work):
        sched.submit(mod.Request(rid=rid, prompt=list(prompt),
                                 max_new_tokens=budget))
    done = sched.run()
    return sched, {rid: list(r.generated) for rid, r in done.items()}


SCHED_CASES = [
    # page_size, kv_dtype, prefix_cache
    (0, None, True),
    (8, None, True),
    (8, None, False),
    (8, "fp32", True),
    (8, "int8", True),
    (8, "int8", False),
]


@pytest.mark.parametrize("page_size,kv_dtype,prefix_cache", SCHED_CASES)
def test_scheduler_matches_jax_scheduler(smoke, page_size, kv_dtype,
                                         prefix_cache):
    jlm, jparams, lm = smoke
    sc = dict(max_seq=64, batch_slots=3, admission_chunk=4,
              page_size=page_size, kv_dtype=kv_dtype,
              prefix_cache=prefix_cache)
    work = _workload()
    jsched, want = _run(jax_engine, jax_engine.Engine(
        jlm, jparams, jax_engine.ServeConfig(**sc)), work)
    eng = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")
    sched, got = _run(engine, eng, work)
    assert got == want
    assert sorted(got) == list(range(len(work)))
    for rid, (_, budget) in enumerate(work):
        assert len(got[rid]) == budget          # overshoot masked
    assert len({tuple(t) for t in got.values()}) > 3   # not an echo
    for k in METRICS:
        assert sched.metrics[k] == jsched.metrics[k], k
    assert [rid for rid, _ in sched.admission_log] == \
        [rid for rid, _ in jsched.admission_log]
    # the audited contract: one device->host transfer per segment
    assert eng.host_syncs == sched.metrics["segments"] > 1
    assert sched.metrics["admissions"] > 3     # slots reused mid-flight
    sched.check()
    if page_size:
        sched.pool.check()
        assert sched.pool.allocs == sched.pool.releases > 0
        if prefix_cache:
            assert sched.metrics["prefix_hits"] > 0
            assert sched.metrics["cow_copies"] > 0
            assert sched.metrics["pages_shared"] > 0
        else:
            assert sched.pool.all_free()
            assert sched.metrics["prefix_hits"] == 0


def test_scheduler_paths_agree_in_fp32(smoke):
    """Dense, paged and prefix-cached paged schedulers and the static
    ``generate`` give one request the same greedy tokens (fp32, so the
    suffix prefill reproduces the full prefill's K/V)."""
    _, _, lm = smoke
    work = _workload()
    runs = []
    for sc in (dict(), dict(page_size=8, prefix_cache=False),
               dict(page_size=8), dict(page_size=4, kv_dtype="fp32")):
        eng = engine.Engine(lm, engine.ServeConfig(
            max_seq=64, batch_slots=2, admission_chunk=2, **sc), device="cpu")
        runs.append(_run(engine, eng, work)[1])
    assert runs[0] == runs[1] == runs[2] == runs[3]
    eng = engine.Engine(lm, engine.ServeConfig(max_seq=64), device="cpu")
    for rid, (prompt, budget) in enumerate(work):
        assert eng.generate([prompt], budget)[0] == runs[0][rid]


def test_zamba2_scheduler_matches_jax_and_single_prompt_generate():
    """Recurrent state over dense KV: every admission merges the row's SSD
    state, conv tail and 2 KV caches into its slot."""
    jlm, jparams, lm = _pair(JAX_ZAMBA_SMOKE, ZAMBA_SMOKE, 0,
                             embed_scale=0.1)
    rng = np.random.default_rng(6)
    work = [(rng.integers(1, ZAMBA_SMOKE.vocab, n).tolist(), budget)
            for n, budget in zip((19, 5, 23, 3, 17, 30, 8),
                                 (5, 3, 7, 2, 6, 4, 5))]
    sc = dict(max_seq=64, batch_slots=3, admission_chunk=4)
    jsched, want = _run(jax_engine, jax_engine.Engine(
        jlm, jparams, jax_engine.ServeConfig(**sc)), work)
    eng = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")
    sched, got = _run(engine, eng, work)
    assert got == want
    for rid, (_, budget) in enumerate(work):
        assert len(got[rid]) == budget
    assert len({tuple(t) for t in got.values()}) > 3
    for k in ("admissions", "segments", "decode_steps", "prompt_tokens"):
        assert sched.metrics[k] == jsched.metrics[k], k
    assert [rid for rid, _ in sched.admission_log] == \
        [rid for rid, _ in jsched.admission_log]
    assert eng.host_syncs == sched.metrics["segments"] > 1
    assert sched.metrics["admissions"] > 3
    sched.check()
    single = engine.Engine(lm, engine.ServeConfig(max_seq=64), device="cpu")
    for rid, (prompt, budget) in enumerate(work):
        assert single.generate([prompt], budget)[0] == got[rid]


def test_engine_primitives_stay_on_the_device_between_segments(smoke):
    """prefill_slot / copy_pages / decode_segment never fetch: the only
    device->host transfer is the caller's."""
    _, _, lm = smoke
    eng = engine.Engine(lm, engine.ServeConfig(
        max_seq=64, batch_slots=2, page_size=4, kv_dtype="int8",
        admission_chunk=4), device="cpu")
    assert (eng.seg_cap, eng.slot_headroom) == (4, 4)
    assert [eng.quantize_steps(n) for n in (0, 1, 3, 4, 9)] == [1, 1, 4, 4, 4]
    assert eng.table_width == 17 and eng.pool_pages == 2 * 17 + 1
    state, logits = eng.init_state()
    assert state["caches"].k_pages.dtype == torch.int8
    assert state["caches"].k_scale.shape == (SMOKE.n_layers, 35, 4)
    prompt = list(range(3, 12))
    row = np.zeros(eng.table_width, np.int32)
    row[:3] = [5, 9, 2]
    state, logits = eng.prefill_slot(state, logits, prompt, 1, table_row=row)
    state = eng.copy_pages(state, [(9, 11)])
    c = state["caches"]
    assert torch.equal(c.k_pages[:, 11], c.k_pages[:, 9])
    assert torch.equal(c.v_scale[:, 11], c.v_scale[:, 9])
    toks, logits, state = eng.decode_segment(state, logits, 3)
    assert toks.shape == (2, 4) and eng.host_syncs == 0
    assert state["caches"].length.tolist() == [4, len(prompt) + 4]
    # decode continues the prefilled row exactly like generate does
    want = engine.Engine(lm, engine.ServeConfig(
        max_seq=64, page_size=4, kv_dtype="int8"), device="cpu").generate(
            [prompt], 4)[0]
    assert toks[1].tolist() == want


def test_engine_validation_and_unported_arguments(smoke, tmp_path):
    _, _, lm = smoke
    with pytest.raises(ValueError, match="paged"):
        engine.Engine(lm, engine.ServeConfig(kv_dtype="int8"), device="cpu")
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        engine.Engine(lm, engine.ServeConfig(page_size=4, kv_dtype="fp8"),
                      device="cpu")
    with pytest.raises(ValueError, match="kv_dtype needs"):
        lm.init_decode_state(2, 16, kv_dtype=torch.int8)
    eng = engine.Engine(lm, engine.ServeConfig(max_seq=64), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 14"):
        engine.Engine(lm, engine.ServeConfig(), device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 12"):
        eng.generate([[1, 2]], 2, extra_batch={"src_feats": 0})
    # speculative decoding is ported: the target as its own draft runs and
    # gives the target-only greedy tokens
    paged = engine.ServeConfig(max_seq=64, page_size=8)
    spec_eng = engine.Engine(lm, paged, device="cpu",
                             spec=SpecConfig(draft_config=lm.cfg,
                                             num_draft_tokens=2),
                             draft_lm=lm)
    assert spec_eng.generate([[1, 2, 3]], 4) == engine.Engine(
        lm, paged, device="cpu").generate([[1, 2, 3]], 4)
    # snapshots and chaos are ported: the scheduler takes their arguments
    # (tests/test_torch_snapshot.py and test_torch_chaos.py run them)
    from repro_torch.ft.chaos import ChaosSchedule
    armed = engine.BatchScheduler(eng, snapshot_dir=str(tmp_path),
                                  snapshot_every=2, snapshot_keep=1,
                                  chaos=ChaosSchedule.smoke())
    assert (armed.snapshot_dir, armed.snapshot_every,
            armed.snapshot_keep) == (str(tmp_path), 2, 1)
    assert armed.heartbeats is None and armed.chaos is not None
    sched = engine.BatchScheduler(eng)
    with pytest.raises(ValueError, match="max_seq"):
        sched.submit(engine.Request(rid=0, prompt=[1] * 60,
                                    max_new_tokens=8))
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(engine.Request(rid=1, prompt=[1], max_new_tokens=0))
    assert sched.run() == {}                      # nothing queued
    assert engine.TERMINAL_STATUSES == jax_engine.TERMINAL_STATUSES
    assert set(engine.KV_DTYPES) == set(jax_engine.KV_DTYPES)
    assert [f.name for f in dataclasses.fields(engine.Request)] == \
        [f.name for f in dataclasses.fields(jax_engine.Request)]


# ---------------------------------------------------------------------------
# request lifecycle: the reference's scenarios through both schedulers
# ---------------------------------------------------------------------------

ROBUST = dict(name="robust-t", family="dense", vocab=64, d_model=32,
              n_layers=2, num_heads=4, num_kv_heads=2, d_ff=64)


@pytest.fixture(scope="module")
def robust():
    """The reference's tiny paged fp32 engine, on both sides."""
    jlm, jparams, lm = _pair(JaxLMConfig(**ROBUST), LMConfig(**ROBUST), 0)

    def make(impl, **sc):
        cfg = dict(max_seq=128, batch_slots=4, temperature=0.0,
                   eos_token=-1, admission_chunk=8, page_size=16)
        cfg.update(sc)
        if impl == "jax":
            return jax_engine.Engine(jlm, jparams,
                                     jax_engine.ServeConfig(**cfg))
        return engine.Engine(lm, engine.ServeConfig(**cfg), device="cpu")

    impls = {
        "jax": types.SimpleNamespace(mod=jax_engine, eng=make("jax"),
                                     Rejected=JaxAdmissionRejected),
        "torch": types.SimpleNamespace(mod=engine, eng=make("torch"),
                                       Rejected=AdmissionRejected),
    }
    return impls, make


def _reqs(impl, n, plen=8, max_new=10, base=0, **kw):
    rng = np.random.default_rng(11 + base)
    return [impl.mod.Request(rid=base + i,
                             prompt=rng.integers(1, 64, plen).tolist(),
                             max_new_tokens=max_new, **kw) for i in range(n)]


def _outcome(sched):
    return ({rid: list(r.generated) for rid, r in sched.completed.items()},
            {rid: (r.status, list(r.generated))
             for rid, r in sched.aborted.items()},
            {k: sched.metrics[k] for k in ("expired", "cancelled", "sheds",
                                           "rejections", "bypasses",
                                           "admissions", "segments")})


def _deadline(impl):
    reqs = _reqs(impl, 4, base=100, max_new=24)
    reqs[1].deadline_ms = 0.0          # expired by the first boundary
    sched = impl.mod.BatchScheduler(impl.eng)
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert 101 not in sched.completed
    assert sched.aborted[101].status == "expired"
    assert sched.metrics["expired"] == 1
    assert any(e["type"] == "expiry" and e["rid"] == 101
               for e in sched.ft_events)
    assert len(sched.completed) == 3
    sched.check()                      # a pool leak would trip here
    return sched


def _ttft_deadline(impl):
    reqs = _reqs(impl, 2, base=120, max_new=8)
    reqs[0].ttft_deadline_ms = 60_000.0   # generous: must NOT expire
    sched = impl.mod.BatchScheduler(impl.eng)
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert len(sched.completed) == 2
    assert all(r.ttft is not None and r.ttft > 0
               for r in sched.completed.values())
    return sched


def _cancel(impl):
    reqs = _reqs(impl, 6, base=140, max_new=24)
    sched = impl.mod.BatchScheduler(impl.eng)
    for r in reqs:
        sched.submit(r)
    assert sched.cancel(145)           # still queued: dequeued at once
    reqs[0].cancel()                   # request-side token, active row
    sched.run()
    for rid in (140, 145):
        assert rid not in sched.completed
        assert sched.aborted[rid].status == "cancelled"
        assert sched.aborted[rid].generated == []
    assert not sched.cancel(141)       # terminal: no-op
    assert not sched.cancel(99999)     # unknown: no-op
    assert len(sched.completed) == 4
    return sched


def _shed(impl):
    sched = impl.mod.BatchScheduler(impl.eng, max_queue=2,
                                    shed_policy="shed-lowest")
    batchy = _reqs(impl, 2, base=160, priority=2)
    for r in batchy:
        sched.submit(r)
    urgent = _reqs(impl, 1, base=170, priority=0)[0]
    sched.submit(urgent)
    assert sched.metrics["sheds"] == 1
    shed = [r for r in batchy if r.status == "shed"]
    assert len(shed) == 1 and shed[0].rid in sched.aborted
    sched.run()
    assert urgent.rid in sched.completed
    assert shed[0].rid not in sched.completed
    # priority order: the urgent request was admitted first
    assert sched.admission_log[0][0] == urgent.rid
    return sched


def _reject(impl):
    sched = impl.mod.BatchScheduler(impl.eng, max_queue=1)
    sched.submit(_reqs(impl, 1, base=180)[0])
    with pytest.raises(impl.Rejected):
        sched.submit(_reqs(impl, 1, base=190)[0])
    assert sched.metrics["rejections"] == 1
    assert any(e["type"] == "reject" for e in sched.ft_events)
    sched.run()
    return sched


def _drain(impl):
    sched = impl.mod.BatchScheduler(impl.eng)
    for r in _reqs(impl, 3, base=200):
        sched.submit(r)
    assert len(sched.drain()) == 3
    with pytest.raises(impl.Rejected) as ei:
        sched.submit(_reqs(impl, 1, base=210)[0])
    assert ei.value.rejection.reason == "draining"
    return sched


def _max_segments_resume(impl):
    """run(max_segments=1) re-queues in-flight rows with their progress;
    a second run() resumes them to the uninterrupted tokens."""
    base = impl.mod.BatchScheduler(impl.eng)
    for r in _reqs(impl, 6, base=300, max_new=12):
        base.submit(r)
    base.run()
    sched = impl.mod.BatchScheduler(impl.eng)
    for r in _reqs(impl, 6, base=300, max_new=12):
        sched.submit(r)
    sched.run(max_segments=1)
    assert len(sched.completed) < 6 and len(sched.queue) > 0
    assert any(r.generated for r in sched.queue.ordered())
    sched.run()
    assert {rid: r.generated for rid, r in sched.completed.items()} == \
        {rid: r.generated for rid, r in base.completed.items()}
    return sched


LIFECYCLE = {"deadline": _deadline, "ttft_deadline": _ttft_deadline,
             "cancel": _cancel, "shed": _shed, "reject": _reject,
             "drain": _drain, "max_segments_resume": _max_segments_resume}


@pytest.mark.parametrize("name", sorted(LIFECYCLE))
def test_lifecycle_scenarios_match_the_reference(robust, name):
    impls, _ = robust
    outcomes = {k: _outcome(LIFECYCLE[name](impl))
                for k, impl in impls.items()}
    assert outcomes["torch"] == outcomes["jax"]


def test_bounded_bypass_prevents_head_starvation(robust):
    """A large head request is bypassed at most ``max_bypass`` times by
    smaller later arrivals, then the queue blocks until pages drain to it
    (pool of 16 usable pages: the big request fits alone, not beside two
    smalls) — the same admission order as the reference."""
    _, make = robust
    orders = {}
    for impl_name, mod in (("jax", jax_engine), ("torch", engine)):
        eng = make(impl_name, admission_chunk=4, pool_pages=17)
        impl = types.SimpleNamespace(mod=mod)
        sched = mod.BatchScheduler(eng, max_bypass=2)
        # the reference's 64-token head, kept inside the 64-token vocab
        sched.submit(mod.Request(rid=1000,
                                 prompt=[1 + t % 63 for t in range(64)],
                                 max_new_tokens=32))
        for r in _reqs(impl, 10, base=2000, plen=16, max_new=16):
            sched.submit(r)
        sched.run()
        assert 1000 in sched.completed and len(sched.completed) == 11
        order = [rid for rid, _slot in sched.admission_log]
        assert order.index(1000) <= 2
        assert sched.metrics["bypasses"] <= 2
        sched.check()
        orders[impl_name] = (order, {rid: r.generated for rid, r in
                                     sched.completed.items()})
    assert orders["torch"] == orders["jax"]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_launcher_writes_the_summary(tmp_path):
    path = tmp_path / "serve.json"
    argv = ["--arch", "qwen2-0.5b", "--smoke-dims", "--device", "cpu",
            "--requests", "6", "--slots", "3",
            "--prompt-len", "5", "--max-new", "6", "--page-size", "8",
            "--kv-dtype", "int8", "--shared-prefix", "12",
            "--priority-mix", "0,1,1,2", "--max-queue", "5",
            "--json", str(path)]
    assert serve_launcher.main(argv) == 0
    d = json.loads(path.read_text())
    assert d["device"] == "cpu" and d["kv_dtype"] == "int8"
    assert d["requests"] == 5 and d["rejections"] == 1    # queue bound
    assert d["new_tokens"] == 5 * 6
    assert d["host_syncs"] == d["segments"] > 0
    assert d["prefix_cache"] and d["prefix_hit_rate"] > 0.4
    assert d["cow_copies"] > 0 and d["mean_ttft_ms"] > 0
    jax_keys = {"requests", "new_tokens", "tok_s", "host_syncs",
                "mean_ttft_ms", "segments", "admissions", "kv_dtype",
                "prefix_cache", "prefix_hit_rate", "pages_shared",
                "cow_copies", "pool_occupancy", "ft_events", "rejections",
                "sheds", "expired", "cancelled"}
    assert jax_keys <= set(d)
    with pytest.raises(SystemExit):         # --kv-dtype needs --page-size
        serve_launcher.main(["--arch", "qwen2-0.5b", "--device", "cpu",
                             "--kv-dtype", "int8"])
    with pytest.raises(SystemExit):         # --snapshot-every needs a dir
        serve_launcher.main(["--arch", "qwen2-0.5b", "--device", "cpu",
                             "--chaos", "3", "--snapshot-every", "2"])
    with pytest.raises(SystemExit):         # --mesh is not ported
        serve_launcher.main(["--arch", "qwen2-0.5b", "--device", "cpu",
                             "--mesh", "1x1"])
    # --temperature > 0 is ported: the launcher samples
    sampled = tmp_path / "sampled.json"
    assert serve_launcher.main(["--arch", "qwen2-0.5b", "--smoke-dims",
                                "--device", "cpu", "--temperature", "0.7",
                                "--requests", "2", "--max-new", "3",
                                "--json", str(sampled)]) == 0
    assert json.loads(sampled.read_text())["new_tokens"] == 2 * 3


def test_serve_launcher_runs_zamba2_with_dense_kv(tmp_path):
    path = tmp_path / "zamba.json"
    assert serve_launcher.main([
        "--arch", "zamba2-1.2b", "--smoke-dims", "--device", "cpu",
        "--requests", "4", "--slots", "2", "--prompt-len", "18",
        "--max-new", "5", "--json", str(path)]) == 0
    d = json.loads(path.read_text())
    assert d["device"] == "cpu" and d["requests"] == 4
    assert d["new_tokens"] == 4 * 5
    assert d["host_syncs"] == d["segments"] > 0
    assert d["pool_occupancy"] is None and d["prefix_hit_rate"] is None
    for extra in (["--page-size", "8"],
                  ["--page-size", "8", "--kv-dtype", "int8"]):
        with pytest.raises(ValueError, match="attention-cache family"):
            serve_launcher.main(["--arch", "zamba2-1.2b", "--smoke-dims",
                                 "--device", "cpu", *extra])
