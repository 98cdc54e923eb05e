"""The moe family's serving against the JAX engine, on the CPU, in fp32.

qwen2-moe-a2.7b and qwen3-moe-235b-a22b ``SMOKE`` with the JAX
``LM.init`` parameters bridged over (the embedding scaled by 0.1, so
tokens depend on every layer): greedy tokens equal the JAX engine's for
``generate`` (dense KV, fp32 and int8 pages), the ``BatchScheduler`` with
the prefix cache, speculative decoding with a moe target and a dense
draft, and a kill / restore against the JAX scheduler's own restore on
the same schedule.  Every routed row takes MoE capacity (pads, idle
slots, a verify's K + 1 rows), so each run is held to the JAX run on the
same traffic.  Then the entry points: the serving launcher (``--layers``
cuts depth), ``bench_serve --arch`` and ``profile_generate``'s archs.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.checkpoint import store as jax_store
from repro.configs import get_arch as jax_get_arch
from repro.core.features import default_features
from repro.models.lm import LM as JaxLM
from repro.models.lm import LMConfig as JaxLMConfig
from repro.serve import engine as jax_engine
from repro.serve.spec import SpecConfig as JaxSpecConfig
from repro_torch.bench import bench_serve, profile_generate
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import store
from repro_torch.configs import get_arch
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve import engine
from repro_torch.serve.spec import SpecConfig

torch.set_num_threads(1)

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
PROMPT_LENS = (10, 3, 1, 6)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jlm = JaxLM(jax_get_arch(arch).smoke, default_features().with_(
        remat_policy="none"), dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * 0.1
    cfg = get_arch(arch).smoke
    lm = LM(cfg, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, cfg))
    return arch, jlm, jax.tree.map(jnp.asarray, jparams), lm


@pytest.mark.parametrize("page_size,kv_dtype", [(0, None), (4, None),
                                                (4, "int8")])
def test_greedy_tokens_equal_the_jax_engine(pair, page_size, kv_dtype):
    arch, jlm, jp, lm = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, lm.cfg.vocab, n).tolist() for n in PROMPT_LENS]
    sc = dict(max_seq=64, page_size=page_size, kv_dtype=kv_dtype)
    want = jax_engine.Engine(jlm, jp, jax_engine.ServeConfig(
        **sc)).generate(prompts, 8)
    eng = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")
    got = eng.generate(prompts, 8)
    assert got == want, arch
    assert eng.host_syncs == 1
    assert len({tuple(t) for t in got}) > 1


def _workload(vocab, seed=5):
    """(prompt, budget) per rid: a 12-token shared prefix behind four of
    six prompts (full-page hits and in-page forks at page size 8) and
    ragged budgets."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, 12).tolist()

    def tail(n):
        return rng.integers(1, vocab, n).tolist()

    prompts = [shared + tail(5), shared + tail(3), tail(7),
               shared[:10] + tail(4), shared + tail(6), tail(4)]
    return list(zip(prompts, [9, 6, 11, 5, 8, 7]))


def _submit(mod, sched, work):
    for rid, (prompt, budget) in enumerate(work):
        sched.submit(mod.Request(rid=rid, prompt=list(prompt),
                                 max_new_tokens=budget))
    return sched


def _tokens(sched):
    return {rid: list(r.generated) for rid, r in sched.completed.items()}


SC = dict(max_seq=64, batch_slots=3, admission_chunk=4, page_size=8)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_scheduler_with_prefix_cache_matches_jax(pair, kv_dtype):
    arch, jlm, jp, lm = pair
    sc = dict(SC, kv_dtype=kv_dtype)
    work = _workload(lm.cfg.vocab)
    jsched = _submit(jax_engine, jax_engine.BatchScheduler(
        jax_engine.Engine(jlm, jp, jax_engine.ServeConfig(**sc))), work)
    jsched.run()
    eng = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")
    sched = _submit(engine, engine.BatchScheduler(eng), work)
    sched.run()
    got = _tokens(sched)
    assert got == _tokens(jsched), arch
    for rid, (_, budget) in enumerate(work):
        assert len(got[rid]) == budget
    for k in ("segments", "admissions", "prefix_hits", "cow_copies",
              "decode_steps"):
        assert sched.metrics[k] == jsched.metrics[k], k
    assert sched.metrics["prefix_hits"] > 0
    assert eng.host_syncs == sched.metrics["segments"] > 1
    sched.check()
    sched.pool.check()


DRAFT_KW = dict(name="moe-spec-d", family="dense", vocab=256, d_model=32,
                n_layers=1, num_heads=4, num_kv_heads=2, d_ff=64)


def test_spec_with_a_moe_target_equals_the_jax_spec_engine(pair):
    """fp32 greedy spec (K = 3, a dense draft) with a moe target: the
    fused and the scheduler's tokens equal the JAX spec engine's on the
    same traffic.  The verify routes K + 1 rows a request, so the MoE's
    capacity sees another batch than a target-only step: both packages'
    spec tokens are held to the JAX spec run, and target-only to the JAX
    target-only run."""
    arch, jlm, jp, lm = pair
    djlm = JaxLM(JaxLMConfig(**DRAFT_KW), default_features().with_(
        remat_policy="none"), dtype=jnp.float32)
    dp = jax.device_get(jax.jit(djlm.init)(jax.random.PRNGKey(1)))
    dlm = LM(LMConfig(**DRAFT_KW), torch.float32, device="cpu")
    dlm.load_state_dict(params_from_jax(dp, LMConfig(**DRAFT_KW)))
    sc = dict(max_seq=96, batch_slots=4, page_size=16, admission_chunk=8)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, lm.cfg.vocab, n).tolist() for n in (5, 3, 8)]
    jspec = jax_engine.Engine(
        jlm, jp, jax_engine.ServeConfig(**sc),
        spec=JaxSpecConfig(draft_config=JaxLMConfig(**DRAFT_KW),
                           num_draft_tokens=3),
        draft_params=jax.tree.map(jnp.asarray, dp))
    want = jspec.generate(prompts, 12)
    want_plain = jax_engine.Engine(jlm, jp, jax_engine.ServeConfig(
        **sc)).generate(prompts, 12)
    eng = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu",
                        spec=SpecConfig(draft_config=LMConfig(**DRAFT_KW),
                                        num_draft_tokens=3),
                        draft_lm=dlm)
    assert eng.generate(prompts, 12) == want, arch
    assert eng.spec_stats["rounds"] > 0
    plain = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")
    assert plain.generate(prompts, 12) == want_plain, arch
    # the mixed scheduler: every other request opts in
    jsched = jax_engine.BatchScheduler(jspec)
    sched = engine.BatchScheduler(eng)
    for mod, s in ((jax_engine, jsched), (engine, sched)):
        for rid, p in enumerate(prompts):
            s.submit(mod.Request(rid=rid, prompt=list(p), max_new_tokens=10,
                                 spec=rid % 2 == 0))
        s.run()
    assert _tokens(sched) == _tokens(jsched), arch
    sched.check()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_restore_equals_the_jax_schedulers_restore(pair, tmp_path, kv_dtype):
    """Killed after one segment with a snapshot, restored on a fresh
    engine: the port's restored run gives the tokens of the JAX
    scheduler's restored run on the same schedule, and a snapshot the
    port writes restores on the JAX engine to those tokens too."""
    arch, jlm, jp, lm = pair
    sc = dict(SC, kv_dtype=kv_dtype)
    work = _workload(lm.cfg.vocab)

    def killed(mod, eng, where):
        sched = _submit(mod, mod.BatchScheduler(
            eng, snapshot_dir=str(where), snapshot_every=1), work)
        sched.run(max_segments=1)
        assert len(sched.completed) < len(work), "nothing left to restore"

    def jax_eng():
        return jax_engine.Engine(jlm, jp, jax_engine.ServeConfig(**sc))

    def torch_eng():
        return engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")

    killed(jax_engine, jax_eng(), tmp_path / "jax")
    jsched = jax_eng().restore(jax_store.latest_snapshot(
        str(tmp_path / "jax")))
    jsched.run()
    want = _tokens(jsched)
    killed(engine, torch_eng(), tmp_path / "torch")
    latest = store.latest_snapshot(str(tmp_path / "torch"))
    sched = torch_eng().restore(latest)
    assert sched.metrics["restores"] == 1
    sched.run()
    assert _tokens(sched) == want, arch
    sched.check()
    cross = jax_eng().restore(latest)
    cross.run()
    assert _tokens(cross) == want, arch


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_a_moe_arch(arch, tmp_path):
    path = tmp_path / "moe.json"
    assert serve_launcher.main([
        "--arch", arch, "--smoke-dims", "--device", "cpu",
        "--requests", "4", "--slots", "2", "--prompt-len", "6",
        "--max-new", "4", "--page-size", "8", "--kv-dtype", "int8",
        "--shared-prefix", "10", "--dtype", "fp32", "--json",
        str(path)]) == 0
    d = json.loads(path.read_text())
    assert d["device"] == "cpu" and d["new_tokens"] == 4 * 4
    assert d["host_syncs"] == d["segments"] > 0


def test_serve_launcher_cuts_depth_with_layers(tmp_path, capsys):
    path = tmp_path / "moe.json"
    assert serve_launcher.main([
        "--arch", "qwen3-moe-235b-a22b", "--smoke-dims", "--device", "cpu",
        "--layers", "2", "--requests", "2", "--slots", "2",
        "--prompt-len", "5", "--max-new", "3", "--page-size", "8",
        "--json", str(path)]) == 0
    assert "qwen3-moe-235b-a22b-smoke: 2 layers" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve_launcher.main(["--arch", "qwen2-moe-a2.7b", "--smoke-dims",
                             "--device", "cpu", "--layers", "0"])


def test_bench_serve_and_profile_generate_take_the_moe_archs(monkeypatch,
                                                            capsys):
    """``bench_serve --arch qwen2-moe-a2.7b`` runs its claims on a moe
    model (here the arch's SMOKE dims stand in for the full config) and
    ``profile_generate`` has the ragged prompts for both archs, qwen3 at
    2 of its 94 layers."""
    for arch in ARCHS:
        assert profile_generate.PROMPT_LENS[arch] == profile_generate.RAGGED
    assert profile_generate.depth("qwen3-moe-235b-a22b") == 2
    assert profile_generate.depth("qwen2-moe-a2.7b") == 24
    assert "qwen2-moe-a2.7b" in bench_serve.ARCHS
    spec = get_arch("qwen2-moe-a2.7b")
    monkeypatch.setattr("repro_torch.configs.get_arch", lambda arch: (
        dataclasses.replace(spec, config=spec.smoke)))
    summary = bench_serve.run([], smoke=True, device="cpu",
                              arch="qwen2-moe-a2.7b")
    assert summary["host_syncs_fused"] <= 2
    assert summary["prefix_hit_rate"] > 0
    assert "qwen2-moe-a2.7b-smoke" in capsys.readouterr().out
