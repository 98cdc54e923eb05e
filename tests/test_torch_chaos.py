"""The port's chaos harness and robustness flags against the JAX package's,
on the CPU.

* ``repro_torch.ft.chaos.ChaosSchedule(seed)`` deals the JAX schedule's
  ``(segment, kind, magnitude, duration, device)`` for seeds 0-31;
* under ``ChaosSchedule.smoke()`` with snapshots every 2 segments, the
  port's scheduler and the JAX scheduler, on the same fp32 traffic (the
  reference's tiny paged engine, JAX ``LM.init`` parameters bridged over),
  give the same tokens and the same chaos events (kind, segment, note),
  and the single-device engine skips the flap and the death;
* explicit events: ``cancel_request`` / ``expire_request`` land on spec
  rows of a mixed batch, as in the JAX scheduler; a seizure that starves
  admission is relieved (``pool_relief``) in both schedulers alike;
* randomized churn through a duck-typed hook keeps the invariant closure;
* the ``--snapshot-dir`` / ``--snapshot-every`` / ``--chaos`` flags, and
  the launcher's JSON summary with ``--chaos 0``.

Mirrors ``tests/test_robustness.py:446,457,474,498`` and its churn test.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.features import default_features
from repro.ft import chaos as jax_chaos
from repro.models.lm import LM as JaxLM
from repro.models.lm import LMConfig as JaxLMConfig
from repro.serve import engine as jax_engine
from repro.serve.spec import SpecConfig as JaxSpecConfig
from repro_torch.bridge import params_from_jax
from repro_torch.ft import chaos
from repro_torch.launch import cli
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve import engine
from repro_torch.serve.admission import AdmissionRejected
from repro_torch.serve.spec import SpecConfig

torch.set_num_threads(1)

ROBUST = dict(name="robust-t", family="dense", vocab=64, d_model=32,
              n_layers=2, num_heads=4, num_kv_heads=2, d_ff=64)
DRAFT = dict(name="robust-d", family="dense", vocab=64, d_model=32,
             n_layers=1, num_heads=4, num_kv_heads=2, d_ff=64)
SC = dict(max_seq=128, batch_slots=4, temperature=0.0, eos_token=-1,
          admission_chunk=8, page_size=16)
MODS = {"jax": jax_engine, "torch": engine}


def _pair(kw, seed):
    jlm = JaxLM(JaxLMConfig(**kw), default_features().with_(
        remat_policy="none"), dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(seed)))
    lm = LM(LMConfig(**kw), torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, LMConfig(**kw)))
    return jlm, jax.tree.map(jnp.asarray, jparams), lm


@pytest.fixture(scope="module")
def models():
    return _pair(ROBUST, 0), _pair(DRAFT, 1)


def _engine(models, impl, spec=False, **sc):
    (jlm, jparams, lm), (djlm, dparams, dlm) = models
    cfg = dict(SC, **sc)
    kw = {}
    if impl == "jax":
        if spec:
            kw = dict(draft_params=dparams, spec=JaxSpecConfig(
                draft_config=djlm.cfg, num_draft_tokens=3))
        return jax_engine.Engine(jlm, jparams, jax_engine.ServeConfig(**cfg),
                                 **kw)
    if spec:
        kw = dict(draft_lm=dlm, spec=SpecConfig(draft_config=dlm.cfg,
                                                num_draft_tokens=3))
    return engine.Engine(lm, engine.ServeConfig(**cfg), device="cpu", **kw)


def mod_chaos(impl):
    return jax_chaos if impl == "jax" else chaos


def _reqs(mod, n, plen=8, max_new=10, base=0, **kw):
    rng = np.random.default_rng(11 + base)
    return [mod.Request(rid=base + i,
                        prompt=rng.integers(1, ROBUST["vocab"],
                                            plen).tolist(),
                        max_new_tokens=max_new, **kw) for i in range(n)]


def _chaos_events(sched):
    return [(e["kind"], e["segment"], e.get("note"), e.get("pages"))
            for e in sched.ft_events if e["type"] == "chaos"]


def _tokens(sched):
    return {rid: list(r.generated) for rid, r in sched.requests.items()}


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(32))
def test_seeded_schedule_deals_the_jax_events(seed):
    def deal(mod):
        return [(e.segment, e.kind, e.magnitude, e.duration, e.device)
                for e in mod.ChaosSchedule(seed=seed).events]
    assert deal(chaos) == deal(jax_chaos)


def test_chaos_schedule_seed_determinism_and_vocabulary():
    a, b = chaos.ChaosSchedule(seed=42), chaos.ChaosSchedule(seed=42)
    assert [(e.segment, e.kind, e.magnitude) for e in a.events] \
        == [(e.segment, e.kind, e.magnitude) for e in b.events]
    c = chaos.ChaosSchedule(seed=43)
    assert [(e.segment, e.kind) for e in a.events] \
        != [(e.segment, e.kind) for e in c.events]
    assert chaos.KINDS == jax_chaos.KINDS
    assert chaos.ALL_KINDS == jax_chaos.ALL_KINDS
    smoke = [(e.segment, e.kind, e.magnitude, e.duration, e.device)
             for e in chaos.ChaosSchedule.smoke().events]
    assert smoke == [(e.segment, e.kind, e.magnitude, e.duration, e.device)
                     for e in jax_chaos.ChaosSchedule.smoke().events]
    with pytest.raises(ValueError, match="unknown chaos kind"):
        chaos.ChaosSchedule(kinds=("meteor",))


# ---------------------------------------------------------------------------
# the schedule on the scheduler
# ---------------------------------------------------------------------------

def test_smoke_schedule_matches_the_jax_scheduler(models, tmp_path):
    """Same traffic, same faults: equal tokens and equal chaos events; the
    slow and hung segments reach the straggler detector on both."""
    runs = {}
    for impl, mod in MODS.items():
        sched = mod.BatchScheduler(
            _engine(models, impl), chaos=mod_chaos(impl).ChaosSchedule.smoke(),
            snapshot_dir=str(tmp_path / impl), snapshot_every=2)
        for r in _reqs(mod, 10, base=600, max_new=24):
            sched.submit(r)
        sched.run()
        runs[impl] = sched
    jax_s, port = runs["jax"], runs["torch"]
    assert _tokens(port) == _tokens(jax_s)
    assert len(port.completed) == 10
    assert _chaos_events(port) == _chaos_events(jax_s)
    kinds = {e[0] for e in _chaos_events(port)}
    assert {"pool_exhaust", "pool_release", "slow_segment", "hung_segment",
            "snapshot_corrupt"} <= kinds
    assert port.chaos.summary() == jax_s.chaos.summary()
    assert sorted(port.chaos.summary()["skipped"]) == ["device_death",
                                                       "heartbeat_flap"]
    for key in ("segments", "admissions", "snapshots", "bypasses"):
        assert port.metrics[key] == jax_s.metrics[key], key
    assert (tmp_path / "torch" / "snap_00000004.snap.corrupt").exists()


def test_chaos_smoke_schedule_on_engine(models, tmp_path):
    sched_chaos = chaos.ChaosSchedule.smoke()
    eng = _engine(models, "torch")
    sched = engine.BatchScheduler(eng, chaos=sched_chaos,
                                  snapshot_dir=str(tmp_path),
                                  snapshot_every=2)
    for r in _reqs(engine, 10, base=600, max_new=24):
        sched.submit(r)
    done = sched.run()
    assert len(done) == 10
    assert sched_chaos.checks > 0
    kinds = {e["kind"] for e in sched.ft_events if e["type"] == "chaos"}
    assert "pool_exhaust" in kinds and "slow_segment" in kinds
    assert all(k in ("heartbeat_flap", "device_death", "snapshot_corrupt")
               for k in sched_chaos.summary()["skipped"])
    assert any(e["type"] == "straggler" for e in sched.ft_events)
    indexed = sum(1 for e in sched.ft_events
                  if e["type"] == "snapshot" and e["index_pages"])
    assert eng.host_syncs == sched.metrics["segments"] + indexed


def test_cancel_and_expire_events_land_on_spec_rows(models):
    """A mixed batch on a spec engine: the schedule cancels a spec row in
    flight and forces another's deadline past, in both schedulers alike;
    both rows retire with their draft pages and the closure holds."""
    runs = {}
    for impl, mod in MODS.items():
        sched = mod.BatchScheduler(
            _engine(models, impl, spec=True),
            chaos=mod_chaos(impl).ChaosSchedule(events=[
                mod_chaos(impl).ChaosEvent(segment=1, kind="cancel_request"),
                mod_chaos(impl).ChaosEvent(segment=2, kind="expire_request",
                                           device=1)]))
        for i, r in enumerate(_reqs(mod, 6, base=700, max_new=16)):
            r.spec = i % 2 == 0
            sched.submit(r)
        sched.run()
        runs[impl] = sched
    port, jax_s = runs["torch"], runs["jax"]
    assert _chaos_events(port) == _chaos_events(jax_s)
    notes = [e[2] for e in _chaos_events(port)]
    assert all("spec row" in n for n in notes), notes
    assert port.metrics["cancelled"] == port.metrics["expired"] == 1
    assert {r.rid: r.status for r in port.requests.values()} == \
        {r.rid: r.status for r in jax_s.requests.values()}
    assert _tokens(port) == _tokens(jax_s)
    port.check()
    assert port.pool.all_free()


def test_pool_relief_after_a_seizure_starves_admission(models):
    """The whole free list seized for longer than the run, no prefix
    index to evict: once the resident rows retire, admission finds
    nothing, and the scheduler returns the seized pages (``pool_relief``)
    instead of deadlocking — as the JAX scheduler does."""
    runs = {}
    for impl, mod in MODS.items():
        c = mod_chaos(impl)
        sched = mod.BatchScheduler(
            _engine(models, impl, batch_slots=2, prefix_cache=False),
            chaos=c.ChaosSchedule(events=[c.ChaosEvent(
                segment=1, kind="pool_exhaust", magnitude=1.0,
                duration=1000)]))
        for r in _reqs(mod, 5, base=800, max_new=8):
            sched.submit(r)
        sched.run()
        runs[impl] = sched
    port, jax_s = runs["torch"], runs["jax"]
    relief = [e for e in port.ft_events if e["type"] == "pool_relief"]
    assert relief and relief[0]["pages"] > 0
    assert relief == [e for e in jax_s.ft_events
                      if e["type"] == "pool_relief"]
    assert _tokens(port) == _tokens(jax_s)
    assert len(port.completed) == 5
    port.check()
    assert not port.pool.seized and port.pool.all_free()


class _ChurnHook:
    """Duck-typed chaos hook: randomized cancels + invariant closure at
    EVERY segment boundary, and a record of each aborted request's token
    count at abort time (nothing may be appended after)."""

    def __init__(self, sched_reqs, seed=3):
        self.rng = np.random.default_rng(seed)
        self.reqs = sched_reqs
        self.aborted_len = {}

    def tick(self, sched, segment):
        live = [r for r in self.reqs
                if not r.terminal and self.rng.random() < 0.2]
        for r in live[:1]:
            sched.cancel(r.rid)
        for r in self.reqs:
            if r.terminal and r.status in ("cancelled", "expired"):
                n = self.aborted_len.setdefault(r.rid, len(r.generated))
                assert len(r.generated) == n, \
                    f"request {r.rid} gained tokens after {r.status}"
        sched.check()


def test_randomized_churn_invariants(models):
    reqs = _reqs(engine, 14, base=400, max_new=20)
    for i, r in enumerate(reqs):
        r.priority = i % 3
        if i % 5 == 4:
            r.deadline_ms = 30.0
    sched = engine.BatchScheduler(_engine(models, "torch"), max_queue=8,
                                  shed_policy="shed-lowest",
                                  chaos=_ChurnHook(reqs))
    for r in reqs:
        try:
            sched.submit(r)
        except AdmissionRejected:
            pass
    sched.run()
    sched.check()
    for r in reqs:
        assert r.terminal, f"request {r.rid} ended non-terminal: {r.status}"
        assert len(r.generated) <= r.max_new_tokens
    assert set(sched.completed) | set(sched.aborted) | {
        r.rid for r in reqs if r.status == "rejected"} == {r.rid for r in reqs}


# ---------------------------------------------------------------------------
# CLI plumbing
# ---------------------------------------------------------------------------

def test_cli_robustness_flags(tmp_path):
    ap = argparse.ArgumentParser()
    cli.add_robustness_args(ap)
    args = ap.parse_args([
        "--max-queue", "7", "--shed-policy", "shed-lowest",
        "--snapshot-dir", str(tmp_path), "--snapshot-every", "4",
        "--chaos", "9"])
    rb = cli.robustness_kwargs(args)
    assert rb["max_queue"] == 7 and rb["shed_policy"] == "shed-lowest"
    assert rb["snapshot_dir"] == str(tmp_path) and rb["snapshot_every"] == 4
    assert isinstance(rb["chaos"], chaos.ChaosSchedule)
    assert rb["chaos"].seed == 9
    assert [e.kind for e in rb["chaos"].events] == \
        [e.kind for e in jax_chaos.ChaosSchedule(seed=9).events]
    assert "chaos" not in cli.robustness_kwargs(ap.parse_args([]))
    args2 = ap.parse_args(["--snapshot-every", "2"])
    with pytest.raises(ValueError, match="snapshot-dir"):
        cli.robustness_kwargs(args2)
    with pytest.raises(SystemExit):
        cli.robustness_kwargs(args2, ap)


def test_serve_launcher_json_carries_snapshots_and_chaos(tmp_path):
    out = tmp_path / "serve.json"
    snaps = tmp_path / "snaps"
    rc = serve_launcher.main([
        "--arch", "qwen2-0.5b", "--smoke-dims", "--device", "cpu",
        "--requests", "6", "--slots", "3", "--prompt-len", "6",
        "--max-new", "12", "--max-seq", "64", "--page-size", "8",
        "--shared-prefix", "9", "--max-queue", "5",
        "--snapshot-dir", str(snaps), "--snapshot-every", "1",
        "--chaos", "0", "--json", str(out)])
    assert rc == 0
    d = json.loads(out.read_text())
    assert d["rejections"] == 1 and d["requests"] == 5
    assert d["snapshots"] >= d["segments"] and d["restores"] == 0
    assert d["chaos"]["seed"] == 0 and d["chaos"]["checks"] > 0
    assert d["chaos"]["events"] == len(jax_chaos.ChaosSchedule(0).events)
    indexed = sum(1 for e in d["ft_events"]
                  if e["type"] == "snapshot" and e["index_pages"])
    assert d["host_syncs"] == d["segments"] + indexed
    assert any(e["type"] == "chaos" for e in d["ft_events"])
    with pytest.raises(SystemExit):     # --snapshot-every needs a dir
        serve_launcher.main(["--arch", "qwen2-0.5b", "--device", "cpu",
                             "--snapshot-every", "2"])
