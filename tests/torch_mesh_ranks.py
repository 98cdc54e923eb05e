"""The rank side of ``tests/test_torch_mesh_serve.py``: what each spawned
gloo rank serves.  A plain module (no test in it, no JAX import), so each
spawned process imports only torch and the port."""

import itertools
import os
import time

import numpy as np
import torch

#: the bench's config (``benchmarks/bench_mesh.py``): kvh 4, so the model
#: axis can be 1, 2 or 4 ranks
CFG = dict(name="mesh-bench", family="dense", vocab=256, d_model=64,
           n_layers=2, num_heads=8, num_kv_heads=4, d_ff=128)
SERVE = dict(max_seq=128, batch_slots=4, admission_chunk=8, page_size=16)
#: the reference bench's shapes, and two data replicas of a (1, 2) line
SHAPES = ((1, 1), (1, 2), (1, 4), (2, 2))
MAX_NEW = 10
#: the even rids' deadline in the deadline scenario: on the leader's
#: clock (a millisecond a read) two of them expire mid-run
DEADLINE_MS = 12


def prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 256, n).tolist() for n in (9, 14, 5)]


def workload():
    """(prompt, budget) per rid: more requests than slots, ragged."""
    rng = np.random.default_rng(12)
    return [(rng.integers(1, 256, int(n)).tolist(), int(b))
            for n, b in zip(rng.integers(4, 21, 7), rng.integers(6, 21, 7))]


def shared_workload():
    """Requests behind one 20-token prefix: a snapshot's prefix index
    holds its full page."""
    rng = np.random.default_rng(13)
    shared = rng.integers(1, 256, 20).tolist()
    return [(shared + rng.integers(1, 256, int(n)).tolist(), 12)
            for n in rng.integers(2, 9, 6)]


def run_sched(mod, eng, work, kill=None, **kw):
    sched = mod.BatchScheduler(eng, **kw)
    for rid, (prompt, budget) in enumerate(work):
        sched.submit(mod.Request(rid=rid, prompt=list(prompt),
                                 max_new_tokens=budget))
    if kill is not None:
        sched.inject_failure(kill, at_segment=1)
    done = sched.run()
    return sched, {rid: list(r.generated) for rid, r in done.items()}


def _summary(eng, sched, toks):
    return dict(tokens=toks, remeshes=sched.metrics.get("remeshes"),
                segments=sched.metrics["segments"],
                host_syncs=eng.host_syncs, armed=sched.heartbeats is not None,
                events=[e for e in sched.ft_events
                        if e["type"] in ("remesh", "chaos")],
                member=eng.member,
                device_ids=(list(eng.serve_mesh.device_ids)
                            if eng.serve_mesh is not None else None))


def serve_world(rank, world, init_method, weights):
    """Every scenario of the serving tests on one rank of the world."""
    from repro_torch.ft.chaos import ChaosEvent, ChaosSchedule
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM, LMConfig
    from repro_torch.serve import engine as E
    mesh_mod.init_process("cpu", init_method=init_method, rank=rank,
                          world_size=world)
    torch.set_num_threads(1)
    lm = LM(LMConfig(**CFG), torch.float32, "cpu")
    lm.load_state_dict(torch.load(weights))
    before = {k: v.clone() for k, v in lm.state_dict().items()}
    work, out = workload(), {"rank": rank}
    for kv in (None, "int8"):
        scfg = E.ServeConfig(kv_dtype=kv, **SERVE)
        plain = E.Engine(lm, scfg, device="cpu")
        out[("plain", kv)] = dict(
            generate=plain.generate(prompts(), MAX_NEW),
            tokens=run_sched(E, plain, work)[1])
        for shape in SHAPES:
            eng = E.Engine(lm, scfg, device="cpu",
                           mesh=mesh_mod.make_serve_mesh(shape))
            gen = eng.generate(prompts(), MAX_NEW)
            ref = eng.generate_reference(prompts(), MAX_NEW)
            syncs0 = eng.host_syncs
            sched, toks = run_sched(E, eng, work)
            res = _summary(eng, sched, toks)
            res.update(generate=gen, reference=ref, facts=eng.mesh_facts,
                       sched_syncs=eng.host_syncs - syncs0,
                       local_kvh=(eng.lm.block_config().attn.num_kv_heads
                                  if eng.member else None))
            out[(shape, kv)] = res
        # a rank dies mid-run: heartbeats stop, the governor confirms, the
        # spare takes its model index and the live KV moves
        sm = mesh_mod.make_serve_mesh((1, 2))
        eng = E.Engine(lm, scfg, device="cpu", mesh=sm)
        sched, toks = run_sched(E, eng, work, kill=sm.device_ids[1],
                                ft_timeout_steps=1, ft_confirm=1)
        out[("kill", kv)] = dict(_summary(eng, sched, toks),
                                 killed=sm.device_ids[1])
    # the leader of a (2, 2) mesh dies: the spare joins and the ranks
    # trade model indices (the plan reorders the survivors), the leader
    # moves, the KV follows
    scfg = E.ServeConfig(**SERVE)
    sm = mesh_mod.make_serve_mesh((2, 2))
    eng = E.Engine(lm, scfg, device="cpu", mesh=sm)
    sched, toks = run_sched(E, eng, work, kill=sm.device_ids[0],
                            ft_timeout_steps=1, ft_confirm=1)
    out["kill_leader"] = dict(_summary(eng, sched, toks),
                              killed=sm.device_ids[0])
    # chaos on a mesh: the flap is absorbed, the death re-meshes
    scfg = E.ServeConfig(**SERVE)
    eng = E.Engine(lm, scfg, device="cpu",
                   mesh=mesh_mod.make_serve_mesh((1, 2)))
    chaos = ChaosSchedule(events=[
        ChaosEvent(segment=1, kind="heartbeat_flap", device=1),
        ChaosEvent(segment=2, kind="device_death", device=1)])
    sched, toks = run_sched(E, eng, work, chaos=chaos)
    out["chaos"] = dict(_summary(eng, sched, toks),
                        skipped=list(chaos.skipped))
    # deadlines on a mesh: each rank's clock runs at its own offset and
    # rate here (a read advances rank r's by (1 + r) ms), the scheduler
    # reads the leader's, so the same requests expire at the same
    # boundaries everywhere and the ranks' collectives stay matched
    real, ticks = time.perf_counter, itertools.count()
    time.perf_counter = lambda: rank * 100.0 + next(ticks) * 1e-3 * (1 + rank)
    try:
        eng = E.Engine(lm, scfg, device="cpu",
                       mesh=mesh_mod.make_serve_mesh((1, 2)))
        sched = E.BatchScheduler(eng)
        for rid, (prompt, budget) in enumerate(work):
            sched.submit(E.Request(
                rid=rid, prompt=list(prompt), max_new_tokens=budget,
                deadline_ms=DEADLINE_MS if rid % 2 == 0 else None))
        sched.run()
    finally:
        time.perf_counter = real
    out["deadline"] = dict(
        done={rid: list(r.generated) for rid, r in sched.completed.items()},
        expired={rid: list(r.generated) for rid, r in sched.aborted.items()
                 if r.status == "expired"},
        segments=sched.metrics["segments"])
    # a bare DeviceMesh shards but arms no heartbeats
    bare = mesh_mod.make_serve_mesh((1, 2)).mesh
    eng = E.Engine(lm, scfg, device="cpu", mesh=bare)
    sched = E.BatchScheduler(eng)
    try:
        sched.inject_failure(0)
        out["bare_inject"] = None
    except RuntimeError as e:
        out["bare_inject"] = str(e)
    sched, toks = run_sched(E, eng, work)
    out["bare"] = _summary(eng, sched, toks)
    # snapshots of a model-sharded engine: the leader's file holds whole
    # kv heads (gathered over the model axis); a FRESH sharded engine
    # restores its slice of them and finishes the run
    from repro_torch.checkpoint import store
    snap = os.path.join(os.path.dirname(weights), f"snap{rank}")
    out["snapshot_plain"] = run_sched(
        E, E.Engine(lm, scfg, device="cpu"), shared_workload())[1]
    eng = E.Engine(lm, scfg, device="cpu",
                   mesh=mesh_mod.make_serve_mesh((1, 2)))
    sched = E.BatchScheduler(eng, snapshot_dir=snap, snapshot_every=1)
    for rid, (prompt, budget) in enumerate(shared_workload()):
        sched.submit(E.Request(rid=rid, prompt=prompt,
                               max_new_tokens=budget))
    sched.run(max_segments=1)
    eng2 = E.Engine(lm, scfg, device="cpu",
                    mesh=mesh_mod.make_serve_mesh((1, 2)))
    sched2 = eng2.restore(store.latest_snapshot(snap))
    sched2.run()
    restore = [e for e in sched2.ft_events if e["type"] == "restore"]
    out["snapshot"] = dict(
        tokens={rid: list(r.generated) for rid, r in sched2.requests.items()},
        index_pages=[e["index_pages"] for e in sched.ft_events
                     if e["type"] == "snapshot"],
        restored_pages=restore[0].get("index_pages") if restore else None)
    # a mesh larger than the world is refused on every rank
    try:
        mesh_mod.make_serve_mesh((2, world))
        out["too_big"] = None
    except ValueError as e:
        out["too_big"] = str(e)
    out["lm_unchanged"] = lm.tp is None and all(
        torch.equal(v, before[k]) for k, v in lm.state_dict().items())
    return out
