"""Sharded serving on the CPU: five spawned gloo ranks over a ``file://``
store (no network), against the unsharded port and the JAX package's
unsharded engine.

The bench's config (``benchmarks/bench_mesh.py``: d 64, 8 heads over 4,
fp32, pages of 16) with the JAX ``LM.init`` parameters bridged over (the
embedding scaled by 0.1 on both sides, so the random model does not echo
its input).  The JAX package's own sharded engine fails on this jax
(``tests/test_mesh_serve.py``, ``ROADMAP.md`` queue 3), so the port's
sharded tokens are held to the invariant the reference's tests state:
sharded tokens equal unsharded tokens, and the port's unsharded tokens
equal the JAX unsharded engine's.  In one spawn (``tests/
torch_mesh_ranks.py``), every rank runs: ``(1, 1)``, ``(1, 2)`` and
``(1, 4)`` meshes, and ``(2, 2)`` (two data replicas of a model line),
through ``generate``, ``generate_reference`` and ``BatchScheduler`` on
fp32 and int8 pages; a killed rank with spares; chaos's
``heartbeat_flap`` and ``device_death``; deadlines under ranks' clocks
that disagree; a bare ``DeviceMesh``; a
snapshot of a (1, 2) engine restored on a fresh one; a mesh larger than
the world.  The tests read the ranks' results.
"""

import os

import jax
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from repro.core.features import default_features
from repro.models.lm import LM as JaxLM
from repro.models.lm import LMConfig as JaxLMConfig
from repro.serve import engine as jax_engine
from repro_torch.bridge import params_from_jax
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.lm import LMConfig

import torch_mesh_ranks as ranks

torch.set_num_threads(1)

WORLD = 5
KVS = (None, "int8")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX tokens per kv dtype, every rank's results)."""
    tmp = tmp_path_factory.mktemp("mesh")
    jlm = JaxLM(JaxLMConfig(**ranks.CFG),
                default_features().with_(remat_policy="none"),
                dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * 0.1
    weights = os.path.join(tmp, "weights.pt")
    torch.save(params_from_jax(jparams, LMConfig(**ranks.CFG)), weights)
    jparams = jax.tree.map(jnp.asarray, jparams)
    want = {}
    for kv in KVS:
        eng = jax_engine.Engine(jlm, jparams, jax_engine.ServeConfig(
            kv_dtype=kv, **ranks.SERVE))
        want[kv] = dict(
            generate=eng.generate(ranks.prompts(), ranks.MAX_NEW),
            tokens=ranks.run_sched(jax_engine, eng, ranks.workload())[1])
    got = mesh_mod.spawn(ranks.serve_world, WORLD, args=(weights,),
                         timeout_s=240)
    return want, got


@pytest.mark.parametrize("kv", KVS)
def test_unsharded_port_matches_jax(world, kv):
    want, got = world
    for r in got:
        assert r[("plain", kv)]["generate"] == want[kv]["generate"]
        assert r[("plain", kv)]["tokens"] == want[kv]["tokens"]
    assert len({tuple(t) for t in want[kv]["tokens"].values()}) > 3


@pytest.mark.parametrize("shape", ranks.SHAPES)
@pytest.mark.parametrize("kv", KVS)
def test_sharded_generate_matches_unsharded(world, shape, kv):
    want, got = world
    for r in got:
        res = r[(shape, kv)]
        assert res["generate"] == want[kv]["generate"]
        assert res["reference"] == want[kv]["generate"]
        assert res["facts"] == {"mesh_shape": shape, "mesh_axis": "model",
                                "per_device_heads": 4 // shape[1]}
        in_mesh = r["rank"] < shape[0] * shape[1]
        assert res["member"] == in_mesh
        assert res["local_kvh"] == (4 // shape[1] if in_mesh else None)
        assert res["device_ids"] == list(range(shape[0] * shape[1]))


@pytest.mark.parametrize("shape", ranks.SHAPES)
@pytest.mark.parametrize("kv", KVS)
def test_sharded_scheduler_matches_unsharded(world, shape, kv):
    """Tokens equal on every rank, spares included; a healthy run ticks
    the heartbeats every segment and never re-meshes; one host sync (the
    leader's broadcast) a segment."""
    want, got = world
    for r in got:
        res = r[(shape, kv)]
        assert res["tokens"] == want[kv]["tokens"]
        assert res["armed"] and res["remeshes"] == 0 and res["events"] == []
        assert res["sched_syncs"] == res["segments"] > 1


@pytest.mark.parametrize("kv", KVS)
def test_kill_with_a_spare_remeshes_once(world, kv):
    want, got = world
    for r in got:
        res = r[("kill", kv)]
        assert res["tokens"] == want[kv]["tokens"]
        assert res["remeshes"] == 1
        (ev,) = res["events"]
        assert ev["type"] == "remesh" and ev["failed"] == [res["killed"]]
        assert res["killed"] not in ev["device_ids"]
        assert ev["device_ids"] == res["device_ids"] == [0, 2]
        assert ev["axis_sizes"] == [1, 2] and ev["spares"] == [3, 4]
        assert ev["remesh_latency_s"] > 0
        assert res["member"] == (r["rank"] in (0, 2))


def test_a_dead_leader_reshuffles_the_mesh(world):
    """Rank 0 of a (2, 2) mesh dies: the plan reorders the survivors and
    the spare, ranks take model indices they did not hold, the leader
    moves, and the tokens stay the unsharded ones."""
    want, got = world
    held = {0: 0, 1: 1, 2: 0, 3: 1}
    for r in got:
        res = r["kill_leader"]
        assert res["tokens"] == want[None]["tokens"]
        (ev,) = res["events"]
        assert ev["failed"] == [0] and 0 not in ev["device_ids"]
        assert ev["axis_sizes"] == [2, 2] and sorted(ev["device_ids"]) == \
            [1, 2, 3, 4]
        moved = [d for i, d in enumerate(ev["device_ids"])
                 if held.get(d) != i % 2]
        assert moved                    # some rank changed its index
        assert res["member"] == (r["rank"] != 0)


def test_chaos_flap_absorbed_and_death_remeshes(world):
    want, got = world
    for r in got:
        res = r["chaos"]
        assert res["tokens"] == want[None]["tokens"]
        assert res["skipped"] == []
        kinds = [(e["type"], e.get("kind")) for e in res["events"]]
        assert kinds[:2] == [("chaos", "heartbeat_flap"),
                             ("chaos", "device_death")]
        assert res["remeshes"] == 1 and kinds[2] == ("remesh", None)
        assert 1 not in res["events"][2]["device_ids"]


def test_deadlines_expire_alike_on_every_rank(world):
    """Every rank's clock runs at its own offset and rate: the scheduler
    reads the leader's, so each rank expires the same requests at the
    same boundaries (one expired mid-flight with tokens delivered), the
    ranks' collectives stay matched, and every request that finishes has
    the unsharded tokens."""
    want, got = world
    first = got[0]["deadline"]
    assert all(r["deadline"] == first for r in got)
    assert first["done"] and first["expired"]
    assert not set(first["done"]) & set(first["expired"])
    assert all(rid % 2 == 0 for rid in first["expired"])
    assert any(first["expired"].values())      # expired in flight
    full = want[None]["tokens"]
    for rid, toks in first["done"].items():
        assert toks == full[rid]
    for rid, toks in first["expired"].items():
        assert toks == full[rid][:len(toks)]


def test_bare_mesh_shards_without_heartbeats(world):
    want, got = world
    for r in got:
        assert "ServeMesh" in r["bare_inject"]
        res = r["bare"]
        assert not res["armed"] and res["remeshes"] is None
        assert res["tokens"] == want[None]["tokens"]


def test_snapshot_of_a_sharded_engine_restores(world):
    """The snapshot's pages hold whole kv heads; a fresh (1, 2) engine
    restores its heads of them and finishes with the unsharded tokens."""
    _, got = world
    for r in got:
        res = r["snapshot"]
        assert res["tokens"] == r["snapshot_plain"]
        assert res["index_pages"] and max(res["index_pages"]) > 0
        assert res["restored_pages"]


def test_validation_and_the_shared_lm(world):
    _, got = world
    for r in got:
        assert "mesh needs" in r["too_big"]
        assert r["lm_unchanged"]
