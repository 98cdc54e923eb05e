"""The moe family's sharding half and the moe and vlm families served on a
mesh, on the CPU, against the JAX package.

* ``moe_specs``, ``block_specs`` of an MoE block and ``LM.param_specs`` /
  ``param_pspecs`` of the moe and vlm families against the JAX functions
  on duck-typed meshes (60 experts on a model axis of 8: the
  divisibility guard leaves them whole);
* ``_block_cumsum_positions`` against the JAX function and the flat
  exclusive cumsum;
* ``moe_mlp`` with a ``constrain_fn`` against the JAX ``moe_mlp`` with
  one: the same outputs (a layout hint changes no value) and hints at
  logical axes the reference names;
* in one spawn of three gloo ranks (``tests/torch_train_mesh_ranks.py``):
  qwen2-moe-a2.7b's and qwen2-vl-7b's SMOKE configs, fp32, JAX ``LM.init``
  parameters bridged over, on a (1, 2) serving mesh plus a spare, fp32
  and int8 pages: ``generate`` (the vlm with patch embeddings) and
  ``BatchScheduler`` tokens equal the unsharded port's, which equal the
  JAX unsharded engine's; each rank holds half the experts; the moe
  model re-meshes onto the spare after a kill and its tokens stay the
  unsharded ones.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.core.features import default_features as jax_features
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.models.lm import LM as JaxLM
from repro.serve import engine as jax_engine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.lm import LM
from repro_torch.serve import engine as E

import torch_train_mesh_ranks as ranks

torch.set_num_threads(1)

FAMS = ("moe", "vlm")
KVS = (None, "int8")


class DuckMesh:
    def __init__(self, shape, names=("data", "model")):
        self.axis_names = names
        self.devices = np.empty(shape)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_moe_specs_and_block_specs_match_jax(arch):
    for cfg, jcfg in ((get_arch(arch).config, jax_get_arch(arch).config),
                      (get_arch(arch).smoke, jax_get_arch(arch).smoke)):
        assert moe.moe_specs(cfg.moe_config()) == \
            jax_moe.moe_specs(jcfg.moe_config())
        one = tf.block_specs(cfg.block_config())
        assert one == jax_tf.block_specs(jcfg.block_config())
        assert tf.stacked_specs(one) == jax_tf.stacked_specs(
            jax_tf.block_specs(jcfg.block_config()))


def _smoke_pair(arch, **change):
    import dataclasses
    cfg = dataclasses.replace(get_arch(arch).smoke, **change)
    jcfg = dataclasses.replace(jax_get_arch(arch).smoke, **change)
    return cfg, JaxLM(jcfg, jax_features().with_(remat_policy="none"))


@pytest.mark.parametrize("arch,change", [
    ("qwen2-moe-a2.7b", {}), ("qwen2-moe-a2.7b", {"moe_experts": 60}),
    ("qwen3-moe-235b-a22b", {}), ("qwen2-vl-7b", {})])
def test_param_specs_and_pspecs_match_jax(arch, change):
    cfg, jlm = _smoke_pair(arch, **change)
    lm = LM(cfg, torch.float32, "cpu")
    want = jlm.param_specs()
    got = lm.param_specs()
    assert set(got) == {n for n, _ in lm.named_parameters()}
    jshapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    for mesh in (DuckMesh((2, 2)), DuckMesh((1, 8)), DuckMesh((4, 2)),
                 DuckMesh((2, 2, 2), ("pod", "data", "model"))):
        jp = jlm.param_pspecs(mesh, jshapes)
        pp = lm.param_pspecs(mesh)
        for name, spec in got.items():
            top, rest = name.split(".", 1)
            if top == "blocks":
                _, mod, leaf = rest.split(".")
                assert ("layers",) + spec == want["blocks"][mod][leaf], name
                assert (None,) + pp[name] == tuple(jp["blocks"][mod][leaf])
            else:
                assert spec == want[top][rest], name
                assert pp[name] == tuple(jp[top][rest]), name
    if change.get("moe_experts") == 60:
        # 60 experts do not divide over 8 ranks: the guard leaves them
        # whole, and the router's expert dim with them
        pp = lm.param_pspecs(DuckMesh((1, 8)))
        assert pp["blocks.0.moe.w_gate"] == (None, "data", None)
        assert pp["blocks.0.moe.router"] == ("data", None)


@pytest.mark.parametrize("tk,e,n_blocks", [(48, 8, 256), (1000, 60, 256),
                                           (37, 5, 4), (256, 16, 16)])
def test_block_cumsum_positions_match_jax_and_the_flat_cumsum(tk, e,
                                                              n_blocks):
    rng = np.random.default_rng(tk + e)
    flat = np.zeros((tk, e), np.int32)
    flat[np.arange(tk), rng.integers(0, e, tk)] = 1
    got = moe._block_cumsum_positions(torch.from_numpy(flat), n_blocks)
    want = jax_moe._block_cumsum_positions(jnp.asarray(flat), n_blocks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  np.cumsum(flat, axis=0) - flat)


def test_moe_mlp_takes_constrain_fn_and_matches_jax():
    kw = dict(d_model=32, d_ff_expert=16, num_experts=8, top_k=2,
              num_shared_experts=1, d_ff_shared=16)
    jcfg, cfg = jax_moe.MoEConfig(**kw), moe.MoEConfig(**kw)
    jp = {k: np.asarray(v) for k, v in jax.device_get(
        jax_moe.init_moe(jax.random.PRNGKey(0), jcfg)).items()}
    m = moe.MoE(cfg, torch.float32, torch.device("cpu"))
    m.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in jp.items()})
    x = (np.random.default_rng(5).standard_normal((3, 16, 32)) + 0.5
         ).astype(np.float32)
    seen, jseen = [], []

    def hint(log):
        def fn(a, axes):
            log.append(tuple(axes))
            return a
        return fn

    jout, jaux = jax_moe.moe_mlp(jax.tree.map(jnp.asarray, jp),
                                 jnp.asarray(x), jcfg,
                                 constrain_fn=hint(jseen))
    with torch.no_grad():
        plain, paux = moe.moe_mlp(m, torch.from_numpy(x), cfg)
        out, aux = moe.moe_mlp(m, torch.from_numpy(x), cfg,
                               constrain_fn=hint(seen))
    assert torch.equal(out, plain) and torch.equal(aux, paux)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert seen and set(seen) <= set(jseen)


# ---------------------------------------------------------------------------
# serving on a mesh
# ---------------------------------------------------------------------------

def _jax_tokens(fam, jlm, jparams, kv):
    eng = jax_engine.Engine(jlm, jparams, jax_engine.ServeConfig(
        kv_dtype=kv, **ranks.SERVE))
    extra = ({"patch_embeds": ranks.patch_embeds(fam)} if fam == "vlm"
             else None)
    return (eng.generate(ranks.prompts(fam), ranks.MAX_NEW,
                         extra_batch=extra),
            ranks.run_sched(jax_engine, eng, ranks.workload(fam))[1])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX tokens, the unsharded port's, every rank's results)."""
    tmp = tmp_path_factory.mktemp("moe-mesh")
    weights, jax_want, port_want = {}, {}, {}
    for fam in FAMS:
        arch = ranks.ARCHS[fam]
        jlm = JaxLM(jax_get_arch(arch).smoke,
                    jax_features().with_(remat_policy="none"),
                    dtype=jnp.float32)
        jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
        jparams["embed"]["table"] = jparams["embed"]["table"] * 0.1
        state = params_from_jax(jparams, ranks.config(fam))
        weights[fam] = os.path.join(tmp, f"{fam}.pt")
        torch.save(state, weights[fam])
        jparams = jax.tree.map(jnp.asarray, jparams)
        lm = LM(ranks.config(fam), torch.float32, "cpu")
        lm.load_state_dict(state)
        for kv in KVS:
            jax_want[(fam, kv)] = _jax_tokens(fam, jlm, jparams, kv)
            gen, toks, _, _ = ranks.serve_tokens(E, lm, fam, kv)
            port_want[(fam, kv)] = (gen, toks)
    got = mesh_mod.spawn(ranks.serve_world, 3, args=(weights,),
                         timeout_s=120)
    return jax_want, port_want, got


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("fam", FAMS)
def test_unsharded_port_matches_jax(world, fam, kv):
    jax_want, port_want, _ = world
    assert port_want[(fam, kv)] == jax_want[(fam, kv)]
    gen, toks = port_want[(fam, kv)]
    assert len({tuple(t) for t in toks.values()}) > 3


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("fam", FAMS)
def test_sharded_engine_matches_unsharded(world, fam, kv):
    """generate and the scheduler on a (1, 2) mesh give the unsharded
    tokens on every rank, the spare included; a member holds its kv
    heads and, for the moe model, half of the 8 experts."""
    _, port_want, got = world
    kvh = ranks.config(fam).num_kv_heads
    for r in got:
        res = r[(fam, kv)]
        assert (res["generate"], res["tokens"]) == port_want[(fam, kv)]
        assert res["member"] == (r["rank"] < 2)
        assert res["facts"] == {"mesh_shape": (1, 2), "mesh_axis": "model",
                                "per_device_heads": kvh // 2}
        if res["member"]:
            assert res["local_kvh"] == kvh // 2
            assert res["experts"] == (4 if fam == "moe" else None)


def test_moe_remeshes_onto_the_spare(world):
    """Rank 1 dies at segment 1: the spare (rank 2) takes its model index,
    loads that index's experts from its host copy, and the tokens stay
    the unsharded ones."""
    _, port_want, got = world
    for r in got:
        res = r[("moe", "kill")]
        assert res["tokens"] == port_want[("moe", None)][1]
        assert res["remeshes"] == 1 and res["device_ids"] == [0, 2]
        assert res["member"] == (r["rank"] in (0, 2))
        assert res["experts"] == (4 if res["member"] else None)
