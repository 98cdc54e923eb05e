"""The port's mesh host side against the JAX package, on the CPU, in one
process.

Each case feeds the same inputs to the JAX function and to its port:
``plan_remesh`` over the reference's re-mesh scenarios
(``tests/test_elastic_edges.py``, ``tests/test_ft_checkpoint.py``),
``RemeshGovernor`` sequences, ``HeartbeatMonitor``, ``axis_ici_map`` over
pinned orders, ``logical_to_mesh`` over a grid of logical axes, mesh sizes
and dim sizes (a duck-typed mesh, as ``tests/test_mesh_serve.py`` uses),
the LM's logical specs, the registry's mesh facts and mesh-tagged tune
keys, ``make_serve_mesh``'s order and spares for worlds of 1-8 with skips
(:func:`repro_torch.launch.mesh.serve_order`) and the production mesh's
rank order.  Also the engine's mesh validation (before any process group
is needed), ``local_slice``'s blocks and the tensor-parallel pieces that
need no second rank.  The multi-rank serving tests are
``tests/test_torch_mesh_serve.py``.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import pin as jax_pin
from repro.core import topology as jax_topo
from repro.ft import elastic as jax_elastic
from repro.ft import heartbeat as jax_heartbeat
from repro.kernels import registry as jax_registry
from repro.launch import mesh as jax_mesh
from repro.models import layers as jax_layers
from repro.models.lm import LM as JaxLM
from repro.configs.qwen2_0_5b import SMOKE as JAX_SMOKE
from repro.core.features import default_features
from repro_torch.configs import get_arch
from repro_torch.configs.qwen2_0_5b import SMOKE
from repro_torch.core import topology as topo
from repro_torch.ft import elastic, heartbeat
from repro_torch.ft.elastic import local_slice
from repro_torch.kernels import registry
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers
from repro_torch.models.lm import LM
from repro_torch.serve import engine

torch.set_num_threads(1)


def _topos(n, chips_per_host=1):
    spec = dict(num_pods=1, pod_grid=topo._grid_for_count(n),
                chips_per_host=chips_per_host)
    return (topo.synthesize(topo.TopoSpec(**spec)),
            jax_topo.probe(spec=jax_topo.TopoSpec(**spec)))


PROD = (topo.synthesize(topo.PRODUCTION_SINGLE_POD),
        jax_topo.probe(spec=jax_topo.PRODUCTION_SINGLE_POD))


def _both(fn_port, fn_jax):
    """(outcome, outcome): a result or the raised error's type and text."""
    out = []
    for fn in (fn_port, fn_jax):
        try:
            out.append(fn())
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


# ---------------------------------------------------------------------------
# plan_remesh
# ---------------------------------------------------------------------------

ONE_PER_HOST = [PROD[1].chips_in_pod(0)[i * 4].device_id for i in range(64)]

PLAN_CASES = [
    # (world, chips per host, failed, axis sizes, shrink axis, strategy)
    (4, 1, [3], (1, 2), "data", "compact"),        # spares before shrink
    (4, 1, [2, 3], (1, 2), "data", "compact"),     # the last spare
    (4, 1, [1, 2, 3], (1, 2), "data", "compact"),  # cannot shrink data
    (4, 1, [0, 1, 2, 3], (1, 2), "data", "compact"),  # every device dead
    (8, 2, [0, 7], (4, 2), "data", "compact"),     # two dead hosts
    (8, 1, [5], (2, 2), "data", "scatter"),
    (3, 1, [1], (1, 2), "data", "compact"),        # the bench's kill
    (6, 1, [2], (2, 2), "data", "ring"),
    ("prod", 4, [0], (16, 16), "data", "compact"),
    ("prod", 4, [0, 100, 200], (16, 16), "data", "compact"),
    ("prod", 4, ONE_PER_HOST, (16, 16), "data", "compact"),  # unrecoverable
    ("prod", 4, [17], (16, 16), "model", "compact"),
]


@pytest.mark.parametrize("world,cph,failed,sizes,shrink,strategy",
                         PLAN_CASES)
def test_plan_remesh_matches_jax(world, cph, failed, sizes, shrink,
                                 strategy):
    ours, theirs = PROD if world == "prod" else _topos(world, cph)
    got, want = _both(
        lambda: elastic.plan_remesh(ours, failed, ("data", "model"), sizes,
                                    shrink_axis=shrink, strategy=strategy),
        lambda: jax_elastic.plan_remesh(theirs, failed, ("data", "model"),
                                        sizes, shrink_axis=shrink,
                                        strategy=strategy))
    if isinstance(want, tuple):
        assert got == want
        return
    assert (got.axis_names, got.axis_sizes, got.device_ids, got.dropped,
            got.size) == (want.axis_names, want.axis_sizes, want.device_ids,
                          want.dropped, want.size)
    assert not set(failed) & set(got.device_ids)


def test_plan_remesh_rejects_an_unknown_shrink_axis():
    ours, theirs = _topos(4)
    got, want = _both(
        lambda: elastic.plan_remesh(ours, [1], ("data", "model"), (1, 2),
                                    shrink_axis="pod"),
        lambda: jax_elastic.plan_remesh(theirs, [1], ("data", "model"),
                                        (1, 2), shrink_axis="pod"))
    assert got == want and got[0] == "ValueError"


# ---------------------------------------------------------------------------
# the governor and the heartbeat monitor
# ---------------------------------------------------------------------------

GOVERNOR_CASES = [
    # (confirm_missing, confirm_slow, [(missing, slow), ...])
    (2, 3, [({5}, ()), ((), ()), ({5}, ())]),                # flap
    (2, 3, [({5}, ()), ({5}, ()), ({5}, ())]),               # confirm once
    (2, 3, [((), {2}), ((), {2}), ((), ()), ((), {2}), ((), {2}),
            ((), {2})]),                                     # slow path
    (2, 3, [({1, 2}, ()), ({2}, ()), ({1}, ()), ({1}, ())]),  # independent
    (1, 1, [({0}, {3}), ((), {3}), ({4}, ())]),
]


@pytest.mark.parametrize("cm,cs,steps", GOVERNOR_CASES)
def test_governor_matches_jax(cm, cs, steps):
    ours = elastic.RemeshGovernor(confirm_missing=cm, confirm_slow=cs)
    theirs = jax_elastic.RemeshGovernor(confirm_missing=cm, confirm_slow=cs)
    for missing, slow in steps:
        assert ours.observe(missing=missing, slow=slow) == \
            theirs.observe(missing=missing, slow=slow)
        assert ours.confirmed == theirs.confirmed
    for bad in (dict(confirm_missing=0), dict(confirm_slow=0)):
        with pytest.raises(ValueError):
            elastic.RemeshGovernor(**bad)


@pytest.mark.parametrize("hosts,timeout,reports", [
    (3, 3, [(0, 1, 1.0), (1, 1, 1.0), (2, 1, 9.0), (0, 5, 1.0)]),
    (4, 1, [(h, s, 1.0 + h) for s in range(3) for h in range(4)
            if not (h == 2 and s > 0)]),
    (2, 2, []),
    (5, 3, [(h, 4, 1.0) for h in range(5)] + [(3, 9, 8.0)]),
])
def test_heartbeat_monitor_matches_jax(hosts, timeout, reports):
    ours = heartbeat.HeartbeatMonitor(hosts, timeout_steps=timeout)
    theirs = jax_heartbeat.HeartbeatMonitor(hosts, timeout_steps=timeout)
    for host, step, wall in reports:
        ours.report(host, step, wall, timestamp=0.0)
        theirs.report(host, step, wall, timestamp=0.0)
        assert ours.missing_hosts() == theirs.missing_hosts()
        assert ours.slow_hosts() == theirs.slow_hosts()
        assert ours.global_step() == theirs.global_step()
        assert ours.healthy() == theirs.healthy()
    assert ours.missing_hosts() == theirs.missing_hosts()


# ---------------------------------------------------------------------------
# orders: axis_ici_map, the serving mesh, the production mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,skip,shape", [
    ("compact", (), (16, 16)), ("ring", (), (16, 16)),
    ("scatter", (), (16, 16)), ("ring", (6, 7), (2, 127)),
    ("compact", (0,), (5, 51)), ("0-3,8-11", (), (2, 4)),
])
def test_axis_ici_map_matches_jax(strategy, skip, shape):
    ours, theirs = PROD
    order = jax_pin.get_strategy(strategy)(theirs, skip=skip)
    ids = list(order.device_ids[:int(np.prod(shape))])
    assert mesh_mod.axis_ici_map(ours, ids, shape, ("data", "model")) == \
        jax_mesh.axis_ici_map(theirs, ids, shape, ("data", "model"))


class _Dev:
    def __init__(self, i):
        self.id = i
        self.device_kind = "cpu"


SERVE_CASES = [(w, shape, pin, skip)
               for w in range(1, 9)
               for shape in ((1, 1), (1, 2), (1, 4), (2, 2))
               for pin, skip in (("compact", ()), ("ring", (0,)),
                                 ("scatter", (w - 1,)))
               if int(np.prod(shape)) <= w]


@pytest.mark.parametrize("world,shape,pin,skip", SERVE_CASES)
def test_serve_order_matches_jax(world, shape, pin, skip):
    """make_serve_mesh's order and spares for a world of ``world`` ranks:
    the JAX package's pin over its probe of ``world`` CPU devices."""
    spec = jax_topo.TopoSpec(num_pods=1,
                             pod_grid=jax_topo._grid_for_count(world),
                             chips_per_host=1)
    jtopo = jax_topo.probe([_Dev(i) for i in range(world)], spec=spec)
    result = jax_pin.get_strategy(pin)(jtopo, skip=skip)
    need = int(np.prod(shape))
    if len(result.device_ids) < need:
        with pytest.raises(ValueError, match="mesh needs"):
            mesh_mod.serve_order(world, shape, pin_strategy=pin, skip=skip)
        return
    ours, res, used, spares = mesh_mod.serve_order(
        world, shape, pin_strategy=pin, skip=skip)
    assert used == tuple(result.device_ids[:need])
    assert spares == tuple(result.skipped) + tuple(result.device_ids[need:])
    assert (res.device_ids, res.strategy, res.skipped) == \
        (tuple(result.device_ids), result.strategy, tuple(result.skipped))
    assert [(c.device_id, c.host, c.coords) for c in ours.chips] == \
        [(c.device_id, c.host, c.coords) for c in jtopo.chips]


@pytest.mark.parametrize("multi_pod,pin,skip", [
    (False, None, ()), (False, "ring", ()), (False, "scatter", (6, 7)),
    (False, "compact", (0, 1, 2, 3)), (True, "ring", ()),
    (True, None, ()),
])
def test_production_order_matches_jax(multi_pod, pin, skip):
    shape, axes = mesh_mod.mesh_axes(multi_pod)
    assert (shape, axes) == jax_mesh.mesh_axes(multi_pod)
    need = int(np.prod(shape))
    if pin is None and not skip:
        want = list(range(need))
    else:
        want = list(jax_pin.get_strategy(pin or "compact")(
            jax_mesh.production_topology(multi_pod),
            skip=skip).device_ids)
    if len(want) < need:
        with pytest.raises(ValueError, match="mesh needs"):
            mesh_mod.production_order(multi_pod=multi_pod,
                                      pin_strategy=pin, skip=skip)
        return
    assert mesh_mod.production_order(multi_pod=multi_pod, pin_strategy=pin,
                                     skip=skip) == want[:need]


def test_production_mesh_needs_its_world():
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        mesh_mod.make_production_mesh()
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, pin_strategy="ring")


def test_make_serve_mesh_needs_the_process_group(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_process"):
        mesh_mod.make_serve_mesh((1, 1))
    with pytest.raises(ValueError, match="torchrun"):
        mesh_mod.init_process("cpu", world_size=2)


def test_leave_process_group_forgets_the_world():
    """A world of one formed and left: no group, the CPU as the rank's
    device, and a second ``init_process`` forms a new group."""
    for _ in range(2):
        assert mesh_mod.init_process("cpu") == torch.device("cpu")
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_world_size() == 1
        mesh_mod.leave_process_group()
        assert not torch.distributed.is_initialized()
        assert mesh_mod.rank_device() == torch.device("cpu")
        assert not mesh_mod._RANK_DEVICE
    mesh_mod.leave_process_group()                  # no group: a no-op


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

class DuckMesh:
    def __init__(self, shape, names=("data", "model")):
        self.axis_names = names
        self.devices = np.empty(shape)


LOGICAL = [("embed", "heads", "head_dim"), ("vocab", "embed"),
           ("batch", "act_seq", "vocab"), ("batch", "cache_seq"),
           ("ff", "embed"), ("kv_heads", "head_dim"), ("experts", None),
           ("batch", "embed", "ff"), (None, "act_embed")]
MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((1, 3), ("data", "model"))]
DIMS = [None, (32, 14, 64), (8, 896), (12, 151936), (4, 4864), (2, 3, 5)]


@pytest.mark.parametrize("logical,mesh", itertools.product(LOGICAL, MESHES))
def test_logical_to_mesh_matches_jax(logical, mesh):
    shape, names = mesh
    duck = DuckMesh(shape, names)
    for dims in DIMS:
        if dims is not None and len(dims) != len(logical):
            dims = (dims * 3)[:len(logical)]
        for rules in (layers.DEFAULT_RULES,
                      layers.DEFAULT_RULES.replace(embed=None,
                                                   act_seq=("model",))):
            jrules = jax_layers.ShardingRules(rules.rules)
            got = layers.logical_to_mesh(logical, rules, duck, dims)
            want = jax_layers.logical_to_mesh(logical, jrules, duck, dims)
            assert got == tuple(want), (logical, shape, dims)


def test_param_specs_and_pspecs_match_jax():
    jlm = JaxLM(JAX_SMOKE, default_features().with_(remat_policy="none"))
    want = jlm.param_specs()
    lm = LM(SMOKE, torch.float32, "cpu")
    got = lm.param_specs()
    assert set(got) == {n for n, _ in lm.named_parameters()}
    duck = DuckMesh((2, 2))
    jshapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    jp = jlm.param_pspecs(duck, jshapes)
    pp = lm.param_pspecs(duck)
    for name, spec in got.items():
        top, rest = name.split(".", 1)
        if top == "blocks":
            _, mod, leaf = rest.split(".")
            assert ("layers",) + spec == want["blocks"][mod][leaf]
            assert (None,) + pp[name] == tuple(jp["blocks"][mod][leaf])
        else:
            assert spec == want[top][rest]
            assert pp[name] == tuple(jp[top][rest])
    from repro_torch.models import transformer as tf
    from repro.models import transformer as jtf
    assert tf.stacked_specs(tf.block_specs(SMOKE.block_config())) == \
        jtf.stacked_specs(jtf.block_specs(JAX_SMOKE.block_config()))
    # every family has specs now (tests/test_torch_family_mesh.py); an
    # unknown family is refused before any spec is asked for
    with pytest.raises(ValueError, match="unknown family"):
        LM(dataclasses.replace(SMOKE, family="rnn"), torch.float32, "cpu")


def test_constrain_resolves_its_spec_and_returns_x():
    x = torch.zeros(4, 6)
    assert layers.constrain(x, ("batch", "vocab"), layers.DEFAULT_RULES,
                            None) is x
    assert layers.constrain(x, ("batch", "vocab"), layers.DEFAULT_RULES,
                            DuckMesh((2, 3))) is x


@pytest.mark.parametrize("shape,spec", [
    ((1, 2), (None, "model", None)), ((2, 2), ("data", "model", None)),
    ((2, 4), (("data", "model"), None, None)), ((4, 2), (None, None, None)),
    ((2, 2), (None, ("model", "data"), None)),
])
def test_local_slices_tile_the_tensor(shape, spec):
    """Every rank's block, laid out by its coordinate, gives back the
    tensor: the layout a NamedSharding gives the same spec."""
    full = torch.arange(8 * 8 * 3).reshape(8, 8, 3)
    names = ("data", "model")
    seen = torch.zeros_like(full)
    for coord in itertools.product(*(range(s) for s in shape)):
        blk = local_slice(full, spec, names, shape, coord)
        pos = dict(zip(names, coord))
        size = dict(zip(names, shape))
        index = []
        for d, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            k = 0
            for a in axes:
                k = k * size[a] + pos[a]
            index.append(slice(k * blk.shape[d], (k + 1) * blk.shape[d]))
        seen[tuple(index)] = blk
        assert torch.equal(full[tuple(index)], blk)
    assert torch.equal(seen, full)
    with pytest.raises(ValueError, match="does not split"):
        local_slice(torch.zeros(3, 2), ("model", None), names, (1, 2),
                    (0, 1))


class _Axis:
    """A model axis of one rank, as a world of one has."""

    def __init__(self, size, index):
        self.size, self.index = size, index

    def all_reduce(self, x, op="sum"):
        return x

    def all_gather(self, x, dim=-1):
        return x


def test_embed_lookup_takes_the_rank_rows():
    table = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    toks = torch.tensor([[0, 3, 4, 7]])
    full = layers.embed_lookup(table, toks)
    assert torch.equal(full, table[toks])
    parts = [layers.embed_lookup(table[4 * i:4 * (i + 1)], toks,
                                 _Axis(2, i)) for i in range(2)]
    assert torch.equal(parts[0] + parts[1], full)
    assert torch.equal(parts[0][0, 2:], torch.zeros(2, 3))


def test_sharded_lm_holds_the_rank_sizes():
    cfg = dataclasses.replace(SMOKE, num_heads=8, num_kv_heads=4,
                              head_dim=SMOKE.resolved_head_dim, vocab=256)
    lm = LM(cfg, torch.float32, "cpu", tp=_Axis(2, 1))
    bc = lm.block_config()
    assert (bc.attn.num_heads, bc.attn.num_kv_heads, bc.attn.head_dim) == \
        (cfg.num_heads // 2, cfg.num_kv_heads // 2, cfg.resolved_head_dim)
    assert lm.blocks[0].attn.wq.shape[1] == cfg.num_heads // 2
    assert lm.embed.table.shape[0] == lm.local_vocab == cfg.vocab // 2
    assert bc.tp is not None and (bc.tp_mlp is not None) == (
        cfg.d_ff % 2 == 0)
    st = lm.init_decode_state(2, 32, page_size=8)
    assert st["caches"].k_pages.shape[-2] == cfg.num_kv_heads // 2
    # every family shards (tests/test_torch_moe_mesh.py,
    # tests/test_torch_family_mesh.py); a head count the model axis does
    # not divide is refused, the hybrid's kv heads first
    with pytest.raises(ValueError, match="num_kv_heads=4 does not divide"):
        LM(get_arch("zamba2-1.2b").smoke, torch.float32, "cpu",
           tp=_Axis(3, 0))
    with pytest.raises(ValueError, match="num_kv_heads"):
        LM(cfg, torch.float32, "cpu", tp=_Axis(3, 0))
    # a tensor-parallel LM trains (tests/test_torch_train_mesh.py); the
    # xlstm family splits its mLSTM heads, which the axis must divide
    with pytest.raises(ValueError, match="num_heads=4 does not divide"):
        LM(get_arch("xlstm-350m").smoke, torch.float32, "cpu",
           tp=_Axis(3, 0), dp=_Axis(2, 0))


def test_quantize_rows_take_the_whole_row_amax():
    rng = np.random.default_rng(3)
    seq = torch.from_numpy(rng.standard_normal((2, 5, 4, 8), np.float32))
    from repro_torch.models.attention import quantize_kv_rows

    class MaxAxis(_Axis):
        def all_reduce(self, x, op="sum"):
            assert op == "max"
            return seq.abs().amax(dim=(-2, -1))

    codes, scale = quantize_kv_rows(seq)
    half, hscale = quantize_kv_rows(seq[..., 2:, :], MaxAxis(2, 1))
    assert torch.equal(hscale, scale)
    assert torch.equal(half, codes[..., 2:, :])


# ---------------------------------------------------------------------------
# the registry's mesh facts
# ---------------------------------------------------------------------------

def test_mesh_key_tag_matches_jax():
    for kw in ({}, dict(mesh_shape=None, per_device_heads=3),
               dict(mesh_shape=(1, 2), mesh_axis="model",
                    per_device_heads=2),
               dict(mesh_shape=(2, 4), per_device_heads=None),
               dict(mesh_shape=(1, 1), mesh_axis="data",
                    per_device_heads=0)):
        assert registry.mesh_key_tag(**kw) == jax_registry.mesh_key_tag(**kw)
    assert registry.mesh_key_tag(mesh_shape=(1, 2), mesh_axis="model",
                                 per_device_heads=2) == "-mesh1x2.model.pdh2"
    assert registry.MESH_FACTS == jax_registry.MESH_FACTS


MESH_KW = [{}, dict(mesh_shape=(1, 2), mesh_axis="model",
                    per_device_heads=1),
           dict(mesh_shape=(2, 4), mesh_axis="model", per_device_heads=2)]


@pytest.mark.parametrize("mesh_kw", MESH_KW)
def test_mesh_tagged_tune_keys_match_jax(mesh_kw):
    """Byte-identical keys both ways: unsharded keys as before the mesh
    (every written record stays warm), sharded ones tagged alike."""
    att = dict(b=3, h=4, kvh=2, sq=8, sk=8, dh=8, causal=True,
               backend="cuda")
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        assert registry.attention_tune_key(dtype=dt, **att, **mesh_kw) == \
            jax_registry.attention_tune_key(dtype=jdt, **att, **mesh_kw)
        for q8 in (False, True):
            pg = dict(b=4, kvh=2, g=7, dh=64, ctx=300, quantized=q8,
                      backend="cuda")
            assert registry.paged_lookup_key(
                dtype=dt, page_size=16, **pg, **mesh_kw) == \
                jax_registry.paged_lookup_key(dtype=jdt, page_size=16, **pg,
                                              **mesh_kw)
            assert registry.paged_sweep_key(dtype=dt, **pg, **mesh_kw) == \
                jax_registry.paged_sweep_key(dtype=jdt, **pg, **mesh_kw)
    base = dict(b=1, h=4, kvh=2, sq=8, sk=8, dh=8, dtype=torch.float32)
    assert registry.attention_tune_key(**base) == \
        registry.attention_tune_key(**base, mesh_shape=None)
    assert registry._unsharded_fallback(mesh_kw) == \
        jax_registry._unsharded_fallback(mesh_kw)


def test_use_mesh_facts_scoping_and_validation():
    for mod in (registry, jax_registry):
        assert mod.mesh_facts() == {}
        with mod.use_mesh_facts(mesh_shape=(1, 2), per_device_heads=2):
            assert mod.mesh_facts() == {"mesh_shape": (1, 2),
                                        "per_device_heads": 2}
            with mod.use_mesh_facts(per_device_heads=1):    # inner wins
                assert mod.mesh_facts()["per_device_heads"] == 1
                assert mod.mesh_facts()["mesh_shape"] == (1, 2)
            assert mod.mesh_facts()["per_device_heads"] == 2
        assert mod.mesh_facts() == {}
        with pytest.raises(ValueError, match="unknown mesh facts"):
            with mod.use_mesh_facts(mesh_rank=2):
                pass
        with mod.use_mesh_facts(mesh_shape=None):           # None dropped
            assert mod.mesh_facts() == {}


def test_best_keys_per_sharding_and_falls_back_to_unsharded():
    facts = dict(b=1, h=4, kvh=2, sq=64, sk=64, dh=8, dtype=torch.float32,
                 backend="cpu")
    try:
        registry.record("attention", registry.attention_tune_key(**facts),
                        (32, 32))
        with registry.use_mesh_facts(mesh_shape=(1, 2), mesh_axis="model",
                                     per_device_heads=1):
            # no record for THIS sharding: the unsharded bucket is the
            # neighbour of last resort
            assert registry.best("attention", **facts) == (32, 32)
            assert registry.resolve("attention", **facts)[1] == "neighbour"
            registry.record("attention", registry.attention_tune_key(
                **facts, **registry.mesh_facts()), (64, 64))
            assert registry.best("attention", **facts) == (64, 64)
        # the memo keys on the ambient facts: unsharded is unchanged
        assert registry.best("attention", **facts) == (32, 32)
    finally:
        registry.clear_tune_table()


def test_supports_rejects_indivisible_head_sharding():
    for family, impl in (("attention", "cuda_flash"),
                         ("paged_decode", "cuda_paged")):
        sup = registry.get_spec(family, impl).supports
        assert sup(per_device_heads=1)
        assert not sup(per_device_heads=0)
        assert sup(per_device_heads=None)
    q8 = registry.get_spec("paged_decode", "cuda_paged_q8").supports
    assert q8(quantized=True, per_device_heads=2)
    assert not q8(quantized=True, per_device_heads=0)


# ---------------------------------------------------------------------------
# the engine's mesh validation (no process group needed)
# ---------------------------------------------------------------------------

class FakeMesh:
    def __init__(self, model=3, names=("data", "model")):
        self.axis_names = names
        self.shape = {n: (model if n == "model" else 1) for n in names}


@pytest.mark.parametrize("arch,mesh,err,match", [
    ("qwen2-0.5b", FakeMesh(1, ("data",)), ValueError, "'model' axis"),
    ("qwen2-0.5b", FakeMesh(3), ValueError, "num_kv_heads"),
    ("seamless-m4t-medium", FakeMesh(3), ValueError, "num_kv_heads"),
    ("zamba2-1.2b", FakeMesh(1, ("data",)), ValueError, "'model' axis"),
    ("xlstm-350m", FakeMesh(3), ValueError, "num_kv_heads"),
])
def test_engine_mesh_validation(arch, mesh, err, match):
    lm = LM(get_arch(arch).smoke, torch.float32, "cpu")
    with pytest.raises(err, match=match):
        engine.Engine(lm, engine.ServeConfig(), device="cpu", mesh=mesh)


def test_engine_refuses_spec_on_a_mesh():
    from repro_torch.serve.spec import SpecConfig
    lm = LM(SMOKE, torch.float32, "cpu")
    spec = SpecConfig(draft_config=SMOKE, num_draft_tokens=2)
    with pytest.raises(ValueError, match="speculative decoding on a "
                                         "sharded engine"):
        engine.Engine(lm, engine.ServeConfig(page_size=8), device="cpu",
                      mesh=FakeMesh(1), spec=spec, draft_lm=lm)
