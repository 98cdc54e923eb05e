"""The decode state's layouts, on the CPU, against the JAX package.

* ``LM.state_specs`` equals the JAX ``LM.state_specs`` leaf by leaf for
  every arch's SMOKE state (a cache's ``length``, which the port holds
  once for every layer, takes the stacked leaf's axes without
  ``"layers"``);
* ``LM.state_pspecs`` equals the JAX ``logical_to_mesh`` of those axes
  on duck meshes (16, 16) and (2, 16, 16), at the decode_32k and
  long_500k sizes, under the default rules and ``kv_shard="headdim"``'s;
* the dry run's meta walk cuts a decode cell's state by them: the KV
  cache of ``qwen2-0.5b/decode_32k/16x16`` a rank and the shared block's
  caches of ``zamba2-1.2b/long_500k/16x16``, computed from the configs,
  and the ``headdim`` layout's cut of the qwen2 cell;
* ``walk.unported`` is empty for every decode cell under both layouts
  and for the ``train_4k`` cells ``TRAIN_POLICY`` runs with sequence
  parallelism (cut to two layers), whose walks declare reduce-scatters;
  the CLI's ``--kv-shard`` and ``--sp`` reach the records.

Never imports ``repro.launch.dryrun``: it sets ``XLA_FLAGS`` for 512 host
devices at import.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jax_layers
from repro.models.lm import LM as JaxLM
from repro_torch.configs import ALL_ARCH_IDS, SHAPES, get_arch
from repro_torch.launch import dryrun
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.layers import DEFAULT_RULES
from repro_torch.models.lm import LM

torch.set_num_threads(1)


class DuckMesh:
    def __init__(self, shape, names=("data", "model")):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
HEADDIM = dict(cache_seq=("data",), head_dim=("model",), heads=None,
               kv_heads=None)


def _is_axes(x):
    """A leaf of a spec tree: per dim a name, None or a tuple of names."""
    return type(x) is tuple and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _port_leaves(tree, path=""):
    """(JAX key string, leaf) of a port state or spec tree."""
    if isinstance(tree, (KVCache, PagedKVCache)):
        for f, v in zip(tree._fields, tree):
            if v is not None:
                yield from _port_leaves(v, f"{path}.{f}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and not _is_axes(tree):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_axes)[0]}


def _shared(path):
    return path.endswith((".length", ".page_table"))


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_state_specs_match_jax_leaf_by_leaf(arch):
    jlm = JaxLM(jax_get_arch(arch).smoke, dtype=jnp.float32)
    want = _jax_leaves(jlm.state_specs(
        jax.eval_shape(lambda: jlm.init_decode_state(2, 16))))
    lm = LM(get_arch(arch).smoke, torch.float32, "cpu")
    got = dict(_port_leaves(lm.state_specs(lm.init_decode_state(2, 16))))
    assert set(got) == set(want)
    for path, axes in got.items():
        ref = tuple(want[path])
        assert axes == (ref[1:] if _shared(path) else ref), path


@pytest.mark.parametrize("headdim", [False, True])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_state_pspecs_match_jax_logical_to_mesh(arch, shape, headdim):
    s = SHAPES[shape]
    jlm = JaxLM(jax_get_arch(arch).config)
    jstate = jax.eval_shape(
        lambda: jlm.init_decode_state(s.global_batch, s.seq_len))
    jspecs = _jax_leaves(jlm.state_specs(jstate))
    jshapes = {jax.tree_util.keystr(p): v.shape for p, v in
               jax.tree_util.tree_flatten_with_path(jstate)[0]}
    jrules = jax_layers.DEFAULT_RULES
    rules = DEFAULT_RULES
    if headdim:
        jrules, rules = jrules.replace(**HEADDIM), rules.replace(**HEADDIM)
    lm = LM(get_arch(arch).config, torch.bfloat16, "meta")
    state = lm.init_decode_state(s.global_batch, s.seq_len)
    for dims, names in MESHES.values():
        mesh = DuckMesh(dims, names)
        got = dict(_port_leaves(lm.state_pspecs(state, mesh, rules)))
        assert set(got) == set(jspecs)
        for path, spec in got.items():
            want = tuple(jax_layers.logical_to_mesh(
                jspecs[path], jrules, mesh, dim_sizes=jshapes[path]))
            assert spec == (want[1:] if _shared(path) else want), path


@pytest.fixture(scope="module")
def cells():
    hd = dryrun.TrainPolicy(accum_steps=8, kv_shard="headdim")
    return {
        "qwen2": dryrun.run_cell("qwen2-0.5b", "decode_32k", False,
                                 verbose=False),
        "zamba2": dryrun.run_cell("zamba2-1.2b", "long_500k", False,
                                  verbose=False),
        "qwen2-headdim": dryrun.run_cell("qwen2-0.5b", "decode_32k", False,
                                         verbose=False, policy_override=hd),
    }


def test_fault_3_the_decode_walk_holds_the_reference_cut(cells):
    """decode_32k: 128 rows over data (8 a rank), 32768 positions over
    model (2048), both kv heads; long_500k: one row, the sequence over
    both axes (2048 of 524288), every kv head (kv_heads finds model
    taken)."""
    q = get_arch("qwen2-0.5b").config
    s = SHAPES["decode_32k"]
    rec = cells["qwen2"]
    assert rec["status"] == "ok" and rec["walk"]["unported"] == {}
    want = (q.n_layers, s.global_batch // 16, s.seq_len // 16,
            q.num_kv_heads, q.resolved_head_dim)
    assert rec["walk"]["kv_cache_shape"] == list(want)
    assert rec["walk"]["kv_cache_bytes"] == 2 * 2 * int(np.prod(want)) \
        == 201326592
    assert rec["walk"]["cache_seq"] == {"model": 16}
    # the weights' model axis walks 2 ranks (two kv heads), the sequence 16
    assert rec["walk"]["mesh_walked"] == {"data": 16, "model": 2}

    z = get_arch("zamba2-1.2b").config
    s = SHAPES["long_500k"]
    rec = cells["zamba2"]
    groups = len(range(0, z.n_layers, z.attn_every))
    want = (groups, 1, s.seq_len // 256, z.num_kv_heads,
            z.resolved_head_dim)
    assert rec["walk"]["kv_cache_shape"] == list(want)
    assert rec["walk"]["kv_cache_bytes"] == 2 * 2 * int(np.prod(want)) \
        == 117440512
    assert rec["walk"]["cache_seq"] == {"data": 16, "model": 16}


def test_headdim_walk_cuts_the_head_dim(cells):
    q = get_arch("qwen2-0.5b").config
    s = SHAPES["decode_32k"]
    rec = cells["qwen2-headdim"]
    assert rec["status"] == "ok" and rec["walk"]["unported"] == {}
    assert rec["policy"]["kv_shard"] == "headdim"
    want = (q.n_layers, s.global_batch // 16, s.seq_len, q.num_kv_heads,
            q.resolved_head_dim // 16)
    assert rec["walk"]["kv_cache_shape"] == list(want)
    assert rec["walk"]["kv_cache_bytes"] == 2 * 2 * int(np.prod(want))
    assert rec["walk"]["cache_seq"] == {}
    assert rec["walk"]["mesh_walked"] == {"data": 16, "model": 16}
    assert rec["collectives"]["ICI_AR_COUNT"] > 0


@pytest.mark.parametrize("kv_shard", ["seq", "headdim"])
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_every_decode_cell_walks_both_layouts(arch, kv_shard):
    pol = dryrun.TrainPolicy(kv_shard=kv_shard)
    for shape in ("decode_32k", "long_500k"):
        rec = dryrun.run_cell(arch, shape, False, verbose=False,
                              policy_override=pol)
        if rec["status"] == "skipped":
            continue
        assert rec["status"] == "ok", rec.get("trace")
        assert rec["walk"]["unported"] == {}
        assert rec["walk"]["kv_cache_bytes"] is not None


@pytest.mark.parametrize("arch", ["mistral-large-123b",
                                  "qwen3-moe-235b-a22b", "qwen2-vl-7b"])
def test_sequence_parallel_train_walks(arch):
    assert dryrun.TRAIN_POLICY[arch].sequence_parallel
    rec = dryrun.run_cell(arch, "train_4k", False, verbose=False,
                          config_overrides={"n_layers": 2})
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["walk"]["unported"] == {}
    assert rec["policy"]["sequence_parallel"]
    coll = rec["collectives"]
    assert coll["ICI_RS_COUNT"] > 0 and coll["ICI_RS_BYTES"] > 0
    off = dryrun.run_cell(
        arch, "train_4k", False, verbose=False,
        config_overrides={"n_layers": 2},
        policy_override=dryrun.dataclasses.replace(
            dryrun.TRAIN_POLICY[arch], sequence_parallel=False))
    assert off["collectives"]["ICI_RS_COUNT"] == 0


def test_cli_sets_kv_shard_and_sp(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))
    out = str(tmp_path / "recs")
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--kv-shard", "headdim", "--sp", "1",
                        "--out", out]) == 0
    rec = json.load(open(f"{out}/qwen2-0.5b__decode_32k__16x16.json"))
    assert rec["policy"]["kv_shard"] == "headdim"
    assert rec["policy"]["sequence_parallel"] is True
    assert rec["walk"]["unported"] == {}


def test_dense_decode_without_a_layout_skips_the_slice_arithmetic():
    """The engine's dense decode (no mesh, no ``KVLayout``) and a layout's
    first sequence slice write and mask as the unsplit cache did: no
    ``>= 0`` test or mask conjunction for an index that cannot fall
    below the buffer; a later slice needs both."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch.mesh import DataAxis
    from repro_torch.models import attention as attn_mod

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    cfg = get_arch("qwen2-0.5b").smoke.attn_config()
    p = attn_mod.Attention(cfg, torch.float32, "cpu")
    for w in p.parameters():
        torch.nn.init.normal_(w, std=0.1, generator=torch.Generator()
                              .manual_seed(0))
    x = torch.randn(2, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))

    def ops(kv):
        cache = attn_mod.init_kv_cache(2, 8, cfg, torch.float32, "cpu", 1)
        cache = KVCache(cache.k[0], cache.v[0],
                        torch.tensor([3, 8], dtype=torch.int32))
        mode = Ops()
        with torch.inference_mode(), mode:
            attn_mod.decode_attention(p, x, cfg, cache, kv=kv)
        return mode.names

    first = attn_mod.KVLayout(seq=DataAxis([dryrun.CountingAxis(1, 0)]))
    later = attn_mod.KVLayout(seq=DataAxis([dryrun.CountingAxis(2, 1)]))
    for kv in (None, first):
        assert not {"ge", "bitwise_and", "logical_and"} & ops(kv)
    assert {"ge", "__and__"} <= ops(later)
