"""The reference's decode-state layouts and sequence parallelism on gloo
ranks, on the CPU, against the JAX package (fp32, ``LM.init`` weights
bridged over).

One spawn of four ranks over a ``file://`` store (no network; the rank
bodies in ``tests/torch_layout_ranks.py``, which imports no JAX):

* a decode step over a cache cut by ``LM.state_pspecs``: the sequence
  split over the model axis ((1, 2), two rows) and over both axes
  ((2, 2), one row, which leaves ``data`` to the sequence), and
  ``kv_shard="headdim"`` ((1, 2): the head dim split, RoPE's pairs on the
  rank), for the dense family (qwen2-0.5b), the hybrid's shared block
  (zamba2-1.2b, its Mamba2 state re-laid) and encdec's self-attention
  caches and cross-attention memory (seamless-m4t-medium): the port
  prefills unsharded, cuts the state, and four fixed tokens' logits
  equal the JAX ``LM.decode_step``'s after the JAX ``LM.prefill`` within
  1e-5 of max|logit|; each rank's KV buffer is its cut;
* the same three archs prefilled through the rank's ``LM(mesh=)`` into
  its cut of a zeroed state (the K/V and the encdec memory re-laid into
  the layout, the recurrent states into and out of the compute layout),
  on (1, 2) at 20 positions (the memory's 5 source positions cut by kv
  heads, the caches by positions) and on (2, 2) at 16 (both by
  positions over both axes): the prefill's and every step's logits
  against the JAX package's;
* a train step under ``act_seq -> model`` on (1, 2) and (2, 2) for the
  three archs ``TRAIN_POLICY`` runs with sequence parallelism
  (mistral-large-123b, qwen3-moe-235b-a22b, qwen2-vl-7b), and on (1, 2)
  for the other families' paths (zamba2-1.2b, xlstm-350m,
  seamless-m4t-medium): the loss within 1e-5 relative of the JAX
  ``LM.loss`` and every gradient within 1e-4 relative plus 1e-6 of the
  largest (``tests/test_torch_train_step.py``'s tolerances).

Two host checks need no spawn: the layout refuses an encdec source of
another length than its memory's, and an LM with a mesh refuses a state
it has not cut.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.core.features import default_features as jax_features
from repro.models.lm import LM as JaxLM
from repro_torch.bridge import params_from_jax
from repro_torch.launch import mesh as mesh_mod

from test_torch_train_step import _batch, check_grads

import torch_layout_ranks as ranks

torch.set_num_threads(1)


def _jax(arch):
    jlm = JaxLM(jax_get_arch(arch).smoke,
                jax_features().with_(remat_policy="none"), dtype=jnp.float32)
    return jlm, jlm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def refs():
    archs = (set(ranks.DECODE_ARCHS) | set(ranks.SP_ARCHS)
             | set(ranks.SP_MORE_ARCHS))
    out = {a: _jax(a) for a in archs}
    weights = {a: {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, p), ranks.config(a)).items()}
        for a, (_, p) in out.items()}
    return out, weights


@pytest.fixture(scope="module")
def world(refs):
    jax_models, weights = refs
    batches = {a: {k: v.numpy() for k, v in
                   _batch(ranks.config(a))[0].items()}
               for a in ranks.SP_ARCHS + ranks.SP_MORE_ARCHS}
    got = mesh_mod.spawn(ranks.layout_world, ranks.WORLD,
                         (weights, batches), timeout_s=240)
    return got, batches


def _jax_decode(jlm, params, arch, rows, smax=ranks.SMAX):
    """The JAX prefill's logits and each decode step's."""
    batch, steps = ranks.decode_inputs(arch, rows, smax)
    state = jlm.init_decode_state(rows, smax)
    first, state = jax.jit(jlm.prefill)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, state)
    step = jax.jit(jlm.decode_step)
    out = []
    for tok in steps:
        logits, state = step(params, jnp.asarray(tok), state)
        out.append(np.asarray(logits))
    return np.asarray(first), np.stack(out)


def _kv_cut(arch, layout, shape, rows, smax=ranks.SMAX):
    """The KV buffer a rank holds under the layout, from the config."""
    cfg = ranks.config(arch)
    layers = (len(range(0, cfg.n_layers, cfg.attn_every))
              if cfg.family == "hybrid" else cfg.n_layers)
    kvh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    d, m = shape
    if layout == "headdim":
        return (layers, rows, smax, kvh, dh // m)
    seq = m * (d if rows % d else 1)        # data too when rows leave it
    return (layers, rows // (1 if rows % d else d), smax // seq, kvh, dh)


def _mem_cut(cfg, shape, rows, smax):
    """The encdec memory a rank holds under the sequence layout: its
    ``S_src`` positions over the longest prefix of the axes the batch
    leaves free that divides them, its kv heads over ``model`` when the
    positions leave it."""
    d, m = shape
    s_src = smax // cfg.src_ratio
    free = (("model", m),) if rows % d == 0 else (("data", d), ("model", m))
    while free and s_src % int(np.prod([n for _, n in free])):
        free = free[:-1]
    cut = int(np.prod([n for _, n in free]))
    kvh = cfg.num_kv_heads
    if "model" not in dict(free) and kvh % m == 0:
        kvh //= m
    return (cfg.n_layers, rows // (d if rows % d == 0 else 1), s_src // cut,
            kvh, cfg.resolved_head_dim)


@pytest.mark.parametrize("arch,layout,shape,rows", ranks.DECODE_CASES)
def test_decode_over_a_cut_state_matches_jax(refs, world, arch, layout,
                                             shape, rows):
    jlm, params = refs[0][arch]
    _, want = _jax_decode(jlm, params, arch, rows)
    got = [r[(arch, layout, shape)] for r in world[0]
           if (arch, layout, shape) in r]
    assert len(got) == int(np.prod(shape))
    for logits, kv_shape in got:
        np.testing.assert_allclose(logits, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert kv_shape == _kv_cut(arch, layout, shape, rows)


@pytest.mark.parametrize("shape", ranks.SP_SHAPES)
@pytest.mark.parametrize("arch", ranks.SP_ARCHS)
def test_sequence_parallel_train_step_matches_jax(refs, world, arch,
                                                  shape):
    jlm, params = refs[0][arch]
    jb = {k: jnp.asarray(v) for k, v in world[1][arch].items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        params, jb)
    results = [r[(arch, "sp", shape)] for r in world[0]
               if (arch, "sp", shape) in r]
    assert len(results) == int(np.prod(shape))
    for loss, grads in results:
        np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
        check_grads({k: torch.from_numpy(v) for k, v in grads.items()},
                    jg, ranks.config(arch))


@pytest.mark.parametrize("arch,shape,rows,smax", ranks.PREFILL_CASES)
def test_layout_prefill_then_decode_matches_jax(refs, world, arch, shape,
                                                rows, smax):
    jlm, params = refs[0][arch]
    want_first, want = _jax_decode(jlm, params, arch, rows, smax)
    got = [r[(arch, "prefill", shape)] for r in world[0]
           if (arch, "prefill", shape) in r]
    assert len(got) == int(np.prod(shape))
    cfg = ranks.config(arch)
    for first, logits, kv_shape, mem_shape in got:
        np.testing.assert_allclose(first, want_first, rtol=0,
                                   atol=1e-5 * np.abs(want_first).max())
        np.testing.assert_allclose(logits, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert kv_shape == _kv_cut(arch, "seq", shape, rows, smax)
        if cfg.family == "encdec":
            assert mem_shape == _mem_cut(cfg, shape, rows, smax)


#: the gradient tolerances of the xlstm family, whose exponential gates
#: amplify fp32 rounding (``tests/test_torch_family_mesh.py``'s
#: ``TRAIN_TOL``); every other family takes ``check_grads``' defaults
GRAD_TOL = {"xlstm-350m": dict(rtol=1e-3, atol=3e-4)}


@pytest.mark.parametrize("arch", ranks.SP_MORE_ARCHS)
def test_sequence_parallel_train_step_of_the_other_families_matches_jax(
        refs, world, arch):
    jlm, params = refs[0][arch]
    jb = {k: jnp.asarray(v) for k, v in world[1][arch].items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        params, jb)
    results = [r[(arch, "sp", (1, 2))] for r in world[0]
               if (arch, "sp", (1, 2)) in r]
    assert len(results) == 2
    for loss, grads in results:
        np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
        check_grads({k: torch.from_numpy(v) for k, v in grads.items()},
                    jg, ranks.config(arch), **GRAD_TOL.get(arch, {}))


def _walk_lm(arch, smax):
    """A rank's seamless LM on the dry run's counting (1, 2) mesh under
    the sequence layout, and the whole zeroed state of two rows."""
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import LM
    cfg = ranks.config(arch)
    host = LM(cfg, torch.float32, "cpu")
    mesh = dryrun._WalkMesh((1, 2), ("data", "model"))
    whole = host.init_decode_state(2, smax)
    rules = host.state_rules(whole, mesh, ranks.decode_rules("seq"))
    lm = LM(cfg, torch.float32, "cpu", rules=rules,
            tp=mesh_mod.axis_of(mesh, "model"), mesh=mesh)
    return lm, whole


def test_layout_prefill_refuses_a_source_of_another_length():
    lm, whole = _walk_lm("seamless-m4t-medium", 20)
    local = lm.cut_state(whole)
    cfg = lm.cfg
    for s_src in (4, 6):                       # the state's memory holds 5
        batch = {"tokens": torch.zeros((2, 3), dtype=torch.int32),
                 "src_embeds": torch.zeros((2, s_src, cfg.d_model))}
        with pytest.raises(ValueError, match="5 source positions"):
            lm.prefill(batch, local)


def test_an_lm_with_a_mesh_decodes_only_a_state_it_cut():
    lm, whole = _walk_lm("seamless-m4t-medium", 16)
    with pytest.raises(ValueError, match="LM.cut_state"):
        lm.decode_step(torch.zeros((2, 1), dtype=torch.int32), whole)
