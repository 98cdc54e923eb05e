"""The port's optimizer, schedules, int8 error feedback and data pipeline
against the JAX package's, on the CPU.

* ``lr_at`` equals the reference's at every step of every kind (fp32,
  within 1e-6 relative: two fp32 cosines);
* ``apply_updates`` on a STACKED tree (the reference's per-layer leaves
  on a leading layers axis, the port's one tensor a layer) equals the
  reference's over three steps, clipping active, with fp32 and bf16
  moments: parameters and moments within 1e-6 (fp32 moments) and one
  bf16 ulp of the moments' own rounding (bf16 moments, 1e-2 relative),
  including the decay-by-stacked-rank rule (every stacked norm scale
  and bias decays, ``final_norm`` and the unstacked ``shared_attn``
  norms do not);
* ``compress_decompress`` takes ONE scale per stacked reference leaf and
  equals the reference over three steps of error feedback (gradients and
  residuals within 1e-6 of the leaf's scale);
* ``SyntheticTokens`` (with the vlm and encdec stubs) and
  ``MemmapTokens`` give the reference's batches bit for bit.

Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.data import pipeline as jax_pipe
from repro.optim import adamw as jax_adamw
from repro.optim import compress as jax_compress
from repro.optim import schedule as jax_sched
from repro_torch.bridge import params_to_jax, reference_leaf, stack_to_jax
from repro_torch.data import pipeline
from repro_torch.models.lm import LMConfig
from repro_torch.optim import adamw, compress, schedule

torch.set_num_threads(1)

#: a hybrid-shaped config: two stacked subtrees (blocks, mamba) and the
#: unstacked shared block, final norm and embedding
L = 3
CFG = LMConfig(name="t", family="dense", vocab=11, d_model=8, n_layers=L,
               num_heads=2, num_kv_heads=1, d_ff=16)
SHAPES = {
    "embed.table": (11, 8),
    "final_norm.scale": (8,),
    "shared_attn.ln1.scale": (8,),
    "shared_attn.attn.bq": (2, 4),
    "shared_attn.attn.wq": (8, 2, 4),
}
for i in range(L):
    SHAPES.update({f"blocks.{i}.ln1.scale": (8,),
                   f"blocks.{i}.attn.bq": (2, 4),
                   f"blocks.{i}.attn.wq": (8, 2, 4),
                   f"blocks.{i}.mlp.w_up": (8, 16)})


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32))
        for k, s in SHAPES.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, params_to_jax(tree, CFG))


def _close_tree(port, ref, **tol):
    got = params_to_jax(port, CFG)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(leaf, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_lr_at_matches_reference(kind):
    cfg = dict(peak_lr=3e-3, warmup_steps=7, total_steps=40, min_ratio=0.1,
               kind=kind)
    for step in range(0, 50):
        got = schedule.lr_at(torch.tensor(step, dtype=torch.int32),
                             schedule.ScheduleConfig(**cfg))
        want = jax_sched.lr_at(jnp.asarray(step, jnp.int32),
                               jax_sched.ScheduleConfig(**cfg))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


def test_decay_follows_the_reference_rank():
    p = _tree(0)
    ref = params_to_jax(p, CFG)
    for name, t in p.items():
        node = ref
        for k in reference_leaf(name)[0].split("."):
            node = node[k]
        assert adamw.decays(name, t) is (node.ndim >= 2), name
    want = {"embed.table": True, "final_norm.scale": False,
            "shared_attn.ln1.scale": False, "shared_attn.attn.bq": True,
            "shared_attn.attn.wq": True, "blocks.1.ln1.scale": True,
            "blocks.1.attn.bq": True, "blocks.1.mlp.w_up": True}
    for name, decays in want.items():
        assert adamw.decays(name, p[name]) is decays, name


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_matches_reference_on_a_stacked_tree(moments):
    # clip_norm far under the gradients' norm: clipping is active; a large
    # weight decay makes the decay rule visible in every leaf
    kw = dict(clip_norm=0.5, weight_decay=0.3, moment_dtype=moments)
    params = _tree(1)
    port_cfg, ref_cfg = adamw.AdamWConfig(**kw), jax_adamw.AdamWConfig(**kw)
    opt = adamw.init_opt_state(params, port_cfg)
    jp = _jax(params)
    jopt = jax_adamw.init_opt_state(jp, ref_cfg)
    for step in range(3):
        grads = _tree(10 + step, scale=3.0)
        lr = schedule.lr_at(opt.step, schedule.ScheduleConfig(
            peak_lr=1e-2, warmup_steps=0, total_steps=10))
        params, opt, m = adamw.apply_updates(params, grads, opt, lr,
                                             port_cfg)
        jp, jopt, jm = jax_adamw.apply_updates(jp, _jax(grads), jopt,
                                               jnp.asarray(lr.item()),
                                               ref_cfg)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(jm["grad_norm"]) > 1.0      # the clip really acts
    assert int(opt.step) == int(jopt.step) == 3
    assert opt.m["blocks.0.ln1.scale"].dtype == (
        torch.float32 if moments == "float32" else torch.bfloat16)
    tol = (dict(rtol=1e-6, atol=1e-6) if moments == "float32"
           else dict(rtol=1e-2, atol=1e-4))
    _close_tree(params, jp, **tol)
    _close_tree({k: v.float() for k, v in opt.m.items()}, jopt.m, **tol)
    _close_tree({k: v.float() for k, v in opt.v.items()}, jopt.v, **tol)


def test_stacked_norms_decay_and_unstacked_do_not():
    # zero gradients: the update is the decay alone, lr * wd * p
    params = _tree(2)
    before = {k: v.clone() for k, v in params.items()}
    cfg = adamw.AdamWConfig(weight_decay=0.5)
    opt = adamw.init_opt_state(params, cfg)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    adamw.apply_updates(params, zeros, opt, torch.tensor(0.1), cfg)
    for k in ("blocks.2.ln1.scale", "blocks.0.attn.bq", "embed.table"):
        torch.testing.assert_close(params[k], before[k] * (1 - 0.05))
    for k in ("final_norm.scale", "shared_attn.ln1.scale"):
        torch.testing.assert_close(params[k], before[k])


def test_compress_takes_one_scale_per_stacked_leaf():
    g = _tree(3)
    # one layer of a stacked leaf far larger than the others: a scale per
    # port tensor would quantize the small layers finely, the reference's
    # one scale over the stacked leaf coarsely
    g["blocks.1.mlp.w_up"] = g["blocks.1.mlp.w_up"] * 100.0
    ef = compress.init_compress_state(g)
    new_g, _ = compress.compress_decompress(g, ef)
    q_step = g["blocks.1.mlp.w_up"].abs().max() / 127.0
    small = new_g["blocks.0.mlp.w_up"] / q_step
    torch.testing.assert_close(small, small.round(), atol=1e-3, rtol=0)


def test_compress_decompress_matches_reference_over_three_steps():
    g0 = _tree(4)
    ef = compress.init_compress_state(g0)
    jef = jax_compress.init_compress_state(_jax(g0))
    for step in range(3):
        g = _tree(20 + step)
        new_g, ef = compress.compress_decompress(g, ef)
        jg, jef = jax_compress.compress_decompress(_jax(g), jef)
        # within a millionth of the leaf's quantum (amax / 127)
        for tree, jtree in ((new_g, jg), (ef, jef)):
            got = params_to_jax(tree, CFG)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
                node = got
                for k in path:
                    node = node[k.key]
                quantum = np.abs(np.asarray(
                    _leaf(params_to_jax(g, CFG), path))).max() / 127.0
                np.testing.assert_allclose(node, np.asarray(leaf),
                                           rtol=0, atol=1e-6 * quantum,
                                           err_msg=jax.tree_util.keystr(path))
    q, scale = compress.quantize_int8(g["embed.table"])
    jq, jscale = jax_compress.quantize_int8(jnp.asarray(g["embed.table"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scale.item(), float(jscale), rtol=1e-7)
    torch.testing.assert_close(
        compress.dequantize_int8(q, scale),
        torch.from_numpy(np.array(jax_compress.dequantize_int8(jq,
                                                                 jscale))))


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_stack_to_jax_keeps_bf16_and_layer_order():
    t = {f"mamba.{i}.D": torch.full((2,), float(i), dtype=torch.bfloat16)
         for i in (2, 0, 1)}
    st = stack_to_jax(t)["mamba"]["D"]
    assert st.dtype == torch.bfloat16 and st.shape == (3, 2)
    assert st[:, 0].tolist() == [0.0, 1.0, 2.0]


@pytest.mark.parametrize("stubs", ["none", "vlm", "encdec"])
def test_synthetic_tokens_match_reference(stubs):
    kw = dict(seq_len=24, global_batch=6, vocab=1000, seed=3,
              process_index=1, process_count=2)
    if stubs == "vlm":
        kw.update(patch_embeds=5, d_model=8)
    if stubs == "encdec":
        kw.update(src_embeds_dim=8, src_ratio=4)
    ours = pipeline.make_source(pipeline.DataConfig(**kw))
    ref = jax_pipe.make_source(jax_pipe.DataConfig(**kw))
    for step in (0, 1, 7):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_memmap_tokens_match_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(5).integers(0, 60000, 40 * 16,
                                      dtype=np.uint16).tofile(path)
    kw = dict(seq_len=16, global_batch=4, vocab=5000, seed=2, path=path)
    ours = pipeline.make_source(pipeline.DataConfig(**kw))
    ref = jax_pipe.make_source(jax_pipe.DataConfig(**kw))
    assert isinstance(ours, pipeline.MemmapTokens)
    for step in (0, 3, 9, 10, 23):       # crosses epoch boundaries
        a, b = ours.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="global_batch"):
        pipeline.MemmapTokens(pipeline.DataConfig(
            seq_len=16, global_batch=64, vocab=5000, path=path))
