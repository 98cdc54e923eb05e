"""The moe family against the JAX package, on the CPU.

``repro_torch.models.moe.moe_mlp`` against ``repro.models.moe.moe_mlp`` on
the same parameters (``init_moe``'s, numpy-seeded inputs): the routing
(experts, capacity slots, kept assignments) equal exactly, outputs and
aux loss within rtol = atol = 1e-5 in fp32 and 2e-2 in bf16, with and
without the shared expert, at capacity 1.25 with dropped assignments and
lossless; the uniform router's ties (the lower index first) and the
top-1 argmax oracle of ``tests/test_models.py:121-161``.

qwen2-moe-a2.7b and qwen3-moe-235b-a22b ``SMOKE`` with the JAX
``LM.init`` parameters bridged over: the configs port verbatim, prefill
and decode logits over ragged prompts lie within 1e-5 of max|logit| of
the JAX model's (dense and paged KV), parameter counts equal, and the
bridge keeps the router and shared gate fp32 in a bf16 model.  Serving
is ``tests/test_torch_moe_serving.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.core.features import default_features
from repro.models import moe as jax_moe
from repro.models.lm import LM as JaxLM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.models import moe
from repro_torch.models.lm import LM

torch.set_num_threads(1)

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
PROMPT_LENS = (10, 3, 1, 6)
FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# moe_mlp
# ---------------------------------------------------------------------------

def _moe_kw(e=8, k=2, shared=1, factor=1.25):
    return dict(d_model=32, d_ff_expert=16, num_experts=e, top_k=k,
                num_shared_experts=shared, d_ff_shared=16 * shared,
                capacity_factor=factor)


def _moe_pair(kw, dtype=torch.float32, seed=0):
    """(JAX config, JAX params, port config, port module) on one draw of
    ``init_moe``."""
    jcfg = jax_moe.MoEConfig(**kw)
    jp = {k: np.asarray(v) for k, v in jax.device_get(
        jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg)).items()}
    cfg = moe.MoEConfig(**kw)
    m = moe.MoE(cfg, dtype, torch.device("cpu"))
    m.load_state_dict({k: torch.from_numpy(v.copy()).to(
        torch.float32 if k in moe.FP32_LEAVES else dtype)
        for k, v in jp.items()})
    return jcfg, jp, cfg, m


def _jax_routing(p, x, cfg):
    """``repro.models.moe.moe_mlp``'s routing steps (``:117-139``) with
    JAX's own primitives: (idx [T,K], pos [T*K], keep [T*K])."""
    t = x.shape[0] * x.shape[1]
    xt = x.reshape(t, -1)
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), p["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    flat = jax.nn.one_hot(idx, cfg.num_experts, dtype=jnp.int32).reshape(
        t * cfg.top_k, cfg.num_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=-1)
    return (np.asarray(idx), np.asarray(pos),
            np.asarray(pos < jax_moe._capacity(t, cfg)))


def _both(jcfg, jp, cfg, m, x, dtype):
    """(JAX out, JAX aux, port out, port aux, JAX routing, port routing)
    for the fp32 array ``x`` cast to ``dtype`` on both sides."""
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    jout, jaux = jax_moe.moe_mlp(jax.tree.map(jnp.asarray, jp), jx, jcfg)
    tx = torch.from_numpy(x).to(dtype)
    with torch.inference_mode():
        out, aux = moe.moe_mlp(m, tx, cfg)
        r = moe.route(m, tx.reshape(-1, x.shape[-1]), cfg)
    return (np.asarray(jout.astype(jnp.float32)), float(jaux),
            out.float().numpy(), float(aux),
            _jax_routing(jax.tree.map(jnp.asarray, jp), jx, jcfg), r)


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_mlp_matches_jax(dtype, shared, lossless):
    e, k = 8, 2
    kw = _moe_kw(e, k, shared, factor=e / k if lossless else 1.25)
    jcfg, jp, cfg, m = _moe_pair(kw, dtype)
    rng = np.random.default_rng(11 + shared)
    # an offset skews the router toward a few experts, so some overflow
    x = (rng.standard_normal((3, 16, 32)) + 0.5).astype(np.float32)
    jout, jaux, out, aux, (jidx, jpos, jkeep), r = _both(jcfg, jp, cfg, m,
                                                         x, dtype)
    np.testing.assert_array_equal(r.idx.numpy(), jidx)
    np.testing.assert_array_equal(r.pos.numpy(), jpos)
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)
    assert r.cap == jax_moe._capacity(48, jcfg)
    if lossless:
        assert jkeep.all()
    else:
        assert not jkeep.all(), "no assignment overflowed its capacity"
    assert out.dtype == np.float32 and out.shape == x.shape
    np.testing.assert_allclose(out, jout, **(FP32 if dtype == torch.float32
                                             else BF16))
    np.testing.assert_allclose(aux, jaux, **FP32)
    assert aux >= 0.0


@pytest.mark.parametrize("k", [1, 2])
def test_uniform_router_ties_take_the_lower_index(k):
    """Every probability ties: the experts are 0..k-1 (``jax.lax.top_k``'s
    order), every token lands on them, and capacity drops the rest."""
    kw = _moe_kw(e=4, k=k, shared=0)
    jcfg, jp, cfg, m = _moe_pair(kw)
    jp["router"] = np.zeros_like(jp["router"])
    with torch.no_grad():
        m.router.zero_()
    x = np.random.default_rng(2).standard_normal((1, 64, 32)).astype(
        np.float32)
    jout, jaux, out, aux, (jidx, jpos, jkeep), r = _both(
        jcfg, jp, cfg, m, x, torch.float32)
    want = np.broadcast_to(np.arange(k), (64, k))
    np.testing.assert_array_equal(jidx, want)
    np.testing.assert_array_equal(r.idx.numpy(), want)
    np.testing.assert_array_equal(r.pos.numpy(), jpos)
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)
    assert int(r.keep.sum()) == k * r.cap < 64 * k
    np.testing.assert_allclose(out, jout, **FP32)
    np.testing.assert_allclose(aux, jaux, **FP32)


def test_top1_selects_the_argmax_expert():
    """Lossless top-1: each token's output is its argmax expert's SwiGLU
    (the top-1 gate renormalises to 1), as ``tests/test_models.py:144``
    checks for the reference."""
    kw = _moe_kw(e=4, k=1, shared=0, factor=4.0)
    jcfg, jp, cfg, m = _moe_pair(kw)
    x = np.random.default_rng(3).standard_normal((1, 4, 32)).astype(
        np.float32)
    jout, _, out, _, _, _ = _both(jcfg, jp, cfg, m, x, torch.float32)
    xt = torch.from_numpy(x[0])
    want = []
    for t in range(4):
        ex = int(torch.argmax(xt[t] @ m.router))
        h = xt[t] @ m.w_gate[ex]
        want.append((torch.nn.functional.silu(h) * (xt[t] @ m.w_up[ex]))
                    @ m.w_down[ex])
    np.testing.assert_allclose(out[0], torch.stack(want).numpy(), **FP32)
    np.testing.assert_allclose(out, jout, **FP32)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_active_params_matches_jax(arch):
    for kw in (_moe_kw(8, 2, 1), _moe_kw(6, 3, 0), _moe_kw(4, 1, 2)):
        assert moe.count_active_params(moe.MoEConfig(**kw)) == \
            jax_moe.count_active_params(jax_moe.MoEConfig(**kw))
    for which in ("config", "smoke"):
        mine = getattr(get_arch(arch), which).moe_config()
        ref = getattr(jax_get_arch(arch), which).moe_config()
        assert mine._asdict() == ref._asdict()
        assert moe.count_active_params(mine) == \
            jax_moe.count_active_params(ref)


# ---------------------------------------------------------------------------
# the SMOKE LMs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_port_verbatim(arch):
    ours, theirs = get_arch(arch), jax_get_arch(arch)
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(
        theirs.config)
    assert dataclasses.asdict(ours.smoke) == dataclasses.asdict(theirs.smoke)
    assert ours.source == theirs.source
    assert ours.skipped("long_500k") == theirs.skipped("long_500k")
    for mine, ref in ((ours.config, theirs.config),
                      (ours.smoke, theirs.smoke)):
        bc, jbc = mine.block_config(), ref.block_config()
        assert bc.mlp == jbc.mlp == "moe"
        assert bc.moe._asdict() == jbc.moe._asdict()
        assert bc.attn._asdict() == jbc.attn._asdict()
    ac = ours.config.attn_config()
    want = {"qwen2-moe-a2.7b": (16, 16, 128),
            "qwen3-moe-235b-a22b": (64, 4, 128)}[arch]
    assert (ac.num_heads, ac.num_kv_heads, ac.head_dim) == want


def _jax_pair(jcfg, cfg, seed=0, embed_scale=0.1):
    jlm = JaxLM(jcfg, default_features().with_(remat_policy="none"),
                dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(seed)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * embed_scale
    lm = LM(cfg, torch.float32, device="cpu")
    bridged = params_from_jax(jparams, cfg)
    assert set(bridged) == set(lm.state_dict())
    lm.load_state_dict(bridged)
    return jlm, jax.tree.map(jnp.asarray, jparams), lm


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    return (arch, *_jax_pair(jax_get_arch(arch).smoke,
                             get_arch(arch).smoke))


@pytest.mark.parametrize("page_size", [0, 4])
def test_smoke_logits_match_jax(pair, page_size):
    arch, jlm, jp, lm = pair
    cfg = lm.cfg
    rng = np.random.default_rng(7)
    b, s, max_seq = len(PROMPT_LENS), max(PROMPT_LENS), 32
    toks = np.zeros((b, s), np.int32)
    for i, n in enumerate(PROMPT_LENS):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
    lens = np.asarray(PROMPT_LENS, np.int32)
    kw = dict(page_size=page_size, num_pages=b * 8 + 1,
              table_width=8) if page_size else {}
    jstate = jlm.init_decode_state(b, max_seq, **kw)
    state = lm.init_decode_state(b, max_seq, **kw)
    if page_size:
        table = np.arange(1, b * 8 + 1, dtype=np.int32).reshape(b, 8)
        jstate = dict(jstate, caches=jstate["caches"]._replace(
            page_table=jnp.broadcast_to(jnp.asarray(table),
                                        jstate["caches"].page_table.shape)))
        state["caches"].page_table.copy_(torch.from_numpy(table))
    jlogits, jstate = jax.jit(jlm.prefill)(
        jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)},
        jstate)
    with torch.inference_mode():
        logits, state = lm.prefill({"tokens": torch.from_numpy(toks),
                                    "lengths": torch.from_numpy(lens)},
                                   state)
    assert _rel(logits, jlogits) <= 1e-5, arch
    jdecode = jax.jit(jlm.decode_step)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        jlogits, jstate = jdecode(jp, jnp.asarray(nxt), jstate)
        with torch.inference_mode():
            logits, state = lm.decode_step(torch.from_numpy(nxt), state)
        assert _rel(logits, jlogits) <= 1e-5, arch


def test_param_counts_match_jax(pair):
    arch, jlm, _, lm = pair
    assert lm.num_params() == jlm.num_params()
    assert lm.num_active_params() == jlm.num_active_params()
    assert lm.num_active_params() < lm.num_params()
    blk = lm.blocks[0]
    assert not hasattr(blk, "mlp")
    assert hasattr(blk.moe, "shared_coef") == (arch == "qwen2-moe-a2.7b")


def test_bridge_keeps_router_and_shared_gate_fp32_in_bf16():
    arch = "qwen2-moe-a2.7b"
    jcfg, cfg = jax_get_arch(arch).smoke, get_arch(arch).smoke
    jlm = JaxLM(jcfg, default_features(), dtype=jnp.bfloat16)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    bridged = params_from_jax(jparams, cfg, dtype=torch.bfloat16)
    for name, t in bridged.items():
        leaf = name.rsplit(".", 1)[-1]
        want = torch.float32 if leaf in moe.FP32_LEAVES else torch.bfloat16
        assert t.dtype == want, name
    assert "blocks.1.moe.router" in bridged
    assert "blocks.0.moe.shared_coef" in bridged
    lm = LM(cfg, torch.bfloat16, device="cpu")
    lm.load_state_dict(bridged)
    assert lm.blocks[1].moe.router.dtype == torch.float32
    assert lm.blocks[1].moe.shared_coef.dtype == torch.float32
    assert lm.blocks[1].moe.w_gate.dtype == torch.bfloat16
    # a bf16 prefill routes in fp32 and returns bf16 logits
    with torch.inference_mode():
        logits, _ = lm.prefill({"tokens": torch.tensor([[1, 2, 3]])},
                               lm.init_decode_state(1, 8))
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
