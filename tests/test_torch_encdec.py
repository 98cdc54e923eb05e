"""The encdec family (seamless-m4t-medium) against the JAX package, on the
CPU, in fp32.

``repro_torch.models.layers.gelu_mlp`` against the JAX ``gelu_mlp`` (the
tanh approximation ``jax.nn.gelu`` defaults to), and seamless-m4t-medium
``SMOKE`` with the JAX ``LM.init`` parameters bridged over (the embedding
scaled by 0.1): the encoder and decoder blocks and ``cross_memory``
against the JAX ones on a layer's parameters, prefill and decode logits
within 1e-5 of max|logit|, greedy tokens equal the JAX engine's for
``generate``, ``generate_reference`` and streaming with ``extra_batch``
(equal-length prompts: the family runs pads as context).  Spec, paged
engines, the ``BatchScheduler`` and the serving launcher each refuse the
family with a ``ValueError`` (the JAX scheduler fails at its first
admission with ``KeyError: 'src_embeds'``).  Then the declared traffic
of a decode step, by hand, and ``profile_generate``'s inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_arch as jax_get_arch
from repro.core.features import default_features
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro.models.lm import LM as JaxLM
from repro.serve import engine as jax_engine
from repro_torch.bench import profile_generate
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.core import events
from repro_torch.kernels import registry
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import encdec, layers
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve import engine
from repro_torch.serve.spec import SpecConfig

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
FP32 = dict(rtol=1e-5, atol=1e-5)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def test_configs_port_verbatim():
    ours, theirs = get_arch(ARCH), jax_get_arch(ARCH)
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(
        theirs.config)
    assert dataclasses.asdict(ours.smoke) == dataclasses.asdict(theirs.smoke)
    assert ours.source == theirs.source
    assert ours.skipped("long_500k") == theirs.skipped("long_500k")
    for mine, ref in ((ours.config, theirs.config),
                      (ours.smoke, theirs.smoke)):
        ec, jec = mine.encdec_config(), ref.encdec_config()
        assert ec.attn._asdict() == jec.attn._asdict()
        assert (ec.d_ff, ec.norm_eps) == (jec.d_ff, jec.norm_eps)
    ac = ours.config.attn_config()
    assert (ac.num_heads, ac.num_kv_heads, ac.head_dim) == (16, 16, 64)


@pytest.mark.parametrize("bias", [True, False])
def test_gelu_mlp_matches_jax(bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w_up = rng.standard_normal((24, 40)).astype(np.float32) * 0.3
    w_down = rng.standard_normal((40, 24)).astype(np.float32) * 0.3
    b_up = rng.standard_normal(40).astype(np.float32) if bias else None
    b_down = rng.standard_normal(24).astype(np.float32) if bias else None

    def t(a):
        return None if a is None else torch.from_numpy(a)

    def j(a):
        return None if a is None else jnp.asarray(a)

    got = layers.gelu_mlp(t(x), t(w_up), t(b_up), t(w_down), t(b_down))
    want = jax_layers.gelu_mlp(j(x), j(w_up), j(b_up), j(w_down), j(b_down))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    # the exact erf GELU is not the JAX package's
    h = t(x) @ t(w_up) + (t(b_up) if bias else 0)
    erf = F.gelu(h) @ t(w_down) + (t(b_down) if bias else 0)
    assert np.abs(erf.numpy() - np.asarray(want)).max() > 1e-4


@pytest.fixture(scope="module")
def pair():
    jlm = JaxLM(jax_get_arch(ARCH).smoke, default_features().with_(
        remat_policy="none"), dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * 0.1
    cfg = get_arch(ARCH).smoke
    lm = LM(cfg, torch.float32, device="cpu")
    bridged = params_from_jax(jparams, cfg)
    assert set(bridged) == set(lm.state_dict())
    for leaf in ("encoder.1.mlp.b_up", "decoder.1.cross.wq",
                 "decoder.0.ln_cross.bias", "enc_final_norm.scale"):
        assert leaf in bridged
    lm.load_state_dict(bridged)
    return jlm, jax.tree.map(jnp.asarray, jparams), lm


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_blocks_and_cross_memory_match_jax(pair):
    """Layer 1's encoder block, ``cross_memory`` and decoder block (the
    cache-free forward) on the JAX parameters of that layer."""
    jlm, jp, lm = pair
    cfg = lm.cfg
    ec, jec = cfg.encdec_config(), jlm.cfg.encdec_config()
    enc_cfg = ec._replace(attn=ec.attn._replace(causal=False))
    jenc_cfg = jec._replace(attn=jec.attn._replace(causal=False))
    rng = np.random.default_rng(1)
    src = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    tgt = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    with torch.inference_mode():
        mem = encdec.apply_encoder_block(lm.encoder[1], torch.from_numpy(src),
                                         enc_cfg)
    jmem = jax_encdec.apply_encoder_block(_layer(jp["encoder"], 1),
                                          jnp.asarray(src), jenc_cfg)
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), **FP32)
    jdec = _layer(jp["decoder"], 1)
    with torch.inference_mode():
        mk, mv = encdec.cross_memory(lm.decoder[1].cross, mem, ec.attn)
        out = encdec.apply_decoder_block(lm.decoder[1], torch.from_numpy(tgt),
                                         mk, mv, ec)
    jmk, jmv = jax_encdec.cross_memory(jdec["cross"], jmem, jec.attn)
    np.testing.assert_allclose(mk.numpy(), np.asarray(jmk), **FP32)
    np.testing.assert_allclose(mv.numpy(), np.asarray(jmv), **FP32)
    jout = jax_encdec.apply_decoder_block(jdec, jnp.asarray(tgt), jmk, jmv,
                                          jec)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FP32)
    # the cross-attention block carries no RoPE and is not causal
    cc = encdec.cross_config(ec)
    assert not cc.causal and not cc.use_rope


def test_param_counts_match_jax(pair):
    jlm, _, lm = pair
    assert lm.num_params() == jlm.num_params()
    assert len(lm.encoder) == lm.cfg.enc_layers
    assert len(lm.decoder) == lm.cfg.n_layers


def _src(cfg, b, s_src, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s_src, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s,s_src", [(8, 2), (12, 5)])
def test_smoke_logits_match_jax(pair, s, s_src):
    jlm, jp, lm = pair
    cfg = lm.cfg
    rng = np.random.default_rng(7)
    b, max_seq = 3, 32
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    src = _src(cfg, b, s_src)
    jstate = jlm.init_decode_state(b, max_seq)
    state = lm.init_decode_state(b, max_seq)
    assert state["mem_k"].shape == jstate["mem_k"].shape
    jlogits, jstate = jax.jit(jlm.prefill)(
        jp, {"tokens": jnp.asarray(toks), "src_embeds": jnp.asarray(src)},
        jstate)
    with torch.inference_mode():
        logits, state = lm.prefill({"tokens": torch.from_numpy(toks),
                                    "src_embeds": torch.from_numpy(src)},
                                   state)
    assert _rel(logits, jlogits) <= 1e-5
    assert state["mem_k"].shape == jstate["mem_k"].shape
    np.testing.assert_allclose(state["mem_v"].numpy(),
                               np.asarray(jstate["mem_v"]), **FP32)
    jdecode = jax.jit(jlm.decode_step)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        jlogits, jstate = jdecode(jp, jnp.asarray(nxt), jstate)
        with torch.inference_mode():
            logits, state = lm.decode_step(torch.from_numpy(nxt), state)
        assert _rel(logits, jlogits) <= 1e-5


def test_prefill_takes_src_embeds_and_no_lengths(pair):
    _, _, lm = pair
    toks = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="src_embeds"):
        lm.prefill({"tokens": toks}, lm.init_decode_state(2, 16))
    src = torch.from_numpy(_src(lm.cfg, 2, 2))
    with pytest.raises(ValueError, match="no lengths or prefix_len"):
        lm.prefill({"tokens": toks, "src_embeds": src,
                    "lengths": torch.tensor([4, 2], dtype=torch.int32)},
                   lm.init_decode_state(2, 16))
    with pytest.raises(ValueError, match="attention-cache family"):
        lm.init_decode_state(2, 16, page_size=8)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(vocab, b=3, s=9, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, s).tolist() for _ in range(b)]


def test_greedy_tokens_equal_the_jax_engine(pair):
    """Equal-length prompts with ``src_embeds`` [B, S // 4, d]: ``generate``
    (one host sync), ``generate_reference`` and streaming give the JAX
    engine's tokens; the source moves them."""
    jlm, jp, lm = pair
    prompts = _prompts(lm.cfg.vocab)
    extra = {"src_embeds": _src(lm.cfg, 3, 9 // lm.cfg.src_ratio)}
    sc = dict(max_seq=64)
    jeng = jax_engine.Engine(jlm, jp, jax_engine.ServeConfig(**sc))
    want = jeng.generate(prompts, 8, extra_batch=extra)
    assert jeng.generate_reference(prompts, 8, extra_batch=extra) == want
    eng = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")
    got = eng.generate(prompts, 8, extra_batch=extra)
    assert got == want
    assert eng.host_syncs == 1
    assert len({tuple(t) for t in got}) > 1
    assert eng.generate_reference(prompts, 8, extra_batch=extra) == want
    streamed = [[] for _ in prompts]
    assert eng.generate(prompts, 8, extra_batch=extra,
                        stream_cb=lambda i, t, d: streamed[i].extend(t)
                        ) == streamed == want
    other = {"src_embeds": _src(lm.cfg, 3, 2, seed=4)}
    assert eng.generate(prompts, 8, extra_batch=other) == \
        jeng.generate(prompts, 8, extra_batch=other) != got


DRAFT = LMConfig(name="encdec-spec-d", family="dense", vocab=512,
                 d_model=32, n_layers=1, num_heads=4, num_kv_heads=2,
                 d_ff=64)


def test_spec_paged_engines_scheduler_and_launcher_refuse_encdec(pair):
    _, _, lm = pair
    cfg = lm.cfg
    paged = engine.ServeConfig(max_seq=64, page_size=8)
    # spec: as the JAX SpecConfig refuses it (repro/serve/spec.py:99-106)
    with pytest.raises(ValueError, match="encoder-decoder"):
        SpecConfig(draft_config=DRAFT, num_draft_tokens=2).validate(
            cfg, paged)
    with pytest.raises(ValueError, match="encoder-decoder"):
        SpecConfig(draft_config=cfg, num_draft_tokens=2).validate(
            dataclasses.replace(DRAFT, vocab=cfg.vocab), paged)
    # paged engines: its decoder cache is dense only
    with pytest.raises(ValueError, match="attention-cache"):
        engine.Engine(lm, paged, device="cpu")
    # the scheduler and the launcher, before any admission or weights
    eng = engine.Engine(lm, engine.ServeConfig(max_seq=64), device="cpu")
    with pytest.raises(ValueError, match="src_embeds"):
        engine.BatchScheduler(eng)
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve_launcher.main(["--arch", ARCH, "--smoke-dims", "--device",
                             "cpu", "--requests", "2"])


# ---------------------------------------------------------------------------
# declared traffic and profile_generate
# ---------------------------------------------------------------------------

def test_declared_decode_step_equals_hand_count(pair):
    """One fp32 decode step of the SMOKE model with a memory of S_src
    positions: the decoder's weights (not the encoder's, nor the memory
    projections) and the head read once, every product over the B rows,
    the masked dense decode over the whole K/V buffers, and the
    cross-attention reading the memory and multiplying it."""
    _, _, lm = pair
    c = lm.cfg
    d, L, H, V, F_ = c.d_model, c.n_layers, c.num_heads, c.vocab, c.d_ff
    dh, B, f, smax, s_src = d // H, 2, 4, 16, 3
    state = lm.init_decode_state(B, smax)
    with torch.inference_mode():
        _, state = lm.prefill(
            {"tokens": torch.ones((B, 5), dtype=torch.int32),
             "src_embeds": torch.from_numpy(_src(c, B, s_src))}, state)
    attn = 4 * d * H * dh
    mat = attn + 2 * d * dh * H + 2 * d * F_       # self, cross q/o, mlp
    layer = mat + 2 * d * dh * H + 6 * d + F_ + d  # cross k/v, 3 norms, b
    weights = f * (L * (layer - 2 * d * dh * H) + 2 * d)
    head = f * d * V
    flops = (2 * B * L * mat + 2 * B * d * V
             + 4 * L * B * H * s_src * dh          # cross-attention
             + 4 * L * B * H * smax * dh)          # masked dense decode
    arg = (weights + head + B * (f * d + 4)
           + 2 * L * B * s_src * H * dh * f        # the memory
           + 2 * L * B * smax * H * dh * f)        # the K/V buffers
    out = f * B * V + 2 * L * B * H * dh * f
    with torch.inference_mode(), events.collect() as ev:
        lm.decode_step(torch.ones((B, 1), dtype=torch.int32), state)
    assert ev["FLOPS_TOTAL"] == ev["FLOPS_F32"] == flops
    assert ev["HBM_ARG_BYTES"] == arg
    assert ev["HBM_OUT_BYTES"] == out
    assert ev["LAUNCHES"] == 0


def test_declared_prefill_counts_the_source(pair):
    """A longer source moves exactly the source terms of a prefill: the
    source weights' products over each more source position, the
    cross-attention's scores over it, the memory written and read and the
    source embeddings read (the encoder's self-attention, declared by the
    registry's impl, taken out)."""
    _, _, lm = pair
    c = lm.cfg
    B, s, H = 2, 8, c.num_heads
    dh = c.d_model // H
    got = {}
    for s_src in (2, 4):
        with torch.inference_mode(), events.collect() as ev:
            lm.prefill({"tokens": torch.ones((B, s), dtype=torch.int32),
                        "src_embeds": torch.from_numpy(_src(c, B, s_src))},
                       lm.init_decode_state(B, 16))
        q = torch.zeros((B, s_src, H, dh))
        with events.collect() as enc:
            registry.run("attention", q, q, q, q_offset=0, causal=False,
                         kv_len=None)
        got[s_src] = {k: ev[k] - c.enc_layers * enc[k]
                      for k in ("FLOPS_TOTAL", "HBM_ARG_BYTES",
                                "HBM_OUT_BYTES")}
    src_elems, _ = lm._source_weights
    mem_row = 2 * c.n_layers * B * c.d_model * 4      # K and V, H*dh = d
    d = {k: got[4][k] - got[2][k] for k in got[2]}
    assert d["HBM_OUT_BYTES"] == 2 * mem_row
    assert d["HBM_ARG_BYTES"] == 2 * mem_row + 2 * B * c.d_model * 4
    assert d["FLOPS_TOTAL"] == (2.0 * B * 2 * src_elems
                                + 4.0 * c.n_layers * B * H * s * 2 * dh)


def test_profile_generate_takes_seamless():
    lens = profile_generate.PROMPT_LENS[ARCH]
    assert lens == (256,) * 8
    assert ARCH in profile_generate.RECURRENT      # dense state only
    assert profile_generate.depth(ARCH) == 12
    cfg = get_arch(ARCH).config
    extra = profile_generate.stub_inputs(cfg, lens, torch.bfloat16,
                                         torch.device("cpu"))
    assert extra["src_embeds"].shape == (8, 64, 1024)
    assert profile_generate.stub_inputs(get_arch("qwen2-0.5b").config,
                                        lens, torch.bfloat16,
                                        torch.device("cpu")) == {}
