"""The vlm family (qwen2-vl-7b) against the JAX package, on the CPU, in fp32.

``repro_torch.models.layers.apply_mrope`` against the JAX ``apply_mrope``
(text tokens with t = h = w reduce to 1-D RoPE), ``LM._vlm_positions3``
against the JAX model's, and qwen2-vl-7b ``SMOKE`` with the JAX
``LM.init`` parameters bridged over (the embedding scaled by 0.1, so
tokens depend on every layer): prefill logits with patch embeddings and
decode logits within 1e-5 of max|logit| (dense, fp32 and int8 pages);
greedy tokens equal the JAX engine's for ``generate`` with
``extra_batch`` (dense and paged, fp32 and int8 pages), for
``generate_reference`` and streaming; the ``BatchScheduler`` with the
prefix cache against the JAX scheduler on the same traffic (admissions
text-only, a suffix prefill's M-RoPE restarting at 0, as the JAX
package's); and speculative decoding against the JAX spec engine.  Then
the declared traffic, the launcher and ``profile_generate``'s inputs.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.core.features import default_features
from repro.models import layers as jax_layers
from repro.models.lm import LM as JaxLM
from repro.models.lm import LMConfig as JaxLMConfig
from repro.serve import engine as jax_engine
from repro.serve.spec import SpecConfig as JaxSpecConfig
from repro_torch.bench import profile_generate
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.core import events
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import layers
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve import engine
from repro_torch.serve.spec import SpecConfig

torch.set_num_threads(1)

ARCH = "qwen2-vl-7b"
PROMPT_LENS = (10, 6, 4, 8)
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
        assert mine.attn_config()._asdict() == ref.attn_config()._asdict()
        assert mine.block_config().mlp == ref.block_config().mlp == "swiglu"
    ac = ours.config.attn_config()
    assert (ac.num_heads, ac.num_kv_heads, ac.head_dim) == (28, 4, 128)
    assert ac.mrope_sections == (16, 24, 24)


# ---------------------------------------------------------------------------
# M-RoPE and its position streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections,dh", [((4, 2, 2), 16),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, dh):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
    pos3 = rng.integers(0, 300, (3, 2, 7)).astype(np.int32)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             sections, 1e6)
    want = jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                  sections, 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    # text tokens carry t == h == w: M-RoPE is 1-D RoPE there
    flat = np.broadcast_to(pos3[0], pos3.shape).copy()
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(flat),
                             sections, 1e6)
    rope = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[0]),
                             1e6)
    np.testing.assert_allclose(got.numpy(), rope.numpy(), **FP32)
    # bf16 in, bf16 out (computed in fp32)
    xb = torch.from_numpy(x).bfloat16()
    gb = layers.apply_mrope(xb, torch.from_numpy(pos3), sections, 1e6)
    assert gb.dtype == torch.bfloat16
    with pytest.raises(AssertionError):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                           (1, 1, 1))


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
    assert "blocks.1.attn.bq" in bridged
    lm.load_state_dict(bridged)
    return jlm, jax.tree.map(jnp.asarray, jparams), lm


@pytest.mark.parametrize("s", [3, 4, 9])
def test_positions3_match_jax(pair, s):
    """Patches at (0, h, w) on the 2x2 grid, text 1-D from the grid's
    edge (``max(gh, gw)``); a prompt shorter than the patches is all
    grid."""
    jlm, _, lm = pair
    toks = np.zeros((2, s), np.int32)
    got = lm._vlm_positions3(torch.from_numpy(toks))
    want = jlm._vlm_positions3(jnp.asarray(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _patches(cfg, b, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(
        np.float32)


def test_param_counts_match_jax(pair):
    jlm, _, lm = pair
    assert lm.num_params() == jlm.num_params()
    assert lm.num_active_params() == lm.num_params()


@pytest.mark.parametrize("page_size,kv_dtype", [(0, None), (4, None),
                                                (4, torch.int8)])
def test_smoke_logits_match_jax(pair, page_size, kv_dtype):
    jlm, jp, lm = pair
    cfg = lm.cfg
    rng = np.random.default_rng(7)
    b, s, max_seq = len(PROMPT_LENS), max(PROMPT_LENS), 32
    toks = np.zeros((b, s), np.int32)
    for i, n in enumerate(PROMPT_LENS):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
    lens = np.asarray(PROMPT_LENS, np.int32)
    kw = dict(page_size=page_size, num_pages=b * 8 + 1,
              table_width=8) if page_size else {}
    jstate = jlm.init_decode_state(
        b, max_seq, **kw, kv_dtype=jnp.int8 if kv_dtype else None)
    state = lm.init_decode_state(b, max_seq, **kw, kv_dtype=kv_dtype)
    if page_size:
        table = np.arange(1, b * 8 + 1, dtype=np.int32).reshape(b, 8)
        jstate = dict(jstate, caches=jstate["caches"]._replace(
            page_table=jnp.broadcast_to(jnp.asarray(table),
                                        jstate["caches"].page_table.shape)))
        state["caches"].page_table.copy_(torch.from_numpy(table))
    patches = _patches(cfg, b)
    jlogits, jstate = jax.jit(jlm.prefill)(
        jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens),
             "patch_embeds": jnp.asarray(patches)}, jstate)
    with torch.inference_mode():
        logits, state = lm.prefill({"tokens": torch.from_numpy(toks),
                                    "lengths": torch.from_numpy(lens),
                                    "patch_embeds": torch.from_numpy(
                                        patches)}, state)
    assert _rel(logits, jlogits) <= 1e-5
    jdecode = jax.jit(jlm.decode_step)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        jlogits, jstate = jdecode(jp, jnp.asarray(nxt), jstate)
        with torch.inference_mode():
            logits, state = lm.decode_step(torch.from_numpy(nxt), state)
        assert _rel(logits, jlogits) <= 1e-5


def test_patch_embeds_need_a_prompt_of_n_patches(pair):
    _, _, lm = pair
    n = lm.cfg.n_patches
    state = lm.init_decode_state(2, 16)
    with pytest.raises(ValueError, match="patch"):
        lm.prefill({"tokens": torch.zeros((2, n - 1), dtype=torch.int32),
                    "patch_embeds": torch.zeros((2, n, lm.cfg.d_model))},
                   state)
    # the patch embeddings move the logits; without them text-only
    toks = torch.arange(1, n + 3, dtype=torch.int32)[None].expand(2, -1)
    with torch.inference_mode():
        a, _ = lm.prefill({"tokens": toks}, lm.init_decode_state(2, 16))
        b, _ = lm.prefill({"tokens": toks, "patch_embeds": torch.from_numpy(
            _patches(lm.cfg, 2))}, lm.init_decode_state(2, 16))
    assert not torch.allclose(a, b)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(vocab, lens=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


@pytest.mark.parametrize("page_size,kv_dtype", [(0, None), (4, None),
                                                (4, "int8")])
def test_greedy_tokens_equal_the_jax_engine(pair, page_size, kv_dtype):
    jlm, jp, lm = pair
    prompts = _prompts(lm.cfg.vocab)
    extra = {"patch_embeds": _patches(lm.cfg, len(prompts))}
    sc = dict(max_seq=64, page_size=page_size, kv_dtype=kv_dtype)
    want = jax_engine.Engine(jlm, jp, jax_engine.ServeConfig(
        **sc)).generate(prompts, 8, extra_batch=extra)
    eng = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")
    got = eng.generate(prompts, 8, extra_batch=extra)
    assert got == want
    assert eng.host_syncs == 1
    assert len({tuple(t) for t in got}) > 1
    # a tensor works as well as a numpy array, and text-only differs
    assert eng.generate(prompts, 8, extra_batch={
        "patch_embeds": torch.from_numpy(extra["patch_embeds"])}) == got
    assert eng.generate(prompts, 8) != got


def test_reference_and_streaming_take_extra_batch(pair):
    """``generate_reference`` and streaming merge ``extra_batch`` into
    their prefill too: equal-length prompts (the JAX reference loop's
    oracle case) give the JAX reference loop's tokens."""
    jlm, jp, lm = pair
    prompts = _prompts(lm.cfg.vocab, (7, 7, 7))
    extra = {"patch_embeds": _patches(lm.cfg, 3, seed=4)}
    sc = dict(max_seq=64)
    want = jax_engine.Engine(jlm, jp, jax_engine.ServeConfig(
        **sc)).generate_reference(prompts, 6, extra_batch=extra)
    eng = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")
    assert eng.generate_reference(prompts, 6, extra_batch=extra) == want
    streamed = [[] for _ in prompts]
    out = eng.generate(prompts, 6, extra_batch=extra,
                       stream_cb=lambda i, t, d: streamed[i].extend(t))
    assert out == streamed == want


def _workload(vocab, seed=5):
    """(prompt, budget) per rid: a 12-token shared prefix behind four of
    six prompts (full-page hits and in-page forks at page size 8)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, 12).tolist()

    def tail(n):
        return rng.integers(1, vocab, n).tolist()

    prompts = [shared + tail(5), shared + tail(3), tail(7),
               shared[:10] + tail(4), shared + tail(6), tail(4)]
    return list(zip(prompts, [9, 6, 11, 5, 8, 7]))


def _run(mod, sched, work):
    for rid, (prompt, budget) in enumerate(work):
        sched.submit(mod.Request(rid=rid, prompt=list(prompt),
                                 max_new_tokens=budget))
    sched.run()
    return {rid: list(r.generated) for rid, r in sched.completed.items()}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_scheduler_with_prefix_cache_matches_jax(pair, kv_dtype):
    """Text-only admissions (the JAX scheduler passes no patch
    embeddings, ``repro/serve/engine.py:691``, ``:736``); a prefix hit
    prefills its suffix with M-RoPE restarting at 0, as the JAX
    package's does: both give the same tokens and metrics."""
    jlm, jp, lm = pair
    sc = dict(max_seq=64, batch_slots=3, admission_chunk=4, page_size=8,
              kv_dtype=kv_dtype)
    work = _workload(lm.cfg.vocab)
    jsched = jax_engine.BatchScheduler(jax_engine.Engine(
        jlm, jp, jax_engine.ServeConfig(**sc)))
    want = _run(jax_engine, jsched, work)
    eng = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")
    sched = engine.BatchScheduler(eng)
    got = _run(engine, sched, work)
    assert got == want
    for k in ("segments", "admissions", "prefix_hits", "cow_copies",
              "decode_steps"):
        assert sched.metrics[k] == jsched.metrics[k], k
    assert sched.metrics["prefix_hits"] > 0
    assert eng.host_syncs == sched.metrics["segments"]
    sched.check()
    sched.pool.check()


def test_suffix_prefill_restarts_mrope_at_zero(pair):
    """The quirk the scheduler relies on, at the model: a suffix prefill
    after a resident prefix equals the JAX model's, whose positions3 are
    the suffix's own (``repro/models/lm.py:478``)."""
    jlm, jp, lm = pair
    cfg = lm.cfg
    rng = np.random.default_rng(11)
    pre = rng.integers(0, cfg.vocab, (1, 8)).astype(np.int32)
    suf = rng.integers(0, cfg.vocab, (1, 5)).astype(np.int32)
    kw = dict(page_size=4, num_pages=9, table_width=8)
    table = np.arange(1, 9, dtype=np.int32)[None]
    jstate = jlm.init_decode_state(1, 32, **kw)
    jstate = dict(jstate, caches=jstate["caches"]._replace(
        page_table=jnp.broadcast_to(jnp.asarray(table),
                                    jstate["caches"].page_table.shape)))
    state = lm.init_decode_state(1, 32, **kw)
    state["caches"].page_table.copy_(torch.from_numpy(table))
    _, jstate = jax.jit(jlm.prefill)(jp, {"tokens": jnp.asarray(pre)},
                                     jstate)
    jl, _ = jax.jit(jlm.prefill)(
        jp, {"tokens": jnp.asarray(suf),
             "prefix_len": jnp.asarray([8], jnp.int32)}, jstate)
    with torch.inference_mode():
        _, state = lm.prefill({"tokens": torch.from_numpy(pre)}, state)
        got, _ = lm.prefill({"tokens": torch.from_numpy(suf),
                             "prefix_len": torch.tensor([8],
                                                        dtype=torch.int32)},
                            state)
    assert _rel(got, jl) <= 1e-5


DRAFT_KW = dict(name="vlm-spec-d", family="dense", vocab=256, d_model=32,
                n_layers=1, num_heads=4, num_kv_heads=2, d_ff=64)


def test_spec_with_a_vlm_target_equals_the_jax_spec_engine(pair):
    """fp32 greedy spec (K = 3, a dense draft) with a vlm target and patch
    embeddings (merged into the target's prefill, never the draft's): the
    fused, the streamed and the scheduler's tokens equal the JAX spec
    engine's on the same traffic."""
    jlm, jp, lm = pair
    djlm = JaxLM(JaxLMConfig(**DRAFT_KW), default_features().with_(
        remat_policy="none"), dtype=jnp.float32)
    dp = jax.device_get(jax.jit(djlm.init)(jax.random.PRNGKey(1)))
    dlm = LM(LMConfig(**DRAFT_KW), torch.float32, device="cpu")
    dlm.load_state_dict(params_from_jax(dp, LMConfig(**DRAFT_KW)))
    sc = dict(max_seq=96, batch_slots=4, page_size=16, admission_chunk=8)
    prompts = _prompts(lm.cfg.vocab, (5, 4, 8), seed=9)
    extra = {"patch_embeds": _patches(lm.cfg, 3, seed=8)}
    jspec = jax_engine.Engine(
        jlm, jp, jax_engine.ServeConfig(**sc),
        spec=JaxSpecConfig(draft_config=JaxLMConfig(**DRAFT_KW),
                           num_draft_tokens=3),
        draft_params=jax.tree.map(jnp.asarray, dp))
    want = jspec.generate(prompts, 12, extra_batch=extra)
    eng = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu",
                        spec=SpecConfig(draft_config=LMConfig(**DRAFT_KW),
                                        num_draft_tokens=3),
                        draft_lm=dlm)
    assert eng.generate(prompts, 12, extra_batch=extra) == want
    assert eng.spec_stats["rounds"] > 0
    streamed = [[] for _ in prompts]
    assert eng.generate(prompts, 12, extra_batch=extra,
                        stream_cb=lambda i, t, d: streamed[i].extend(t)
                        ) == streamed == want
    jsched = jax_engine.BatchScheduler(jspec)
    sched = engine.BatchScheduler(eng)
    for mod, s in ((jax_engine, jsched), (engine, sched)):
        for rid, p in enumerate(prompts):
            s.submit(mod.Request(rid=rid, prompt=list(p), max_new_tokens=10,
                                 spec=rid % 2 == 0))
        s.run()
    assert ({r: list(q.generated) for r, q in sched.completed.items()}
            == {r: list(q.generated) for r, q in jsched.completed.items()})
    sched.check()


# ---------------------------------------------------------------------------
# declared traffic and the entry points
# ---------------------------------------------------------------------------

def test_declared_steps_equal_the_dense_models_plus_the_patches(pair):
    """M-RoPE changes no product: a vlm step declares what the same
    shapes declare as a dense model, and its prefill also reads the
    patch embeddings once."""
    _, _, lm = pair
    dense = LM(dataclasses.replace(lm.cfg, family="dense",
                                   mrope_sections=()), torch.float32, "cpu")
    dense.load_state_dict(lm.state_dict())
    toks = torch.arange(1, 7, dtype=torch.int32)[None].expand(2, -1)
    patches = torch.from_numpy(_patches(lm.cfg, 2))
    counts = {}
    for name, m, batch in (("vlm", lm, {"tokens": toks,
                                        "patch_embeds": patches}),
                           ("dense", dense, {"tokens": toks})):
        state = m.init_decode_state(2, 16)
        with torch.inference_mode(), events.collect() as pre:
            _, state = m.prefill(batch, state)
        with torch.inference_mode(), events.collect() as dec:
            m.decode_step(toks[:, :1], state)
        counts[name] = (pre, dec)
    (vp, vd), (dp, dd) = counts["vlm"], counts["dense"]
    assert vd == dd
    assert vp["FLOPS_TOTAL"] == dp["FLOPS_TOTAL"]
    assert vp["HBM_ARG_BYTES"] == dp["HBM_ARG_BYTES"] + 4 * patches.numel()
    assert vp["HBM_OUT_BYTES"] == dp["HBM_OUT_BYTES"]


def test_serve_launcher_runs_qwen2_vl(tmp_path):
    path = tmp_path / "vlm.json"
    assert serve_launcher.main([
        "--arch", ARCH, "--smoke-dims", "--device", "cpu",
        "--requests", "4", "--slots", "2", "--prompt-len", "6",
        "--max-new", "4", "--page-size", "8", "--kv-dtype", "int8",
        "--shared-prefix", "10", "--dtype", "fp32", "--json",
        str(path)]) == 0
    d = json.loads(path.read_text())
    assert d["device"] == "cpu" and d["new_tokens"] == 4 * 4
    assert d["host_syncs"] == d["segments"] > 0


def test_profile_generate_takes_qwen2_vl():
    lens = profile_generate.PROMPT_LENS[ARCH]
    cfg = get_arch(ARCH).config
    assert len(lens) == 8 and min(lens) >= cfg.n_patches
    assert profile_generate.depth(ARCH) == 28
    assert ARCH not in profile_generate.RECURRENT
    smoke = get_arch(ARCH).smoke
    extra = profile_generate.stub_inputs(smoke, (6, 5), torch.bfloat16,
                                         torch.device("cpu"))
    assert extra["patch_embeds"].shape == (2, smoke.n_patches, smoke.d_model)
    assert extra["patch_embeds"].dtype == torch.bfloat16
    again = profile_generate.stub_inputs(smoke, (6, 5), torch.bfloat16,
                                         torch.device("cpu"))
    assert torch.equal(extra["patch_embeds"], again["patch_embeds"])
