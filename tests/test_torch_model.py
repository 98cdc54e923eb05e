"""The port's model stack against the JAX package, on the CPU, in fp32.

Numerics (``rms_norm``, ``apply_rope``, ``swiglu``) on numpy-seeded inputs;
then qwen2-0.5b ``SMOKE`` with the JAX ``LM.init`` parameters bridged over
(``repro_torch.bridge.params_from_jax``): prefill logits and three decode
steps over ragged prompts, with dense and paged (page_size 4) caches, and
paged caches stored as fp32, bf16 or int8 with a suffix prefilled against a
resident prefix, must match the JAX model within fp32 tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import qwen2_0_5b as jax_cfgs
from repro.configs import zamba2_1_2b as jax_zamba
from repro.core.features import default_features
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm_mod
from repro.models.lm import LM as JaxLM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.configs.qwen2_0_5b import CONFIG, SMOKE
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA_CONFIG
from repro_torch.configs.zamba2_1_2b import SMOKE as ZAMBA_SMOKE
from repro_torch.models import layers
from repro_torch.models import lm as lm_mod
from repro_torch.models.lm import LM

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_port_verbatim():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(jax_cfgs.CONFIG)
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(jax_cfgs.SMOKE)
    for ours, theirs in ((CONFIG, jax_cfgs.CONFIG), (SMOKE, jax_cfgs.SMOKE)):
        assert ours.resolved_head_dim == theirs.resolved_head_dim
        assert ours.attn_config()._asdict() == theirs.attn_config()._asdict()
        bc, jbc = ours.block_config(), theirs.block_config()
        assert (bc.d_ff, bc.norm, bc.mlp, bc.norm_eps) == \
            (jbc.d_ff, jbc.norm, jbc.mlp, jbc.norm_eps)
    spec = get_arch("qwen2-0.5b")
    assert spec.config is CONFIG and spec.smoke is SMOKE
    assert spec.skipped("long_500k")
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


# ---------------------------------------------------------------------------
# layer numerics
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 56)).astype(np.float32) * 3.0
    scale = rng.standard_normal(56).astype(np.float32)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    want = jax_layers.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(scale)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # bf16 in, bf16 out (computed in fp32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert layers.rms_norm(xb, torch.from_numpy(scale)).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 7, 8)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(9) + 30]).astype(np.int32)
    np.testing.assert_allclose(layers.rope_freqs(8, theta).numpy(),
                               np.asarray(jax_layers.rope_freqs(8, theta)),
                               **TOL)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 56)).astype(np.float32)
    wg, wu = (rng.standard_normal((56, 128)).astype(np.float32) / 8
              for _ in range(2))
    wd = rng.standard_normal((128, 56)).astype(np.float32) / 11
    got = layers.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    want = jax_layers.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_truncated_normal_bounds_and_spread():
    g = torch.Generator().manual_seed(0)
    t = layers.truncated_normal_(torch.empty(200_000), 0.5, g)
    assert t.abs().max().item() <= 1.0                  # +-2 sigma
    # std of N(0,1) truncated at +-2 is 0.8796
    assert abs(t.std().item() / 0.5 - 0.8796) < 0.01
    again = layers.truncated_normal_(torch.empty(200_000), 0.5,
                                     torch.Generator().manual_seed(0))
    assert torch.equal(t, again)                        # seeded


# ---------------------------------------------------------------------------
# the LM against JAX on SMOKE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_models():
    jlm = JaxLM(jax_cfgs.SMOKE, default_features().with_(remat_policy="none"),
                dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    lm = LM(SMOKE, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, SMOKE))
    return jlm, jparams, lm


def test_bridge_covers_every_weight_and_init_matches_spread(smoke_models):
    jlm, jparams, lm = smoke_models
    bridged = params_from_jax(jparams, SMOKE)
    assert set(bridged) == set(lm.state_dict())
    np.testing.assert_array_equal(
        lm.blocks[1].attn.wq.numpy(), jparams["blocks"]["attn"]["wq"][1])
    # the port's own init draws from the same distributions as LM.init
    ours = LM(SMOKE, torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    for name, theirs in bridged.items():
        mine = ours.state_dict()[name]
        assert mine.shape == theirs.shape, name
        if theirs.std() > 0:
            assert abs(mine.std() / theirs.std() - 1) < 0.15, name
        else:
            assert torch.equal(mine, theirs), name     # biases 0, norms 1


def _jax_state(jlm, b, max_seq, page_size, table):
    if not page_size:
        return jlm.init_decode_state(b, max_seq)
    st = jlm.init_decode_state(b, max_seq, page_size=page_size,
                               num_pages=int(table.max()) + 1,
                               table_width=table.shape[1])
    c = st["caches"]
    tbl = jnp.broadcast_to(jnp.asarray(table)[None],
                           (c.length.shape[0],) + table.shape)
    return {"caches": c._replace(page_table=tbl)}


def _port_state(lm, b, max_seq, page_size, table):
    if not page_size:
        return lm.init_decode_state(b, max_seq)
    st = lm.init_decode_state(b, max_seq, page_size=page_size,
                              num_pages=int(table.max()) + 1,
                              table_width=table.shape[1])
    st["caches"].page_table.copy_(torch.from_numpy(table))
    return st


@pytest.mark.parametrize("page_size", [0, 4])
def test_prefill_and_decode_logits_match_jax(smoke_models, page_size):
    jlm, jparams, lm = smoke_models
    jp = jax.tree.map(jnp.asarray, jparams)
    rng = np.random.default_rng(3)
    lens = np.array([11, 4, 1], np.int32)
    b, s, steps, max_seq = len(lens), int(lens.max()), 3, 24
    toks = rng.integers(0, SMOKE.vocab, (b, s)).astype(np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    # a shuffled page table: row b's pages are anywhere in the pool
    per_row = -(-(lens + steps) // max(page_size, 1))
    table = np.zeros((b, int(per_row.max())), np.int32)
    ids = rng.permutation(np.arange(1, 1 + int(per_row.sum())))
    for i, npg in enumerate(np.cumsum(per_row) - per_row):
        table[i, :per_row[i]] = ids[npg:npg + per_row[i]]

    jstate = _jax_state(jlm, b, max_seq, page_size, table)
    jlogits, jstate = jax.jit(jlm.prefill)(
        jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)},
        jstate)
    state = _port_state(lm, b, max_seq, page_size, table)
    with torch.inference_mode():
        logits, state = lm.prefill({"tokens": torch.from_numpy(toks),
                                    "lengths": torch.from_numpy(lens)},
                                   state)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert state["caches"].length.tolist() == lens.tolist()

    jdecode = jax.jit(jlm.decode_step)
    for _ in range(steps):
        nxt = rng.integers(0, SMOKE.vocab, (b, 1)).astype(np.int32)
        jlogits, jstate = jdecode(jp, jnp.asarray(nxt), jstate)
        with torch.inference_mode():
            logits, state = lm.decode_step(torch.from_numpy(nxt), state)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
    assert state["caches"].length.tolist() == (lens + steps).tolist()


@pytest.mark.parametrize("kv_dtype", [None, "fp32", "bf16", "int8"])
def test_paged_kv_dtype_suffix_prefill_and_decode_match_jax(smoke_models,
                                                            kv_dtype):
    """Pages stored as fp32, bf16 or int8 codes with per-token scales: a
    prefix prefilled into the pages, the rest of the prompt prefilled as a
    suffix against them (``batch["prefix_len"]``, the prefix-cache hit
    path), then decode steps — logits, and the int8 codes and scales, must
    match the JAX model's."""
    jlm, jparams, lm = smoke_models
    jp = jax.tree.map(jnp.asarray, jparams)
    jdt = {None: None, "fp32": jnp.float32, "bf16": jnp.bfloat16,
           "int8": jnp.int8}[kv_dtype]
    tdt = {None: None, "fp32": torch.float32, "bf16": torch.bfloat16,
           "int8": torch.int8}[kv_dtype]
    rng = np.random.default_rng(9)
    toks = rng.integers(0, SMOKE.vocab, (1, 11)).astype(np.int32)
    table = np.array([[3, 1, 5, 2]], np.int32)      # ps 4: 16 tokens
    jst = jlm.init_decode_state(1, 16, page_size=4, num_pages=6,
                                table_width=4, kv_dtype=jdt)
    jc = jst["caches"]
    jst = {"caches": jc._replace(page_table=jnp.broadcast_to(
        jnp.asarray(table)[None], (jc.length.shape[0],) + table.shape))}
    st = lm.init_decode_state(1, 16, page_size=4, num_pages=6, table_width=4,
                              kv_dtype=tdt)
    st["caches"].page_table.copy_(torch.from_numpy(table))
    jprefill = jax.jit(jlm.prefill)
    for part, extra in ((toks[:, :6], {}),
                        (toks[:, 6:], {"prefix_len": np.array([6], np.int32)})):
        jlogits, jst = jprefill(
            jp, {"tokens": jnp.asarray(part),
                 **{k: jnp.asarray(v) for k, v in extra.items()}}, jst)
        with torch.inference_mode():
            logits, st = lm.prefill(
                {"tokens": torch.from_numpy(part),
                 **{k: torch.from_numpy(v) for k, v in extra.items()}}, st)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert st["caches"].length.tolist() == [11]
    jdecode = jax.jit(jlm.decode_step)
    for _ in range(3):
        nxt = rng.integers(0, SMOKE.vocab, (1, 1)).astype(np.int32)
        jlogits, jst = jdecode(jp, jnp.asarray(nxt), jst)
        with torch.inference_mode():
            logits, st = lm.decode_step(torch.from_numpy(nxt), st)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    c, jc = st["caches"], jst["caches"]
    assert c.k_pages.dtype == (tdt or torch.float32)
    assert c.quantized == (kv_dtype == "int8")
    if c.quantized:
        live = table[0].tolist()
        codes = c.k_pages[:, live].numpy()
        jcodes = np.asarray(jc.k_pages[:, live])
        # a code may differ by one where fp32 rounding of K lands on .5
        assert np.abs(codes.astype(int) - jcodes.astype(int)).max() <= 1
        assert (codes == jcodes).mean() > 0.999
        np.testing.assert_allclose(c.v_scale[:, live].numpy(),
                                   np.asarray(jc.v_scale[:, live]), **TOL)


def test_untied_lm_head_matches_jax():
    """Dense configs with their own ``lm_head`` (tie_embeddings=False)."""
    cfg = dataclasses.replace(SMOKE, tie_embeddings=False, n_layers=1)
    jlm = JaxLM(dataclasses.replace(jax_cfgs.SMOKE, tie_embeddings=False,
                                    n_layers=1),
                default_features().with_(remat_policy="none"),
                dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(1)))
    lm = LM(cfg, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, cfg))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 5)).astype(
        np.int32)
    jlogits, _ = jax.jit(jlm.prefill)(
        jax.tree.map(jnp.asarray, jparams), {"tokens": jnp.asarray(toks)},
        jlm.init_decode_state(2, 8))
    with torch.inference_mode():
        logits, _ = lm.prefill({"tokens": torch.from_numpy(toks)},
                               lm.init_decode_state(2, 8))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_lm_without_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(SMOKE)
    with pytest.raises(ValueError, match="unknown family"):
        LM(dataclasses.replace(SMOKE, family="rnn"), device="cpu")


# ---------------------------------------------------------------------------
# the hybrid family: zamba2-1.2b SMOKE (Mamba2 + one shared block)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba_models():
    jlm = JaxLM(jax_zamba.SMOKE, default_features().with_(
        remat_policy="none"), dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    lm = LM(ZAMBA_SMOKE, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, ZAMBA_SMOKE))
    return jlm, jparams, lm


def test_zamba2_config_ports_verbatim():
    assert dataclasses.asdict(ZAMBA_CONFIG) == \
        dataclasses.asdict(jax_zamba.CONFIG)
    assert dataclasses.asdict(ZAMBA_SMOKE) == \
        dataclasses.asdict(jax_zamba.SMOKE)
    for ours, theirs in ((ZAMBA_CONFIG, jax_zamba.CONFIG),
                         (ZAMBA_SMOKE, jax_zamba.SMOKE)):
        # the reference's fields; the port's ``tp`` (the rank's model
        # axis) is None on an unsharded config
        jmc = theirs.mamba_config()
        assert {k: getattr(ours.mamba_config(), k) for k in jmc._fields} \
            == jmc._asdict()
        assert ours.mamba_config().tp is None
        mc = ours.mamba_config()
        assert (mc.d_inner, mc.num_heads, mc.conv_channels) == \
            (theirs.mamba_config().d_inner, theirs.mamba_config().num_heads,
             theirs.mamba_config().conv_channels)
    assert (ZAMBA_CONFIG.mamba_config().d_inner,
            ZAMBA_CONFIG.mamba_config().num_heads,
            ZAMBA_CONFIG.mamba_config().conv_channels) == (4096, 64, 4224)
    assert lm_mod._hybrid_groups(38, 6) == jax_lm_mod._hybrid_groups(38, 6)
    assert len(lm_mod._hybrid_groups(38, 6)) == 7
    spec = get_arch("zamba2-1.2b")
    assert spec.config is ZAMBA_CONFIG and spec.smoke is ZAMBA_SMOKE
    assert spec.source == "arXiv:2411.15242; hf"


def test_zamba2_bridge_covers_every_weight(zamba_models):
    _, jparams, lm = zamba_models
    bridged = params_from_jax(jparams, ZAMBA_SMOKE)
    assert set(bridged) == set(lm.state_dict())
    np.testing.assert_array_equal(lm.mamba[2].in_proj.numpy(),
                                  jparams["mamba"]["in_proj"][2])
    np.testing.assert_array_equal(lm.shared_attn.attn.wq.numpy(),
                                  jparams["shared_attn"]["attn"]["wq"])
    ours = LM(ZAMBA_SMOKE, torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    for name, theirs in bridged.items():
        mine = ours.state_dict()[name]
        assert mine.shape == theirs.shape, name
        if name.endswith(("A_log", "D", "conv_b", "scale")):
            torch.testing.assert_close(mine, theirs)
        elif not name.endswith("dt_bias"):
            assert abs(mine.std() / theirs.std() - 1) < 0.2, name


def test_zamba2_prefill_and_decode_logits_match_jax(zamba_models):
    jlm, jparams, lm = zamba_models
    jp = jax.tree.map(jnp.asarray, jparams)
    rng = np.random.default_rng(19)
    b, s, steps, max_seq = 2, 37, 3, 48        # 37 > 2 chunks of 16
    toks = rng.integers(0, ZAMBA_SMOKE.vocab, (b, s)).astype(np.int32)
    jlogits, jstate = jax.jit(jlm.prefill)(
        jp, {"tokens": jnp.asarray(toks)}, jlm.init_decode_state(b, max_seq))
    state = lm.init_decode_state(b, max_seq)
    assert state["mamba"]["ssd"][0].shape == (4, b, 8, 16, 16)
    assert state["attn_caches"].k.shape == (2, b, max_seq, 4, 16)
    with torch.inference_mode():
        logits, state = lm.prefill({"tokens": torch.from_numpy(toks)}, state)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    jdecode = jax.jit(jlm.decode_step)
    for _ in range(steps):
        nxt = rng.integers(0, ZAMBA_SMOKE.vocab, (b, 1)).astype(np.int32)
        jlogits, jstate = jdecode(jp, jnp.asarray(nxt), jstate)
        with torch.inference_mode():
            logits, state = lm.decode_step(torch.from_numpy(nxt), state)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
    assert state["attn_caches"].length.tolist() == [s + steps] * b
    for got, want in ((state["mamba"]["ssd"][0], jstate["mamba"]["ssd"][0]),
                      (state["mamba"]["conv"], jstate["mamba"]["conv"]),
                      (state["attn_caches"].k, jstate["attn_caches"].k)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_zamba2_state_rules(zamba_models):
    _, _, lm = zamba_models
    with pytest.raises(ValueError, match="attention-cache family"):
        lm.init_decode_state(2, 16, page_size=4)
    with pytest.raises(ValueError, match="kv_dtype needs"):
        lm.init_decode_state(2, 16, kv_dtype=torch.int8)
    toks = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="lengths"):
        lm.prefill({"tokens": toks, "lengths": torch.tensor([5, 3])},
                   lm.init_decode_state(2, 16))


def test_zamba2_bf16_keeps_the_decay_leaves_fp32(zamba_models):
    _, jparams, _ = zamba_models
    lm = LM(ZAMBA_SMOKE, torch.bfloat16, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, ZAMBA_SMOKE,
                                       dtype=torch.bfloat16))
    for i, blk in enumerate(lm.mamba):
        for leaf in ("A_log", "dt_bias", "D"):
            got = getattr(blk, leaf)
            assert got.dtype == torch.float32, leaf
            np.testing.assert_array_equal(got.numpy(),
                                          jparams["mamba"][leaf][i])
        assert blk.in_proj.dtype == torch.bfloat16
    fresh = LM(ZAMBA_SMOKE, torch.bfloat16, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert fresh.mamba[0].dt_bias.dtype == torch.float32
    with torch.inference_mode():
        logits, st = fresh.prefill(
            {"tokens": torch.ones((1, 20), dtype=torch.int32)},
            fresh.init_decode_state(1, 24))
    assert logits.dtype == torch.bfloat16 and torch.isfinite(
        logits.float()).all()
    assert st["mamba"]["ssd"][0].dtype == torch.float32
    assert st["attn_caches"].k.dtype == torch.bfloat16
