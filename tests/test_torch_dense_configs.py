"""The other dense configs against the JAX package, on the CPU, in fp32.

qwen1.5-0.5b (QKV bias, tied embeddings, G = 1), stablelm-3b (LayerNorm,
head dim 80 at full width) and mistral-large-123b (an explicit head dim,
G = 12 at full width): each full config equals the JAX package's field
for field; at ``SMOKE``, with the JAX ``LM.init`` parameters bridged over,
prefill and decode logits lie within 1e-4 of max|logit| of the JAX
model's over ragged prompts, and greedy tokens equal the JAX ``Engine``'s
with dense and paged KV.  ``layer_norm`` matches
``repro.models.layers.layer_norm`` within rtol = atol = 1e-5.
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
from repro.serve import engine as jax_engine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import layers, transformer
from repro_torch.models.lm import LM
from repro_torch.serve import engine

torch.set_num_threads(1)

ARCHS = ["qwen1.5-0.5b", "stablelm-3b", "mistral-large-123b"]
PROMPT_LENS = (10, 3, 1, 6)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_config_ports_verbatim(arch):
    ours, theirs = get_arch(arch), jax_get_arch(arch)
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(
        theirs.config)
    assert dataclasses.asdict(ours.smoke) == dataclasses.asdict(theirs.smoke)
    assert ours.source == theirs.source
    assert ours.skipped("long_500k") == theirs.skipped("long_500k")
    for mine, ref in ((ours.config, theirs.config),
                      (ours.smoke, theirs.smoke)):
        assert mine.attn_config()._asdict() == ref.attn_config()._asdict()
        bc, jbc = mine.block_config(), ref.block_config()
        assert (bc.d_ff, bc.norm, bc.mlp, bc.norm_eps) == \
            (jbc.d_ff, jbc.norm, jbc.mlp, jbc.norm_eps)
    ac = ours.config.attn_config()
    want = {"qwen1.5-0.5b": (16, 16, 64), "stablelm-3b": (32, 32, 80),
            "mistral-large-123b": (96, 8, 128)}[arch]
    assert (ac.num_heads, ac.num_kv_heads, ac.head_dim) == want


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape", [(3, 7, 64), (2, 80)])
def test_layer_norm_matches_jax(shape, eps):
    rng = np.random.default_rng(len(shape) + int(eps * 1e6))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jax_layers.layer_norm(jnp.asarray(x), {
        "scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, eps)
    got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # bf16 in, bf16 out, fp32 inside (as the reference casts)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = jax_layers.layer_norm(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16), {"scale": jnp.asarray(scale),
                        "bias": jnp.asarray(bias)}, eps)
    gb = layers.layer_norm(xb, torch.from_numpy(scale),
                           torch.from_numpy(bias), eps)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(),
                               np.asarray(wb.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_blocks_take_layernorm_and_refuse_an_unknown_family():
    cfg = get_arch("stablelm-3b").smoke
    lm = LM(cfg, torch.float32, device="cpu")
    assert isinstance(lm.final_norm, transformer.LayerNorm)
    assert isinstance(lm.blocks[0].ln1, transformer.LayerNorm)
    assert set(lm.blocks[0].ln2.state_dict()) == {"scale", "bias"}
    with pytest.raises(ValueError, match="unknown family"):
        LM(dataclasses.replace(cfg, family="rnn"), device="cpu")
    with pytest.raises(ValueError, match="unknown norm"):
        transformer.make_norm("batchnorm", 8, torch.float32,
                              torch.device("cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, cfg = jax_get_arch(arch).smoke, get_arch(arch).smoke
    jlm = JaxLM(jcfg, default_features().with_(remat_policy="none"),
                dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * 0.1
    lm = LM(cfg, torch.float32, device="cpu")
    bridged = params_from_jax(jparams, cfg)
    assert set(bridged) == set(lm.state_dict())
    lm.load_state_dict(bridged)
    return arch, jlm, jax.tree.map(jnp.asarray, jparams), lm


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
    assert _rel(logits, jlogits) <= 1e-4, arch
    jdecode = jax.jit(jlm.decode_step)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        jlogits, jstate = jdecode(jp, jnp.asarray(nxt), jstate)
        with torch.inference_mode():
            logits, state = lm.decode_step(torch.from_numpy(nxt), state)
        assert _rel(logits, jlogits) <= 1e-4, arch


@pytest.mark.parametrize("page_size", [0, 4])
def test_greedy_tokens_equal_the_jax_engine(pair, page_size):
    arch, jlm, jp, lm = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, lm.cfg.vocab, n).tolist() for n in PROMPT_LENS]
    want = jax_engine.Engine(jlm, jp, jax_engine.ServeConfig(
        max_seq=64, page_size=page_size)).generate(prompts, 8)
    eng = engine.Engine(lm, engine.ServeConfig(max_seq=64,
                                               page_size=page_size),
                        device="cpu")
    got = eng.generate(prompts, 8)
    assert got == want, arch
    assert eng.host_syncs == 1
    assert len({tuple(t) for t in got}) > 1


def test_serve_launcher_runs_stablelm_with_int8_pages(tmp_path):
    path = tmp_path / "stablelm.json"
    assert serve_launcher.main([
        "--arch", "stablelm-3b", "--smoke-dims", "--device", "cpu",
        "--requests", "4", "--slots", "2", "--prompt-len", "12",
        "--max-new", "4", "--page-size", "8", "--kv-dtype", "int8",
        "--json", str(path)]) == 0
    d = json.loads(path.read_text())
    assert d["device"] == "cpu" and d["new_tokens"] == 4 * 4
    assert d["host_syncs"] == d["segments"] > 0
