"""The reference's in-place dense decode (``decode_attention_token``,
``FeatureSet.decode_inplace_cache``) against the port's one dense decode,
which writes the cache in place whatever the flag says, on the CPU, fp32.

* the port's ``decode_attention`` (the token written into the cache, then
  attended with it) against the JAX package's ``decode_attention_token``
  (a two-part softmax over a read-only cache slice and the new token),
  ragged lengths that fit the buffer: outputs within 1e-5, and the cache
  row written equals the token's K/V that the JAX function returns;
* qwen2-0.5b ``SMOKE`` (JAX ``LM.init`` parameters bridged over) with
  ``decode_inplace_cache`` on in both packages: ragged prefill, then four
  decode steps that fill the cache to its end, logits within 1e-5 of
  max|logit| of the JAX LM's and equal to the port's with the flag off;
  the caches equal too;
* ``Engine.generate`` greedy tokens equal with the feature on and off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.core.features import default_features as jax_features
from repro.models import attention as jax_attn
from repro.models.lm import LM as JaxLM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.core.features import default_features
from repro_torch.models import attention as attn
from repro_torch.models.lm import LM
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(1)


def test_decode_attention_token_matches_jax():
    cfg = jax_attn.AttnConfig(d_model=32, num_heads=4, num_kv_heads=2,
                              head_dim=16, qkv_bias=True)
    jp = jax_attn.init_attn(jax.random.PRNGKey(0), cfg)
    p = attn.Attention(attn.AttnConfig(**cfg._asdict()), torch.float32,
                       torch.device("cpu"))
    with torch.no_grad():
        for k, v in jp.items():
            getattr(p, k).copy_(torch.from_numpy(np.array(v)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    kc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    length = np.array([0, 4, 9], np.int32)
    cache = attn.KVCache(k=torch.from_numpy(kc.copy()),
                         v=torch.from_numpy(vc.copy()),
                         length=torch.from_numpy(length))
    out, cache = attn.decode_attention(
        p, torch.from_numpy(x), attn.AttnConfig(**cfg._asdict()), cache)
    want, k_t, v_t = jax_attn.decode_attention_token(
        jp, jnp.asarray(x), cfg, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(length))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    rows = np.arange(3)
    for got, tok in ((cache.k, k_t), (cache.v, v_t)):
        np.testing.assert_allclose(got.numpy()[rows, length],
                                   np.asarray(tok)[:, 0], rtol=1e-5,
                                   atol=1e-5)
    assert cache.length.tolist() == (length + 1).tolist()


def _models(inplace):
    jcfg = jax_get_arch("qwen2-0.5b").smoke
    jlm = JaxLM(jcfg, jax_features().with_(decode_inplace_cache=inplace),
                dtype=jnp.float32)
    params = jlm.init(jax.random.PRNGKey(0))
    cfg = get_arch("qwen2-0.5b").smoke
    lm = LM(cfg, torch.float32, "cpu", features=default_features().with_(
        decode_inplace_cache=inplace))
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    return jlm, params, lm


def test_inplace_decode_matches_jax_and_the_default_path():
    jlm, params, lm = _models(True)
    _, _, base = _models(False)
    rng = np.random.default_rng(1)
    smax, lens = 12, np.array([8, 5, 3], np.int32)
    tokens = rng.integers(1, lm.cfg.vocab, (3, 8)).astype(np.int32)
    tb = {"tokens": torch.from_numpy(tokens),
          "lengths": torch.from_numpy(lens)}
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    st = lm.init_decode_state(3, smax)
    st_b = base.init_decode_state(3, smax)
    jst = jlm.init_decode_state(3, smax)
    with torch.no_grad():
        logits, st = lm.prefill(tb, st)
        _, st_b = base.prefill(tb, st_b)
    jlogits, jst = jlm.prefill(params, jb, jst)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-5 * np.abs(jlogits).max())
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for step in range(4):              # row 0 fills the buffer
        with torch.no_grad():
            got, st = lm.decode_step(tok, st)
            ref, st_b = base.decode_step(tok, st_b)
        want, jst = jlm.decode_step(params, jnp.asarray(tok.numpy()), jst)
        scale = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * scale, err_msg=f"step {step}")
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        tok = torch.argmax(got, -1)[:, None].to(torch.int32)
    assert st["caches"].length.tolist() == (lens + 4).tolist()
    torch.testing.assert_close(st["caches"].k, st_b["caches"].k, rtol=0,
                               atol=0)
    torch.testing.assert_close(st["caches"].v, st_b["caches"].v, rtol=0,
                               atol=0)


def test_engine_tokens_equal_with_the_feature_on_and_off():
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, n).tolist() for n in (9, 4, 6)]
    outs = []
    for inplace in (False, True):
        _, _, lm = _models(inplace)
        with torch.no_grad():
            lm.embed.table.mul_(0.1)     # a sigma-1 table echoes its input
        eng = Engine(lm, ServeConfig(max_seq=32), device=lm.device)
        outs.append(eng.generate(prompts, max_new_tokens=6))
    assert outs[0] == outs[1]
    assert len({t for o in outs[0] for t in o}) > 3
