"""The port's xlstm family against the JAX package, on the CPU, in fp32.

The mLSTM and sLSTM blocks (``repro_torch.models.xlstm``) on the
reference blocks' parameters and numpy-seeded inputs: a prefill then
decode steps, each state (and the sLSTM's outputs) within rtol = atol =
1e-5 of ``repro.models.xlstm``, the mLSTM's outputs no further from a
float64 evaluation than the reference's (its normalizer makes them
ill-conditioned, see the test); xlstm-350m ``SMOKE`` (4 layers: 2 pairs) with the
JAX ``LM.init`` parameters bridged over: prefill and decode logits within
1e-4 of max|logit|, greedy tokens equal to the JAX ``Engine``'s through
``generate`` and through the ``BatchScheduler``; the bridge's
``n_layers // 2`` stacking and fp32 gate leaves; pages and speculative
decoding refused.  On the CPU the mLSTM runs the ``ssd_scan`` family's
chunked plain twin (``torch_scan``), the card's kernel #5 its CUDA twin.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro.configs import xlstm_350m as jax_cfgs
from repro.core.features import default_features
from repro.models import xlstm as jax_xlstm
from repro.models.lm import LM as JaxLM
from repro.serve import engine as jax_engine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.configs.xlstm_350m import CONFIG, SMOKE
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import xlstm
from repro_torch.models.lm import LM
from repro_torch.serve import engine
from repro_torch.serve.spec import SpecConfig

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_CFG = dict(d_model=64, num_heads=4, chunk_size=16)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(tree))


def _load(block, params):
    """Copy a reference block's params (numpy) into a port block."""
    sd = {}
    for k, v in params.items():
        if isinstance(v, dict):
            sd.update({f"{k}.{kk}": torch.from_numpy(np.array(vv))
                       for kk, vv in v.items()})
        else:
            sd[k] = torch.from_numpy(np.array(v))
    block.load_state_dict(sd)
    return block


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_xlstm_configs_port_verbatim():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(jax_cfgs.CONFIG)
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(jax_cfgs.SMOKE)
    for ours, theirs in ((CONFIG, jax_cfgs.CONFIG), (SMOKE, jax_cfgs.SMOKE)):
        xc, jxc = ours.xlstm_config(), theirs.xlstm_config()
        # the reference's fields; the port's ``tp``/``tp_ff`` (the rank's
        # model axes) are None on an unsharded config
        assert {k: getattr(xc, k) for k in jxc._fields} == jxc._asdict()
        assert (xc.tp, xc.tp_ff) == (None, None)
        assert (xc.d_inner, xc.head_dim, xc.d_ff) == \
            (jxc.d_inner, jxc.head_dim, jxc.d_ff)
    xc = CONFIG.xlstm_config()
    assert (xc.d_inner, xc.head_dim, xc.d_ff) == (2048, 512, 1408)
    spec = get_arch("xlstm-350m")
    assert spec.config is CONFIG and spec.smoke is SMOKE
    assert spec.source == "arXiv:2405.04517; unverified"
    assert spec.skipped("long_500k") is None


def _mlstm_oracle(P, x, cfg):
    """The mLSTM block in float64 with the sequential recurrence (no
    chunks): every position's output, then the final (C, n)."""
    d = {k: torch.from_numpy(np.array(v["scale"] if isinstance(v, dict)
                                      else v)).double()
         for k, v in P.items()}
    X = torch.from_numpy(x).double()
    b, s, _ = x.shape
    di, h, dh = cfg.d_inner, cfg.num_heads, cfg.head_dim
    hn = X * torch.rsqrt(X.square().mean(-1, keepdim=True) + cfg.norm_eps)
    xm, z = (hn * d["ln"] @ d["w_up"]).split(di, -1)

    def proj(w):
        return (xm @ d[w].reshape(di, h * dh)).reshape(b, s, h, dh)

    q, k, v = proj("wq"), proj("wk") / math.sqrt(dh), proj("wv")
    g = xm @ d["w_gates"] + d["b_gates"]
    log_i, log_f = F.logsigmoid(g[..., :h]), F.logsigmoid(g[..., h:])
    C = torch.zeros((b, h, dh, dh), dtype=torch.float64)
    n = torch.zeros((b, h, dh), dtype=torch.float64)
    ys = []
    for t in range(s):
        f, i = log_f[:, t].exp()[..., None], log_i[:, t].exp()[..., None]
        C = f[..., None] * C + (i * k[:, t])[..., None] * v[:, t, :, None, :]
        n = f * n + i * k[:, t]
        den = torch.einsum("bhk,bhk->bh", q[:, t], n).abs().clamp(min=1e-6)
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], C) / den[..., None])
    y = torch.stack(ys, 1).reshape(b, s, di) * F.silu(z)
    return (X + y @ d["w_down"]).numpy(), (C.numpy(), n.numpy())


@pytest.mark.parametrize("b,s,steps", [(2, 37, 3), (1, 16, 2)])
def test_mlstm_block_prefill_then_decode_matches_jax(b, s, steps):
    """States (C, n) within 1e-5 of the reference's after the prefill and
    every decode step.  The outputs divide by max(|q.n|, 1e-6), which
    random weights bring near 0 at some positions (max|y| ~ 90 here), so
    two fp32 evaluations that only sum in another order differ there by
    up to ~4e-4 of max|y|: the outputs are held to a float64 evaluation
    instead, each no further from it than the reference's own, plus 1e-5
    of max|y|."""
    cfg = xlstm.XLSTMConfig(**BLOCK_CFG)
    jcfg = jax_xlstm.XLSTMConfig(**BLOCK_CFG)
    jp = jax_xlstm.init_mlstm_block(jax.random.PRNGKey(0), jcfg)
    P = _np(jp)
    p = _load(xlstm.MLSTMBlock(cfg, torch.float32, torch.device("cpu")), P)
    x = _x(1, b, s + steps, cfg.d_model)
    oracle, _ = _mlstm_oracle(P, x, cfg)
    jst = jax_xlstm.init_mlstm_state(b, jcfg)
    st = tuple(t[0] for t in xlstm.init_mlstm_state(
        b, cfg, torch.device("cpu"), layers=1))
    jy, jst = jax_xlstm.apply_mlstm_block(jp, jnp.asarray(x[:, :s]), jcfg,
                                          initial_state=jst,
                                          return_state=True)
    with torch.inference_mode():
        y, st = xlstm.apply_mlstm_block(p, torch.from_numpy(x[:, :s]), cfg,
                                        initial_state=st, return_state=True)
    ys, jys = [y.numpy()], [np.asarray(jy)]
    _close(st[0], jst[0])
    _close(st[1], jst[1])
    for t in range(s, s + steps):
        jy, jst = jax_xlstm.mlstm_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                         jcfg, jst)
        with torch.inference_mode():
            y, st = xlstm.mlstm_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                       cfg, st)
        ys.append(y.numpy())
        jys.append(np.asarray(jy))
        _close(st[0], jst[0])
        _close(st[1], jst[1])
    got, want = np.concatenate(ys, 1), np.concatenate(jys, 1)
    scale = np.abs(oracle).max()
    err, ref_err = np.abs(got - oracle).max(), np.abs(want - oracle).max()
    assert err <= ref_err + 1e-5 * scale, (err, ref_err, scale)


@pytest.mark.parametrize("b,s,steps", [(2, 23, 3), (1, 5, 2)])
def test_slstm_block_prefill_then_decode_matches_jax(b, s, steps):
    cfg = xlstm.XLSTMConfig(**BLOCK_CFG)
    jcfg = jax_xlstm.XLSTMConfig(**BLOCK_CFG)
    jp = jax_xlstm.init_slstm_block(jax.random.PRNGKey(3), jcfg)
    p = _load(xlstm.SLSTMBlock(cfg, torch.float32, torch.device("cpu")),
              _np(jp))
    x = _x(2, b, s + steps, cfg.d_model)
    jy, jst = jax_xlstm.apply_slstm_block(jp, jnp.asarray(x[:, :s]), jcfg,
                                          return_state=True)
    with torch.inference_mode():
        y, st = xlstm.apply_slstm_block(p, torch.from_numpy(x[:, :s]), cfg,
                                        return_state=True)
    _close(y, jy)
    for got, want in zip(st, jst):
        _close(got, want)
    for t in range(s, s + steps):
        jy, jst = jax_xlstm.slstm_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                         jcfg, jst)
        with torch.inference_mode():
            y, st = xlstm.slstm_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                       cfg, st)
        _close(y, jy)
        for got, want in zip(st, jst):
            _close(got, want)


def test_block_inits_follow_the_reference_distributions():
    cfg = xlstm.XLSTMConfig(d_model=256, num_heads=4)
    jcfg = jax_xlstm.XLSTMConfig(d_model=256, num_heads=4)
    gen = torch.Generator().manual_seed(0)
    for ours, init in ((xlstm.MLSTMBlock, jax_xlstm.init_mlstm_block),
                       (xlstm.SLSTMBlock, jax_xlstm.init_slstm_block)):
        blk = ours(cfg, torch.bfloat16, torch.device("cpu"))
        blk.init(gen)
        theirs = _np(init(jax.random.PRNGKey(0), jcfg))
        for name, t in blk.state_dict().items():
            want = theirs
            for part in name.split("."):
                want = want[part]
            assert tuple(t.shape) == want.shape, name
            if name.rsplit(".", 1)[-1] in xlstm.FP32_LEAVES:
                assert t.dtype == torch.float32, name
            else:
                assert t.dtype == torch.bfloat16, name
            if name.startswith("b_gates") or name.endswith("scale"):
                np.testing.assert_array_equal(t.float().numpy(), want)
            else:
                assert abs(t.float().std().item() / want.std() - 1) < 0.1, \
                    name


@pytest.fixture(scope="module")
def models():
    jlm = JaxLM(jax_cfgs.SMOKE, default_features().with_(
        remat_policy="none"), dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * 0.1
    lm = LM(SMOKE, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, SMOKE))
    return jlm, jax.tree.map(jnp.asarray, jparams), lm, jparams


def test_bridge_stacks_pairs_and_keeps_the_gate_leaves_fp32(models):
    _, _, lm, jparams = models
    bridged = params_from_jax(jparams, SMOKE)
    assert set(bridged) == set(lm.state_dict())
    pairs = SMOKE.n_layers // 2
    assert len(lm.mlstm) == len(lm.slstm) == pairs == 2
    for i in range(pairs):
        np.testing.assert_array_equal(lm.mlstm[i].wq.numpy(),
                                      jparams["mlstm"]["wq"][i])
        np.testing.assert_array_equal(lm.slstm[i].r_gates.numpy(),
                                      jparams["slstm"]["r_gates"][i])
    bf = params_from_jax(jparams, SMOKE, dtype=torch.bfloat16)
    for name, t in bf.items():
        leaf = name.rsplit(".", 1)[-1]
        fp32 = name.startswith(("mlstm.", "slstm.")) and \
            leaf in xlstm.FP32_LEAVES
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), name
    np.testing.assert_array_equal(bf["slstm.1.b_gates"].numpy(),
                                  jparams["slstm"]["b_gates"][1])
    # a tree stacked over n_layers (not the pairs) is refused
    bad = dict(jparams, mlstm=jax.tree.map(
        lambda v: np.concatenate([v, v]), jparams["mlstm"]))
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_jax(bad, SMOKE)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def test_smoke_prefill_and_decode_logits_match_jax(models):
    jlm, jp, lm, _ = models
    rng = np.random.default_rng(19)
    b, s, steps, max_seq = 2, 37, 3, 48          # 37 > 2 chunks of 16
    toks = rng.integers(0, SMOKE.vocab, (b, s)).astype(np.int32)
    jlogits, jstate = jax.jit(jlm.prefill)(
        jp, {"tokens": jnp.asarray(toks)}, jlm.init_decode_state(b, max_seq))
    state = lm.init_decode_state(b, max_seq)
    assert state["mlstm"][0].shape == (2, b, 4, 32, 32)
    assert state["slstm"][2].shape == (2, b, 64)
    with torch.inference_mode():
        logits, state = lm.prefill({"tokens": torch.from_numpy(toks)}, state)
    assert _rel(logits, jlogits) <= 1e-4
    jdecode = jax.jit(jlm.decode_step)
    for _ in range(steps):
        nxt = rng.integers(0, SMOKE.vocab, (b, 1)).astype(np.int32)
        jlogits, jstate = jdecode(jp, jnp.asarray(nxt), jstate)
        with torch.inference_mode():
            logits, state = lm.decode_step(torch.from_numpy(nxt), state)
        assert _rel(logits, jlogits) <= 1e-4
    for got, want in ((state["mlstm"][0], jstate["mlstm"][0]),
                      (state["slstm"][0], jstate["slstm"][0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_generate_matches_jax_engine(models):
    jlm, jp, lm, _ = models
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, SMOKE.vocab, 20).tolist() for _ in range(3)]
    want = jax_engine.Engine(jlm, jp, jax_engine.ServeConfig(
        max_seq=64)).generate(prompts, 8)
    eng = engine.Engine(lm, engine.ServeConfig(max_seq=64), device="cpu")
    got = eng.generate(prompts, 8)
    assert got == want
    assert eng.host_syncs == 1
    assert len({tuple(t) for t in got}) > 1


def _run(mod, eng, work):
    sched = mod.BatchScheduler(eng)
    for rid, (prompt, budget) in enumerate(work):
        sched.submit(mod.Request(rid=rid, prompt=list(prompt),
                                 max_new_tokens=budget))
    done = sched.run()
    return sched, {rid: list(r.generated) for rid, r in done.items()}


def test_scheduler_matches_jax_scheduler_and_single_prompt_generate(models):
    """Every admission prefills its row at its exact length and merges
    the row's mLSTM (C, n) and sLSTM (c, n, h) into its slot."""
    jlm, jp, lm, _ = models
    rng = np.random.default_rng(6)
    work = [(rng.integers(1, SMOKE.vocab, n).tolist(), budget)
            for n, budget in zip((19, 5, 23, 3, 17, 30, 8),
                                 (5, 3, 7, 2, 6, 4, 5))]
    sc = dict(max_seq=64, batch_slots=3, admission_chunk=4)
    jsched, want = _run(jax_engine, jax_engine.Engine(
        jlm, jp, jax_engine.ServeConfig(**sc)), work)
    eng = engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")
    sched, got = _run(engine, eng, work)
    assert got == want
    for k in ("admissions", "segments", "decode_steps", "prompt_tokens"):
        assert sched.metrics[k] == jsched.metrics[k], k
    assert eng.host_syncs == sched.metrics["segments"] > 1
    sched.check()
    single = engine.Engine(lm, engine.ServeConfig(max_seq=64), device="cpu")
    for rid, (prompt, budget) in enumerate(work):
        assert single.generate([prompt], budget)[0] == got[rid]


def test_pages_spec_and_ragged_prefill_are_refused(models):
    jlm, jp, lm, _ = models
    for sc in (dict(page_size=4), dict(page_size=4, kv_dtype="int8")):
        with pytest.raises(ValueError, match="attention-cache family"):
            engine.Engine(lm, engine.ServeConfig(max_seq=64, **sc),
                          device="cpu")
        with pytest.raises(ValueError, match="attention-cache family"):
            jax_engine.Engine(jlm, jp, jax_engine.ServeConfig(max_seq=64,
                                                              **sc))
    with pytest.raises(ValueError, match="attention-cache family"):
        lm.init_decode_state(2, 16, page_size=4)
    with pytest.raises(ValueError, match="decoder family"):
        engine.Engine(lm, engine.ServeConfig(max_seq=64), device="cpu",
                      spec=SpecConfig(draft_config=SMOKE,
                                      num_draft_tokens=2))
    toks = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="lengths"):
        lm.prefill({"tokens": toks, "lengths": torch.tensor([5, 3])},
                   lm.init_decode_state(2, 16))


def test_declared_step_counts_the_recurrent_state(models):
    """``LM._declare_ops`` counts every matmul leaf of the pairs and the
    recurrent state read and written, with no KV."""
    from repro_torch.core import events
    _, _, lm, _ = models
    state = lm.init_decode_state(2, 16)
    with events.collect() as ev:
        with torch.inference_mode():
            lm.decode_step(torch.zeros((2, 1), dtype=torch.int32), state)
    elems = sum(p.numel() for n, p in lm.named_parameters()
                if n.rsplit(".", 1)[-1] in (
                    "w_up", "wq", "wk", "wv", "w_down", "w_gates", "r_gates",
                    "w_ff_gate", "w_ff_up", "w_ff_down"))
    rec = sum(t.numel() * 4 for t in (*state["mlstm"], *state["slstm"]))
    assert ev["FLOPS_TOTAL"] == pytest.approx(
        2.0 * (2 * elems + 2 * SMOKE.d_model * SMOKE.vocab))
    assert ev["HBM_OUT_BYTES"] == pytest.approx(2 * SMOKE.vocab * 4 + rec)
    assert ev["LAUNCHES"] == 0


def test_serve_launcher_runs_xlstm_with_dense_state(tmp_path):
    path = tmp_path / "xlstm.json"
    assert serve_launcher.main([
        "--arch", "xlstm-350m", "--smoke-dims", "--device", "cpu",
        "--requests", "4", "--slots", "2", "--prompt-len", "18",
        "--max-new", "5", "--json", str(path)]) == 0
    import json
    d = json.loads(path.read_text())
    assert d["device"] == "cpu" and d["new_tokens"] == 4 * 5
    assert d["host_syncs"] == d["segments"] > 0
    with pytest.raises(ValueError, match="attention-cache family"):
        serve_launcher.main(["--arch", "xlstm-350m", "--smoke-dims",
                             "--device", "cpu", "--page-size", "8"])
