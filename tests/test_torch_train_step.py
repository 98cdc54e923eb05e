"""The port's training path against the JAX package's, on the CPU, fp32.

qwen2-0.5b (dense), qwen2-moe-a2.7b (moe) and qwen2-vl-7b (vlm) at their
``SMOKE`` configs, JAX ``LM.init`` parameters bridged over
(``params_from_jax``), batches from the shared synthetic source:

* ``forward`` logits within 1e-5 of max|logit| and ``loss`` within 1e-5
  relative (the moe family's aux loss included; vlm's patch positions
  masked out of the labels);
* every parameter's gradient against ``jax.grad``: within 1e-4 relative
  plus 1e-6 of the largest gradient anywhere in the model;
* three ``make_train_step`` steps against the JAX step, with
  ``accum_steps`` 1 and 4 and with int8 error feedback: loss, grad norm
  and rate within 1e-5 relative each step, and the parameters after them
  (:func:`_check_params`: all but 0.1% or one element of each leaf
  within 1e-5, all within Adam's bound, and why);
* the attention training path (``naive``, ``fused``, ``kernel`` and the
  chunked path) against the JAX package's, outputs and gradients, and
  against the naive mode (the port of ``tests/test_models.py:266-300``);
* gradients equal under every ``remat_policy`` (1e-6 relative);
* bf16 compute over fp32 masters: fp32 gradients, the tied embedding's
  two uses summed in fp32, the loss within 2e-2 of the JAX bf16 model's;
* the registry: under grad no impl without a gradient is selected or
  runs (a pin to ``cuda_flash`` or ``cuda_ssd`` raises); the training
  kernels (``cuda_flash_train``) are selected on the card in bf16 at a
  head dim they build, and a training step with the backend taken for
  the card launches no kernel in fp32 and calls the training kernels'
  wrappers once a layer in bf16.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.core.features import default_features as jax_features
from repro.models import attention as jax_attn
from repro.models.lm import LM as JaxLM
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import ScheduleConfig as JaxSched
from repro.train.step import init_train_state as jax_init_state
from repro.train.step import make_train_step as jax_make_step
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import get_arch
from repro_torch.core.features import default_features
from repro_torch.data import DataConfig, make_source
from repro_torch.kernels import flash_attention, registry, ssd_scan
from repro_torch.kernels import flash_attention_train as flash_train
from repro_torch.models import attention as attn
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)

SCHED = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)


def _data_cfg(cfg, batch=4, seq=24):
    return dict(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                src_embeds_dim=cfg.d_model if cfg.family == "encdec" else 0,
                src_ratio=cfg.src_ratio,
                patch_embeds=cfg.n_patches if cfg.family == "vlm" else 0,
                d_model=cfg.d_model)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jlm = JaxLM(jax_get_arch(arch).smoke,
                jax_features().with_(remat_policy="none"), dtype=jnp.float32)
    return jlm, jlm.init(jax.random.PRNGKey(0))


def _pair(arch, remat="none", dtype=torch.float32):
    jlm, params = _jax_params(arch)
    cfg = get_arch(arch).smoke
    lm = LM(cfg, dtype, "cpu",
            features=default_features().with_(remat_policy=remat),
            param_dtype=torch.float32)
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    return jlm, params, lm


def _batch(cfg, step=0, **kw):
    b = make_source(DataConfig(**_data_cfg(cfg, **kw))).batch_at(step)
    return ({k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


def _walk(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _grads(lm, batch):
    lm.requires_grad_(True)
    names, ps = zip(*lm.named_parameters())
    loss, aux = lm.loss(batch)
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss, aux, dict(zip(names, gs))


def check_grads(port, ref, cfg, rtol=1e-4, atol=1e-6):
    """Every leaf within ``rtol`` relative plus ``atol`` of the largest
    gradient anywhere (a leaf whose true gradient is zero, such as the
    key bias, holds rounding noise only)."""
    assert all(g is not None for g in port.values()), \
        [k for k, g in port.items() if g is None]
    got = params_to_jax(port, cfg)
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    gmax = max(float(jnp.abs(leaf).max()) for _, leaf in flat)
    for path, leaf in flat:
        np.testing.assert_allclose(_walk(got, path), np.asarray(leaf),
                                   rtol=rtol, atol=atol * gmax,
                                   err_msg=jax.tree_util.keystr(path))


def _check_params(port, ref, cfg, lrs, exact=True, frac=0.999):
    """Parameters after the steps.  Every element within the bound of
    Adam's update, 2 x the summed rate, and all but ``1 - frac`` (0.1%;
    1% with int8 error feedback, ``exact=False``) or one of each leaf's
    elements within 1e-5 relative plus 1e-5 of the leaf's largest.
    The rest is where Adam's normalisation turns rounding noise into a
    step of size ~lr: elements whose first moment nearly cancels, the key
    bias (``bk``: softmax is invariant to it, so its true gradient is
    zero and it is held to the bound alone) and, with int8, codes that
    flip across a rounding boundary."""
    got = params_to_jax(port, cfg)
    bound = 2.0 * sum(lrs) + 1e-6
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        name = jax.tree_util.keystr(path)
        want = np.asarray(leaf)
        d = np.abs(_walk(got, path) - want)
        assert d.max() <= bound, (name, d.max(), bound)
        if "['bk']" in name:
            continue
        loose = int((d > 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max())
                    .sum())
        share = frac if exact else min(frac, 0.99)
        assert loose <= max(1, int((1.0 - share) * d.size)), \
            (name, loose, d.size, d.max())


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

FAMILIES = ["qwen2-0.5b", "qwen2-moe-a2.7b", "qwen2-vl-7b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_loss_match_jax(arch):
    jlm, params, lm = _pair(arch)
    tb, jb = _batch(lm.cfg)
    with torch.no_grad():
        logits = lm.forward(tb)
        loss, aux = lm.loss(tb)
    want = np.asarray(jax.jit(jlm.forward)(params, jb))
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    jl, jaux = jax.jit(jlm.loss)(params, jb)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(aux["aux"].item(), float(jaux["aux"]),
                               rtol=1e-5, atol=1e-9)
    assert aux["ntok"].item() == float(jaux["ntok"])
    if lm.cfg.family == "moe":
        assert aux["aux"].item() > 0.0
    if lm.cfg.family == "vlm":             # patch labels carry no target
        n = lm.cfg.n_patches
        assert (tb["labels"][:, :n] < 0).all()
        assert aux["ntok"].item() == tb["labels"].shape[0] * (
            tb["labels"].shape[1] - n - 1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_gradient_matches_jax(arch):
    jlm, params, lm = _pair(arch)
    tb, jb = _batch(lm.cfg)
    loss, _, grads = _grads(lm, tb)
    (jl, _), jg = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        params, jb)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    check_grads(grads, jg, lm.cfg)


def run_steps(arch, accum=1, compress=False, steps=3, batch=4, rtol=1e-5):
    """Three steps of both packages from the same weights and batches,
    loss, grad norm and rate within ``rtol`` each step; returns (the
    port's LM, its state, the JAX state, the rates used)."""
    kw = dict(grad_compression="int8_ef") if compress else {}
    jlm, params, lm = _pair(arch)
    jstate = jax_init_state(jlm, jax.random.PRNGKey(0), JaxAdamW(**kw))
    jstate = jstate._replace(params=params)
    jstep = jax.jit(jax_make_step(jlm, JaxAdamW(**kw), JaxSched(**SCHED),
                                  accum_steps=accum))
    state = init_train_state(lm, AdamWConfig(**kw))
    step = make_train_step(lm, AdamWConfig(**kw), ScheduleConfig(**SCHED),
                           accum_steps=accum)
    lrs = []
    for i in range(steps):
        tb, jb = _batch(lm.cfg, step=i, batch=batch)
        state, m = step(state, tb)
        jstate, jm = jstep(jstate, jb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
        assert int(m["step"]) == int(jm["step"]) == i
        lrs.append(m["lr"].item())
    assert int(state.step) == int(state.opt.step) == steps
    return lm, state, jstate, lrs


@pytest.mark.parametrize("arch,accum,compress", [
    ("qwen2-0.5b", 1, False), ("qwen2-0.5b", 4, False),
    ("qwen2-0.5b", 1, True), ("qwen2-moe-a2.7b", 1, False),
    ("qwen2-moe-a2.7b", 4, False), ("qwen2-vl-7b", 1, False),
    ("qwen2-vl-7b", 4, False)])
def test_three_train_steps_match_jax(arch, accum, compress):
    lm, state, jstate, lrs = run_steps(arch, accum, compress)
    _check_params(state.params, jstate.params, lm.cfg, lrs,
                  exact=not compress)
    if compress:
        assert state.opt.ef is not None
        assert set(state.opt.ef) == set(state.params)


# ---------------------------------------------------------------------------
# attention's training path (tests/test_models.py:266-300)
# ---------------------------------------------------------------------------

def _attn_pair(chunk_threshold=10**9, chunk=32):
    cfg = jax_attn.AttnConfig(d_model=32, num_heads=4, num_kv_heads=2,
                              head_dim=16, qkv_bias=True, chunk_size=chunk,
                              chunk_threshold=chunk_threshold)
    jp = jax_attn.init_attn(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(7)
    jp = dict(jp, bq=jnp.asarray(rng.standard_normal((4, 16)), jnp.float32),
              bk=jnp.asarray(rng.standard_normal((2, 16)), jnp.float32))
    tcfg = attn.AttnConfig(**cfg._asdict())
    p = attn.Attention(tcfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for k, v in jp.items():
            getattr(p, k).copy_(torch.from_numpy(np.array(v)))
    p.requires_grad_(True)
    return cfg, jp, tcfg, p


def _attn_loss_grads(p, x, cfg):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = attn.attention(p, xt, cfg)
    names, ps = zip(*p.named_parameters())
    gs = torch.autograd.grad((out ** 2).sum(), (xt, *ps))
    return out.detach().numpy(), gs[0].numpy(), dict(
        zip(names, (g.numpy() for g in gs[1:])))


@pytest.mark.parametrize("mode,chunked", [
    ("naive", False), ("fused", False), ("kernel", False),
    ("naive", True), ("kernel", True)])
def test_attention_train_modes_match_jax(mode, chunked):
    cfg, jp, tcfg, p = _attn_pair(chunk_threshold=48 if chunked else 10**9)
    cfg, tcfg = (c._replace(softmax_mode=mode) for c in (cfg, tcfg))
    x = np.random.default_rng(8).standard_normal((2, 96, 32)).astype(
        np.float32)
    out, gx, gp = _attn_loss_grads(p, x, tcfg)

    def loss(params, xx):
        return (jax_attn.attention(params, xx, cfg) ** 2).sum()

    want = np.asarray(jax_attn.attention(jp, jnp.asarray(x), cfg))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    np.testing.assert_allclose(gx, np.asarray(jgx), rtol=1e-4, atol=1e-4)
    for k, g in gp.items():
        np.testing.assert_allclose(g, np.asarray(jgp[k]), rtol=1e-4,
                                   atol=1e-4 * np.abs(jgp[k]).max(),
                                   err_msg=k)
    # and against the port's own naive mode (the reference's check)
    n_out, n_gx, _ = _attn_loss_grads(p, x, tcfg._replace(
        softmax_mode="naive", chunk_threshold=10**9))
    np.testing.assert_allclose(out, n_out, rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(gx, n_gx, rtol=2e-3, atol=2e-4)


def test_flash_function_recomputes_tiles_and_masks():
    # ragged kv_len (a fully masked row included) and a q offset: the
    # autograd Function's forward and backward against plain autograd
    # through the materialized softmax
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((3, 20, 4, 8)).astype(
        np.float32)).requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((3, 300, 2, 8)).astype(
        np.float32)).requires_grad_(True)
    v = torch.from_numpy(rng.standard_normal((3, 300, 2, 8)).astype(
        np.float32)).requires_grad_(True)
    kv_len = torch.tensor([300, 117, 0], dtype=torch.int32)
    got = attn.flash_attention_train(q, k, v, q_offset=200, causal=True,
                                     k_chunk=128, kv_len=kv_len)
    want = attn.full_attention(q, k, v, q_offset=200, causal=True,
                               kv_len=kv_len)
    want = torch.where(kv_len[:, None, None, None] > 0, want, 0.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dout = torch.from_numpy(rng.standard_normal(got.shape).astype(
        np.float32))
    g1 = torch.autograd.grad(got, (q, k, v), dout)
    g2 = torch.autograd.grad(want, (q, k, v), dout)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# remat, mixed precision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b"])
def test_gradients_equal_under_every_remat_policy(arch):
    tb = None
    base = None
    for policy in ("none", "full", "dots", "dots_no_batch"):
        _, _, lm = _pair(arch, remat=policy)
        if tb is None:
            tb, _ = _batch(lm.cfg)
        loss, _, grads = _grads(lm, tb)
        if base is None:
            base = (loss, grads)
            continue
        torch.testing.assert_close(loss, base[0], rtol=1e-6, atol=0)
        for k, g in grads.items():
            torch.testing.assert_close(g, base[1][k], rtol=1e-6, atol=1e-7,
                                       msg=f"{policy} {k}")


def test_bf16_compute_over_fp32_masters():
    jlm_f32, params, lm = _pair("qwen2-0.5b", dtype=torch.bfloat16)
    assert lm.param_dtype == torch.float32 and lm.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in lm.parameters())
    tb, jb = _batch(lm.cfg)
    loss, _, grads = _grads(lm, tb)
    assert all(g.dtype == torch.float32 for g in grads.values())
    jlm = JaxLM(jlm_f32.cfg, jlm_f32.features, dtype=jnp.bfloat16)
    (jl, _), jg = jax.value_and_grad(jlm.loss, has_aux=True)(params, jb)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=2e-2)
    # the tied table's gradient is the gather's plus the head's, in fp32
    g = grads["embed.table"]
    want = np.asarray(jg["embed"]["table"])
    np.testing.assert_allclose(g.numpy(), want, rtol=0.1,
                               atol=0.05 * np.abs(want).max())
    # a serving model (weights stored in the compute dtype) casts nothing
    served = LM(lm.cfg, torch.bfloat16, "cpu")
    w = served.embed.table
    from repro_torch.models.layers import cast
    assert cast(w, torch.bfloat16) is w


# ---------------------------------------------------------------------------
# the registry under grad
# ---------------------------------------------------------------------------

def _qkv(grad):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 8, 4, 16)).astype(
        np.float32)).requires_grad_(grad)
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32)).requires_grad_(grad)
    return q, k, k.detach().clone().requires_grad_(grad)


def _ssd(grad):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 4)).astype(
        np.float32)).requires_grad_(grad) for _ in range(3))
    lf = -torch.rand(1, 8, 2)
    return q, k, v, lf, torch.zeros_like(lf)


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_select_differentiable_never_returns_a_kernel(backend):
    # under grad no kernel without a gradient is selected: the training
    # kernels (cuda_flash_train, an autograd Function) only on the card in
    # bf16 at a head dim they build; fp32, the CPU and other head dims keep
    # the differentiable twins
    assert registry.select("attention", sq=8, sk=8, dh=16, backend=backend,
                           differentiable=True) == "torch_flash"
    assert registry.select("ssd_scan", backend=backend,
                           differentiable=True) == "torch_scan"
    train = dict(sq=8, sk=8, dh=64, heads=4, kv_heads=2, backend=backend,
                 differentiable=True)
    assert registry.select("attention", dtype=torch.bfloat16, **train) == (
        "cuda_flash_train" if backend == "cuda" else "torch_flash")
    assert registry.select("attention", dtype=torch.float32,
                           **train) == "torch_flash"
    assert registry.select("attention", sq=8, sk=8, dh=16,
                           backend="cuda") == "cuda_flash"
    for fam, impl in (("attention", "cuda_flash"), ("ssd_scan", "cuda_ssd")):
        with registry.use_impl(**{fam: impl}):
            with pytest.raises(RuntimeError, match="no gradient"):
                registry.select(fam, sq=8, sk=8, dh=16, backend=backend,
                                differentiable=True)
            with pytest.raises(RuntimeError, match="no gradient"):
                registry.select(fam, dtype=torch.bfloat16, **train)
            assert registry.select(fam, sq=8, sk=8, dh=16,
                                   backend=backend) == impl


def test_kernel_pins_raise_under_grad(monkeypatch):
    q, k, v = _qkv(grad=True)
    with registry.use_impl(attention="cuda_flash"):
        with pytest.raises(RuntimeError, match="no gradient"):
            registry.run("attention", q, k, v, causal=True)
    monkeypatch.setenv("REPRO_IMPL", "ssd_scan=cuda_ssd")
    with pytest.raises(RuntimeError, match="no gradient"):
        registry.run("ssd_scan", *_ssd(grad=True), chunk=4)
    with pytest.raises(RuntimeError, match="no gradient"):
        registry.run("attention", q, k, v, impl="cuda_flash")
    # without grad the pins run (their plain twin, as a launch, on the CPU)
    with torch.no_grad():
        registry.run("ssd_scan", *_ssd(grad=False), chunk=4)
        monkeypatch.delenv("REPRO_IMPL")
        with registry.use_impl(attention="cuda_flash"):
            registry.run("attention", q, k, v, causal=True)
    # unpinned under grad: the autograd twins, and the gradient flows
    out = registry.run("attention", q, k, v, causal=True,
                       chunk_threshold=4)
    assert out.grad_fn is not None
    y, _ = registry.run("ssd_scan", *_ssd(grad=True), chunk=4)
    assert y.grad_fn is not None


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b",
                                  "xlstm-350m"])
def test_a_train_step_on_the_card_backend_launches_no_kernel(arch,
                                                             monkeypatch):
    # every heuristic answers as on the card.  In fp32 a training step
    # takes the differentiable twins, so no kernel wrapper counts a launch
    # and the training kernels' wrappers are not called; in bf16 at a head
    # dim they build, every attention of the step goes to them (one
    # forward and one backward call a layer without remat), and kernels
    # #1 and #5 still launch nothing
    monkeypatch.setattr(registry, "_backend", lambda backend=None: "cuda")
    calls = {"attention": 0, "fwd": 0, "bwd": 0}
    for name, mod, key in (("_train_attention", attn, "attention"),
                           ("flash_train_forward", flash_train, "fwd"),
                           ("flash_train_backward", flash_train, "bwd")):
        def counted(*a, _real=getattr(mod, name), _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = get_arch(arch).smoke
        if dtype == torch.bfloat16:
            cfg = dataclasses.replace(cfg, head_dim=64)
        lm = LM(cfg, dtype, "cpu",
                features=default_features().with_(remat_policy="none"),
                param_dtype=torch.float32)
        lm.init(torch.Generator().manual_seed(0))
        state = init_train_state(lm, AdamWConfig())
        step = make_train_step(lm, AdamWConfig(), ScheduleConfig(**SCHED))
        tb, _ = _batch(cfg)
        before = (flash_attention.flash_attention_bhsd.launches,
                  ssd_scan.ssd_scan.launches, dict(flash_train.LAUNCHES))
        calls.update(attention=0, fwd=0, bwd=0)
        state, m = step(state, tb)
        assert np.isfinite(m["loss"].item())
        assert (flash_attention.flash_attention_bhsd.launches,
                ssd_scan.ssd_scan.launches,
                dict(flash_train.LAUNCHES)) == before
        n = calls["attention"]
        assert n == (0 if arch == "xlstm-350m" else 2), (arch, calls)
        want = n if dtype == torch.bfloat16 else 0
        assert (calls["fwd"], calls["bwd"]) == (want, want), (dtype, calls)