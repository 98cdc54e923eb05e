"""The training attention's kernels (``kernels/flash_attention_train.py``)
on the CPU, where their wrappers run the plain twin:

* the twin's ``(out, lse)`` and its dq, dk, dv equal autograd through the
  reference's train path (``_full_attention_offset``, ``naive``) in fp32,
  causal and not, G = 1, 2 and 7, S off every tile, Dh 64, 80 and 128;
  ``flash_train`` (the autograd ``Function``) gives the same gradients;
* the wrappers refuse a wrong shape, dtype, layout or device, and the
  card's conditions (bf16, a built head dim, a contiguous head dim, rows
  on 16 bytes);
* the registry: ``cuda_flash_train`` where the facts meet those conditions
  on the card, ``torch_flash`` elsewhere; a pin still overrides, and the
  impl refuses a query offset and ragged lengths;
* a pin in a bf16 step on the card backend: ``cuda_flash_train`` takes
  the kernels, any other (a serving pin to ``cuda_flash`` from
  ``use_impl``, ``REPRO_IMPL`` or ``REPRO_ATTN_IMPL``; ``torch_flash``;
  ``full``) keeps the reference's route and raises nothing;
* a ``use_impl`` pin reaches the checkpoint's recompute when the backward
  runs on another thread, as autograd runs a card's: the recompute takes
  the forward's route;
* a bf16 step on the card backend (every heuristic answering as on the
  card) takes the route: 2L forward and L backward calls under
  ``dots_no_batch`` (the recompute runs the forward again), L and L with
  no remat, the same calls with a profiler opened between the steps and
  between a forward and its backward; the step's loss and gradients
  against the reference's route on the same weights within bf16's
  rounding.
"""

import concurrent.futures
import contextlib
import dataclasses
import math

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.core.features import default_features
from repro_torch.kernels import flash_attention_train as ft
from repro_torch.kernels import registry
from repro_torch.models import attention as attn
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


def _qkv(b, s, h, kvh, dh, seed=0, dtype=torch.float32, grad=False):
    rng = np.random.default_rng(seed)

    def t(n):
        x = torch.from_numpy(rng.standard_normal((b, s, n, dh)).astype(
            np.float32)).to(dtype)
        return x.requires_grad_(grad)

    return t(h), t(kvh), t(kvh)


# ---------------------------------------------------------------------------
# the plain twin against the reference's train path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh", [64, 80, 128])
@pytest.mark.parametrize("g", [1, 2, 7])
@pytest.mark.parametrize("causal", [True, False])
def test_the_twin_equals_autograd_through_the_naive_path(causal, g, dh):
    kvh = 2 if g < 7 else 1
    s = 37 if dh != 80 else 70           # off every tile of the kernels
    q, k, v = _qkv(2, s, g * kvh, kvh, dh, seed=g + dh, grad=True)
    want = attn._full_attention_offset(q, k, v, 0, causal, None, "naive")
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(
        want.shape).astype(np.float32))
    gq, gk, gv = torch.autograd.grad(want, (q, k, v), do)
    # the naive path's scores, for the logsumexp
    sc = torch.einsum("bqhd,bkhd->bhqk", q.detach(),
                      k.detach().repeat_interleave(g, dim=2)) / math.sqrt(dh)
    if causal:
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                            -math.inf)
    tol = dict(rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        out, lse = ft.flash_train_plain_forward(q, k, v, causal=causal)
        torch.testing.assert_close(out, want.detach(), **tol)
        torch.testing.assert_close(lse, torch.logsumexp(sc, dim=-1), **tol)
        dq, dk, dv = ft.flash_train_plain_backward(q, k, v, out, lse, do,
                                                   causal=causal)
    for got, ref in ((dq, gq), (dk, gk), (dv, gv)):
        assert got.shape == ref.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, ref, **tol)
    # the autograd Function over the wrappers: the same values
    fq, fk, fv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    fo = ft.flash_train(fq, fk, fv, causal=causal)
    torch.testing.assert_close(fo, want.detach(), **tol)
    for got, ref in zip(torch.autograd.grad(fo, (fq, fk, fv), do),
                        (gq, gk, gv)):
        torch.testing.assert_close(got, ref, **tol)


# ---------------------------------------------------------------------------
# what the wrappers refuse
# ---------------------------------------------------------------------------

def test_the_wrappers_refuse_a_wrong_shape_dtype_or_device():
    q, k, v = _qkv(1, 8, 4, 2, 64)
    with pytest.raises(ValueError, match="q \\[B,S,H,Dh\\]"):
        ft.flash_train_forward(q[0], k, v)
    with pytest.raises(ValueError, match="do not match"):
        ft.flash_train_forward(q, k[:, :4], v)
    with pytest.raises(ValueError, match="multiple of KVH"):
        ft.flash_train_forward(q[:, :, :3], k, v)
    with pytest.raises(TypeError, match="one dtype"):
        ft.flash_train_forward(q, k.double(), v)
    with pytest.raises(ValueError, match="several devices"):
        ft.flash_train_forward(q, k.to("meta"), v)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ft.flash_train_forward(*(t.to("meta") for t in (q, k, v)))
    out, lse = ft.flash_train_forward(q, k, v)
    with pytest.raises(ValueError, match="lse must be fp32"):
        ft.flash_train_backward(q, k, v, out, lse[:, :1], out)
    with pytest.raises(ValueError, match="must be q's shape"):
        ft.flash_train_backward(q, k, v, out, lse, out[:, :4])


def test_the_card_conditions_refuse_a_dtype_head_dim_or_layout():
    q, k, v = _qkv(1, 8, 4, 2, 64, dtype=torch.bfloat16)
    ft._check_card(q, k, v)                       # what the kernels take
    with pytest.raises(TypeError, match="take bf16"):
        ft._check_card(q.float(), k.float(), v.float())
    with pytest.raises(TypeError, match="take bf16"):    # an fp32 dO
        ft._check_card(q, k, v, q, q.float())
    with pytest.raises(ValueError, match="build head dims"):
        ft._check_card(*_qkv(1, 8, 4, 2, 48, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous head dim"):
        ft._check_card(q.transpose(2, 3).contiguous().transpose(2, 3), k,
                       v)
    wide = torch.zeros(1, 8, 5, 64, dtype=torch.bfloat16)
    ft._check_card(wide[:, :, 1:], k, v)          # a strided view of heads
    odd = torch.zeros(1, 8, 4 * 64 + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):    # seq stride 260
        ft._check_card(odd[..., :256].unflatten(2, (4, 64)), k, v)
    with pytest.raises(ValueError, match="16-byte"):    # starts on 8
        ft._check_card(wide.flatten()[4:4 + q.numel()].view_as(q), k, v)


def test_takes_names_the_kernels_conditions():
    ok = dict(dtype=torch.bfloat16, dh=64, heads=14, kv_heads=2)
    assert ft.takes(**ok)
    assert ft.takes(**dict(ok, dtype="bfloat16"))
    for dh in ft.SUPPORTED_HEAD_DIMS:
        assert ft.takes(**dict(ok, dh=dh))
    assert not ft.takes(**dict(ok, dtype=torch.float32))
    assert not ft.takes(**dict(ok, dtype=None))
    assert not ft.takes(**dict(ok, dh=16))
    assert not ft.takes(**ok, q_offset=3)
    assert not ft.takes(**ok, ragged=True)
    assert not ft.takes(**dict(ok, heads=13))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

TRAIN = dict(sq=64, sk=64, dh=64, heads=14, kv_heads=2, differentiable=True)


def test_select_takes_the_training_kernels_on_the_card_in_bf16():
    bf16 = dict(TRAIN, dtype=torch.bfloat16)
    assert registry.select("attention", backend="cuda", **bf16) \
        == "cuda_flash_train"
    assert registry.select("attention", **bf16) == "cuda_flash_train"
    # the CPU, fp32, another head dim, an offset, ragged rows: the twin
    for facts in (dict(bf16, backend="cpu"),
                  dict(bf16, backend="cuda", dtype=torch.float32),
                  dict(bf16, backend="cuda", dh=16),
                  dict(bf16, backend="cuda", q_offset=8),
                  dict(bf16, backend="cuda", ragged=True)):
        assert registry.select("attention", **facts) == "torch_flash", facts
    # without grad the serving choice is unchanged
    assert registry.select("attention", **dict(bf16, differentiable=False,
                                               backend="cuda")) \
        == "cuda_flash"
    # a pin overrides either way; kernel #1 still refuses grad
    with registry.use_impl(attention="torch_flash"):
        assert registry.select("attention", backend="cuda", **bf16) \
            == "torch_flash"
    with registry.use_impl(attention="cuda_flash_train"):
        assert registry.select("attention", backend="cpu",
                               **dict(bf16, dtype=torch.float32)) \
            == "cuda_flash_train"
    with registry.use_impl(attention="cuda_flash"):
        with pytest.raises(RuntimeError, match="no gradient"):
            registry.select("attention", backend="cuda", **bf16)


def test_run_self_selects_the_training_kernels_from_the_tensors(
        monkeypatch):
    monkeypatch.setattr(registry, "_backend", lambda backend=None: "cuda")
    q, k, v = _qkv(1, 16, 4, 2, 64, dtype=torch.bfloat16, grad=True)
    seen = []
    real = ft.flash_train
    monkeypatch.setattr(ft, "flash_train",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    out = registry.run("attention", q, k, v, causal=True)
    assert seen == [1] and out.grad_fn is not None
    # no grad, an offset or ragged rows: not the training kernels
    with torch.no_grad():
        registry.run("attention", q, k, v, impl="cuda_flash_train")
    assert seen == [1, 1]
    registry.run("attention", q.float(), k.float(), v.float(), causal=True)
    assert seen == [1, 1]
    for kw in (dict(q_offset=2), dict(kv_len=torch.full((1,), 16,
                                                        dtype=torch.int32))):
        with pytest.raises(ValueError, match="no q_offset, no kv_len"):
            registry.run("attention", q, k, v, impl="cuda_flash_train",
                         **kw)


def test_the_port_only_impl_is_declared():
    assert registry.PORT_ONLY == {"attention": ("cuda_flash_train",)}
    spec = registry.get_spec("attention", "cuda_flash_train")
    assert spec.tune is None and spec.supports(differentiable=True)
    assert not spec.supports(per_device_heads=0)
    assert "cuda_flash_train" not in registry.REFERENCE_NAMES["attention"]


# ---------------------------------------------------------------------------
# a bf16 training step on the card backend
# ---------------------------------------------------------------------------

#: qwen2-0.5b's SMOKE (7 q heads over 1 kv head, G 7) at head dim 64
CFG = dataclasses.replace(get_arch("qwen2-0.5b").smoke, head_dim=64)


def _step(remat, seed=0):
    lm = LM(CFG, torch.bfloat16, "cpu",
            features=default_features().with_(remat_policy=remat),
            param_dtype=torch.float32)
    lm.init(torch.Generator().manual_seed(seed))
    adamw = AdamWConfig()
    state = init_train_state(lm, adamw)
    step = make_train_step(lm, adamw, ScheduleConfig(
        peak_lr=1e-2, warmup_steps=1, total_steps=10))
    return lm, state, step


def _batch(seed=1, rows=2, seq=24):
    toks = torch.randint(0, CFG.vocab, (rows, seq + 1),
                         generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture
def card(monkeypatch):
    """Every heuristic answers as on the card; ``calls`` counts the
    wrappers' forward and backward calls (each a launch of the forward,
    or of the dQ and dK/dV kernels, on the card)."""
    monkeypatch.setattr(registry, "_backend", lambda backend=None: "cuda")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ft.flash_train_forward, ft.flash_train_backward

    def counted_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def counted_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(ft, "flash_train_forward", counted_fwd)
    monkeypatch.setattr(ft, "flash_train_backward", counted_bwd)
    return calls


@pytest.mark.parametrize("remat,fwd_per_layer",
                         [("dots_no_batch", 2), ("full", 2), ("none", 1)])
def test_a_bf16_step_on_the_card_backend_takes_the_kernels(card, remat,
                                                           fwd_per_layer):
    n = CFG.n_layers
    _, state, step = _step(remat)
    state, m = step(state, _batch())
    assert np.isfinite(m["loss"].item())
    assert card == {"fwd": fwd_per_layer * n, "bwd": n}
    # a profiler opened between the steps: the same calls, a finite step
    card.update(fwd=0, bwd=0)
    with torch.profiler.profile(activities=CPU_ONLY):
        state, m = step(state, _batch(seed=2))
    assert np.isfinite(m["loss"].item())
    assert card == {"fwd": fwd_per_layer * n, "bwd": n}


def test_a_profiler_opened_between_forward_and_backward(card):
    lm, _, _ = _step("dots_no_batch")
    params = [p for p in lm.parameters() if p.requires_grad]
    loss, _ = lm.loss(_batch())
    want = torch.autograd.grad(loss, params)
    loss, _ = lm.loss(_batch())
    with torch.profiler.profile(activities=CPU_ONLY):
        got = torch.autograd.grad(loss, params)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert card == {"fwd": 4 * CFG.n_layers, "bwd": 2 * CFG.n_layers}


def test_the_route_against_the_reference_route_in_bf16(card, monkeypatch):
    """The same bf16 step through the kernels' twin and through the
    reference's naive route: the loss within 1e-2 relative and each
    gradient within 5e-2 of its leaf's largest (the naive route rounds
    its scores to bf16 before the softmax, the twin does not)."""
    lm, _, _ = _step("dots_no_batch")
    params = [p for p in lm.parameters() if p.requires_grad]
    loss, _ = lm.loss(_batch())
    got = torch.autograd.grad(loss, params)
    assert card["fwd"] > 0
    monkeypatch.setattr(registry, "_backend", lambda backend=None: backend
                        or "cuda")
    card.update(fwd=0, bwd=0)
    ref_loss, _ = lm.loss(_batch())
    want = torch.autograd.grad(ref_loss, params)
    assert card == {"fwd": 0, "bwd": 0}
    assert abs(loss.item() - ref_loss.item()) <= 1e-2 * abs(ref_loss.item())
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 5e-2 * w.abs().max() + 1e-6


def _naive_grads(lm, params):
    """The step's loss and gradients through the reference's naive route:
    the training kernels refused by the backend."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(registry, "_backend", lambda backend=None: "cpu")
        loss, _ = lm.loss(_batch())
        return loss, torch.autograd.grad(loss, params)


@pytest.mark.parametrize("how,pin", [
    ("use_impl", "cuda_flash"), ("REPRO_IMPL", "cuda_flash"),
    ("REPRO_ATTN_IMPL", "pallas_flash"), ("use_impl", "torch_flash"),
    ("use_impl", "full"), ("use_impl", "cuda_flash_train")])
def test_a_pin_in_a_bf16_step_on_the_card_backend(card, monkeypatch, how,
                                                  pin):
    """A pin to the training kernels takes them; any other pin, a serving
    pin to kernel #1 included, keeps the reference's route in training:
    no error, no kernel call, the naive route's loss and gradients."""
    lm, _, _ = _step("dots_no_batch")
    params = [p for p in lm.parameters() if p.requires_grad]
    want_loss, want = _naive_grads(lm, params)
    monkeypatch.delenv("REPRO_IMPL", raising=False)
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    if how == "use_impl":
        ctx = registry.use_impl(attention=pin)
    else:
        monkeypatch.setenv(how, pin if how == "REPRO_ATTN_IMPL"
                           else f"attention={pin}")
        ctx = contextlib.nullcontext()
    with ctx:
        assert registry.override_for("attention") == (
            "cuda_flash" if pin == "pallas_flash" else pin)
        loss, _ = lm.loss(_batch())
        got = torch.autograd.grad(loss, params)
    n = CFG.n_layers
    if pin == "cuda_flash_train":
        assert card == {"fwd": 2 * n, "bwd": n}
        return
    assert card == {"fwd": 0, "bwd": 0}
    assert loss.item() == want_loss.item()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("pin", ["torch_flash", "cuda_flash",
                                 "cuda_flash_train"])
def test_a_pin_reaches_the_recompute_on_another_thread(card, pin):
    """The forward under ``use_impl`` on this thread, the backward (and so
    the ``dots_no_batch`` recompute) on another, where the pin is not set:
    the recompute takes the forward's route, so the checkpoint sees the
    same ops and the gradients are the pinned route's."""
    lm, _, _ = _step("dots_no_batch")
    params = [p for p in lm.parameters() if p.requires_grad]
    n = CFG.n_layers
    if pin == "cuda_flash_train":
        loss, _ = lm.loss(_batch())
        want = torch.autograd.grad(loss, params)
        card.update(fwd=0, bwd=0)
    else:
        _, want = _naive_grads(lm, params)
    with registry.use_impl(attention=pin):
        loss, _ = lm.loss(_batch())
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        got = pool.submit(torch.autograd.grad, loss, params).result()
    assert card == ({"fwd": 2 * n, "bwd": n} if pin == "cuda_flash_train"
                    else {"fwd": 0, "bwd": 0})
    assert all(torch.equal(a, b) for a, b in zip(got, want))
