"""The program's spans (``repro_torch.core.marker.span``) on the CPU.

A tiny qwen2-like LM (qwen2-0.5b's ``SMOKE`` config, fp32) trains one
step under remat:

* outside a profiler a span is the shared no-op and the autograd graph
  holds no mark;
* loss, gradients and updated params are bitwise equal with and without
  a ``torch.profiler`` session around the step;
* under the profiler each step records one ``repro.train.step``, one
  ``repro.train.optimizer``, 2L ``repro.model.attention`` (forward and
  recompute), L ``repro.model.attention.backward``, one
  ``repro.model.head_loss`` and its backward, none a user annotation;
* a profiler started between forward and backward changes no gradient;
* the marks (gradient hooks) add no node to the graph and run no aten
  op, and a backward range whose input needs no gradient is closed by
  the outermost span.
"""

import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.core import marker
from repro_torch.core.features import default_features
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)

CFG = get_arch("qwen2-0.5b").smoke
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


def _build(remat="dots_no_batch"):
    lm = LM(CFG, torch.float32, "cpu",
            features=default_features().with_(remat_policy=remat),
            param_dtype=torch.float32)
    lm.init(torch.Generator().manual_seed(0))
    adamw = AdamWConfig()
    state = init_train_state(lm, adamw)
    step = make_train_step(lm, adamw, ScheduleConfig(
        peak_lr=1e-2, warmup_steps=1, total_steps=10))
    return lm, state, step


def _batch(seed=1, rows=2, seq=16):
    toks = torch.randint(0, CFG.vocab, (rows, seq + 1),
                         generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _nodes(fn):
    """Names of every node of the autograd graph under ``fn``."""
    seen, todo, names = set(), [fn], []
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.append(f.name())
        todo.extend(n for n, _ in f.next_functions)
    return names


def _spans(prof):
    return [e for e in prof.events()
            if e.name.startswith(marker.SPAN_PREFIX)]


def _count_marks(monkeypatch):
    """Count the marks' firings (the hooks are looked up when applied)."""
    seen = {"on_output": 0, "on_input": 0}
    for hook in seen:
        real = getattr(marker._Backward, hook)

        def counted(self, grad, real=real, hook=hook):
            seen[hook] += 1
            real(self, grad)
        monkeypatch.setattr(marker._Backward, hook, counted)
    return seen


def test_outside_a_profiler_a_span_is_the_shared_no_op(monkeypatch):
    x = torch.ones(3, requires_grad=True)
    s = marker.span("model.attention")
    assert s is marker.span("train.step")
    with s as inner:
        y = x * 2
        assert inner.input(y) is y and inner.output(y) is y
    assert y._backward_hooks is None
    seen = _count_marks(monkeypatch)
    lm, _, _ = _build()
    loss, _ = lm.loss(_batch())
    graph = _nodes(loss.grad_fn)
    loss.backward()
    assert seen == {"on_output": 0, "on_input": 0}
    with torch.profiler.profile(activities=CPU_ONLY):
        loss, _ = lm.loss(_batch())
        # the marks are hooks: the graph's nodes are the unmarked ones
        assert _nodes(loss.grad_fn) == graph
        loss.backward()
    assert seen == {"on_output": CFG.n_layers + 1,
                    "on_input": CFG.n_layers + 1}


@pytest.mark.parametrize("remat", ["dots_no_batch", "full", "none"])
def test_a_profiled_step_is_bitwise_the_unprofiled_one(remat):
    _, s0, step0 = _build(remat)
    s0, m0 = step0(s0, _batch())
    _, s1, step1 = _build(remat)
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        s1, m1 = step1(s1, _batch())
    assert any(e.name == "repro.train.step" for e in prof.events())
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for k in s0.params:
        assert torch.equal(s0.opt.m[k], s1.opt.m[k]), k     # the gradient
        assert torch.equal(s0.opt.v[k], s1.opt.v[k]), k
        assert torch.equal(s0.params[k], s1.params[k]), k


def test_each_step_records_its_spans_once_and_the_blocks_twice():
    _, state, step = _build()
    steps, n = 2, CFG.n_layers
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        for t in range(steps):
            state, _ = step(state, _batch(seed=t))
    spans = _spans(prof)
    count = {}
    for e in spans:
        count[e.name] = count.get(e.name, 0) + 1
        assert not e.is_user_annotation, e.name
    assert count == {"repro.train.step": steps,
                     "repro.train.optimizer": steps,
                     "repro.model.attention": 2 * n * steps,
                     "repro.model.attention.backward": n * steps,
                     "repro.model.head_loss": steps,
                     "repro.model.head_loss.backward": steps}
    # every span lies in a step; the blocks' backward ranges never overlap
    outer = [e.time_range for e in spans if e.name == "repro.train.step"]
    for e in spans:
        assert any(o.start <= e.time_range.start and e.time_range.end <= o.end
                   for o in outer), e.name
    back = sorted((e.time_range.start, e.time_range.end) for e in spans
                  if e.name == "repro.model.attention.backward")
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(back, back[1:]))


def test_a_profiler_started_between_forward_and_backward():
    lm, _, _ = _build()
    params = [p for p in lm.parameters()]
    loss, _ = lm.loss(_batch())
    want = torch.autograd.grad(loss, params)
    loss, _ = lm.loss(_batch())
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        got = torch.autograd.grad(loss, params)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    names = [e.name for e in _spans(prof)]
    # the recompute records the blocks' attention; no backward range opens
    assert names.count("repro.model.attention") == CFG.n_layers
    assert not any(n.endswith(".backward") for n in names)


def test_the_marks_run_no_aten_op(monkeypatch):
    def ops(batch):
        _, state, step = _build()
        with torch.profiler.profile(activities=CPU_ONLY) as prof:
            step(state, batch)
        return sorted(e.name for e in prof.events()
                      if e.name.startswith("aten::"))

    marked = ops(_batch())
    monkeypatch.setattr(marker._Span, "_mark", lambda self, t, hook: t)
    assert ops(_batch()) == marked


def test_an_input_without_a_gradient_is_closed_by_the_outermost_span():
    w = torch.ones(4, requires_grad=True)
    x = torch.ones(4)                                   # needs no gradient
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        with marker.span("outer"):
            with marker.span("inner") as s:
                y = s.output(s.input(x) * w)
            y.sum().backward()
            assert w.grad is not None
    by = {e.name: e.time_range for e in _spans(prof)}
    back, outer = by["repro.inner.backward"], by["repro.outer"]
    assert outer.start <= back.start and back.end <= outer.end
