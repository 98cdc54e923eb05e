"""The program's spans read from a profile (``cellbench/spans.py``), on a
synthetic event list: CPU ops with a thread, a start and a correlation
id, device events linked to them, the benchmark's own ranges and their
device copies, and ``repro.`` ranges nested on two threads (the step on
the main thread, a backward range and a recompute on autograd's)."""

from types import SimpleNamespace

import pytest
import torch

from cellbench.spans import span_summary, step_shares, window_of
from cellbench.trace import profile_summary

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2


def ev(name, a, b, thread=MAIN, dev=False, id=0, linked=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a,
                                                                 end=b),
                           thread=thread, device_type=CUDA if dev else CPU,
                           id=id, linked_correlation_id=linked)


#: (span the launch lies in, launch time, thread, device interval)
LAUNCHES = [
    ("model.attention", 40, MAIN, (45, 95)),
    ("model.head_loss", 150, MAIN, (150, 250)),
    ("model.head_loss.backward", 320, AUTOGRAD, (320, 380)),
    ("model.attention", 420, AUTOGRAD, (420, 450)),       # the recompute
    ("train.step", 460, AUTOGRAD, (460, 500)),      # no range on its thread
    ("model.attention.backward", 550, AUTOGRAD, (550, 650)),
    ("train.optimizer", 750, MAIN, (750, 850)),
    ("", 890, MAIN, (890, 900)),                  # the loss fetch's copy
    ("", 5, MAIN, (995, 1010)),                   # clipped to the window
]
PROGRAM = [("train.step", 20, 880, MAIN), ("model.attention", 30, 100, MAIN),
           ("model.head_loss", 110, 200, MAIN),
           ("model.head_loss.backward", 300, 380, AUTOGRAD),
           ("model.attention", 400, 450, AUTOGRAD),
           ("model.attention.backward", 500, 600, AUTOGRAD),
           ("train.optimizer", 700, 850, MAIN)]


def events(program=True):
    evs = [ev("cellbench.window", 0, 1000),
           ev("cellbench.train_step", 10, 960),
           ev("cellbench.train_step", 12, 958, dev=True)]   # its copy
    if program:
        evs += [ev("repro." + n, a, b, t) for n, a, b, t in PROGRAM]
    for k, (_, t, thread, (a, b)) in enumerate(LAUNCHES):
        op, corr = 100 + k, 1000 + k
        evs += [ev("aten::op", t, t + 2, thread, id=op),
                ev("cudaLaunchKernel", t + 1, t + 2, thread, id=corr,
                   linked=op),
                ev("Memcpy DtoH" if k == 7 else f"kernel_{k}", a, b,
                   dev=True, id=corr, linked=op)]
    # no launch call in the profile: the kernel's own start, on any thread
    # (an op's id may equal another event's correlation id)
    evs += [ev("aten::op", 657, 658, AUTOGRAD, id=1003),
            ev("kernel_alone", 655, 665, dev=True, id=3000, linked=1003),
            ev("kernel_alone", 665, 670, dev=True, id=3001)]
    return evs


def summary(program=True):
    evs = events(program)
    p = SimpleNamespace(prof=SimpleNamespace(events=lambda: evs),
                        t0=0.0, t1=1e-3)
    out = profile_summary(p)
    out.update(span_summary(evs, window_of(evs)))
    return out


def test_device_time_and_idle_by_span():
    s = summary()
    us = 1e-6
    by = s["by_span"]
    assert {k: v[0] for k, v in by.items()} == pytest.approx({
        "model.attention": (50 + 30) * us,
        "model.head_loss": 100 * us, "model.head_loss.backward": 60 * us,
        "train.step": (40 + 10 + 5) * us,
        "model.attention.backward": 100 * us,
        "train.optimizer": 100 * us, "": (10 + 5) * us})
    assert {k: v[1] for k, v in by.items()} == {
        "model.attention": 2, "model.head_loss": 1,
        "model.head_loss.backward": 1, "train.step": 3,
        "model.attention.backward": 1, "train.optimizer": 1, "": 2}
    # each gap by the innermost program range at its middle, on any thread
    assert s["idle_by_span"] == pytest.approx({
        "train.step": (45 + 70 + 10 + 5 + 40) * us,
        "model.head_loss": 55 * us, "model.attention": 40 * us,
        "model.attention.backward": 50 * us, "train.optimizer": 80 * us,
        "train_step": 95 * us})
    # every device event of the window is under some span, or under ""
    assert sum(v[1] for v in s["by_span"].values()) == sum(
        v[1] for v in s["kernels"].values())
    assert sum(v[0] for v in s["by_span"].values()) == pytest.approx(
        sum(v[0] for v in s["kernels"].values()))


def test_the_summary_reads_the_same_with_and_without_the_programs_ranges():
    with_ranges, without = summary(True), summary(False)
    for k in ("by_span", "idle_by_span"):
        with_ranges.pop(k), without.pop(k)
    assert with_ranges == without
    plain = summary(False)
    assert set(plain["by_span"]) == {""}
    assert plain["idle_by_span"] == pytest.approx(
        plain["idle_by_host"])


def test_the_step_shares():
    s = summary()
    busy = s["busy_s"] * 1e6
    assert busy == pytest.approx(510)
    assert step_shares(s) == pytest.approx({
        "model.attention_share.train": 100 * 180 / busy,
        "model.head_loss_share.train": 100 * 160 / busy,
        "trainer.optimizer_share": 100 * 100 / busy,
        "device.idle_in_step.train": 100 * 395 / 1000})


def test_without_the_programs_spans_every_share_is_none():
    plain = summary(False)
    for s in (plain, {k: v for k, v in plain.items()
                      if k not in ("by_span", "idle_by_span")}):
        assert set(step_shares(s).values()) == {None}
