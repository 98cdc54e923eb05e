"""The yardstick's arithmetic: whole-window rates and tails, spreads, and
the frozen FLOP and byte counts against hand counts at the
configurations' widths."""

import json
from pathlib import Path

import numpy as np
import pytest

from cellbench import flops as F
from cellbench.bench import p95

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_p95_takes_the_tail_of_every_value():
    xs = [float(i) for i in range(1, 201)]
    assert p95(xs) == pytest.approx(float(np.percentile(xs, 95)))
    assert p95([5.0]) == 5.0
    assert p95([1.0, 2.0]) == pytest.approx(1.95)
    with pytest.raises(ValueError):
        p95([])


def test_rates_are_all_the_work_over_the_whole_window():
    from cellbench.bench import ROOT, plugin
    assert plugin(ROOT, "kinds", "train").run_train  # the module loads
    # 59 steps of 8 x 2048 tokens in a 50.2 s window
    assert 59 * 8 * 2048 / 50.2 == pytest.approx(19257.8, rel=1e-4)


def test_qwen2_0_5b_parameters_hand_count():
    c = cfg("qwen2-0.5b")
    embed = 151936 * 896
    attn = 896 * 14 * 64 * 2 + 896 * 2 * 64 * 2 + (14 + 2 + 2) * 64
    layer = attn + 3 * 896 * 4864 + 2 * 896
    assert F.num_params(c) == embed + 24 * layer + 896 == 494032768
    assert F.active_matmul_params(c) == 24 * (attn + 3 * 896 * 4864)


def test_qwen2_moe_parameters_hand_count():
    c = cfg("qwen2-moe-a2.7b")
    d, e, f, fs = 2048, 60, 1408, 5632
    attn = 4 * d * d + 3 * d
    layer = attn + 2 * d + d * e + 3 * e * d * f + 3 * d * fs + d
    total = 2 * 151936 * d + 24 * layer + d
    assert F.num_params(c) == total
    assert 14.2e9 < total < 14.4e9
    active = 24 * (attn + d * e + 4 * 3 * d * f + 3 * d * fs + d)
    assert F.active_matmul_params(c) == active


def test_train_step_flops_hand_count():
    c = cfg("qwen2-0.5b")
    t = 8 * 2048
    want = 6.0 * 494032768 * t + 12.0 * 24 * 14 * 64 * 2048 * t
    assert F.train_step_flops(c, 8, 2048) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(57.2e12, rel=0.01)


def test_flash_traffic_hand_count():
    # qwen2-0.5b prefill of 4 tokens, one row, causal: 10 (query, key) pairs
    fl, rd, wr = F.flash_traffic([4], h=14, kvh=2, sq=4, sk=4, dh=64,
                                 itemsize=2, causal=True, q_offset=0)
    assert fl == 4 * 64 * 14 * 10
    qo = 14 * 4 * 64 * 2
    assert wr == qo
    assert rd == qo + 2 * 2 * 64 * 2 * 4 + 4
    # not causal: every pair
    fl2, _, _ = F.flash_traffic([4], h=14, kvh=2, sq=4, sk=4, dh=64,
                                itemsize=2, causal=False, q_offset=0)
    assert fl2 == 4 * 64 * 14 * 16


def test_paged_traffic_hand_count():
    # two rows at 20 and 0 past tokens, pages of 16, qwen2-moe's heads
    fl, rd, wr = F.paged_traffic([20, 0], kvh=16, g=1, dh=128, ps=16,
                                 q_itemsize=2, page_itemsize=2,
                                 scales=False)
    assert fl == 4.0 * 128 * 16 * (21 + 1)
    out = 2 * 16 * 128 * 2
    assert wr == out
    live = 2                                   # ceil(20 / 16) + 0
    assert rd == out + 2 * 2 * 16 * 128 * 2 + 4 * 2 + live * (
        16 * 2 * 16 * 128 * 2 + 4)


def test_bound_takes_the_larger_of_compute_and_bytes():
    assert F.bound_s(989e12, 0, 0) == pytest.approx(1.0)
    assert F.bound_s(0, 3.35e12, 0) == pytest.approx(1.0)
    assert F.bound_s(989e12, 3.35e12, 3.35e12) == pytest.approx(2.0)


def test_forward_flops_hand_count():
    c = cfg("qwen2-0.5b")
    n = F.active_matmul_params(c)
    # one decoded token after 9 cached: 10 pairs a head a layer
    assert F.forward_flops(c, 1, 9, 1) == pytest.approx(
        2.0 * n + 4.0 * 24 * 14 * 64 * 10 + 2.0 * 896 * 151936)
    # a 3-token prefill: 6 causal pairs
    assert F.forward_flops(c, 3, 0, 1) == pytest.approx(
        6.0 * n + 4.0 * 24 * 14 * 64 * 6 + 2.0 * 896 * 151936)
