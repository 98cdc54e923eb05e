"""The plain reference against the port at tiny sizes on the CPU, in
float32: the forward (dense and moe, with the moe's capacity over one
prefill call), greedy serving through the port's engine, and three AdamW
steps of the training step."""

import time

import pytest
import torch

from cellbench.bench import Cell, family
from cellbench.program import build_lm
from cellbench.reference import model as R

CPU = torch.device("cpu")


def _cell(root, name, **cfg):
    cell = Cell(name, root)
    cell.cfg = dict(cell.cfg, torch_dtype="float32", **cfg)
    return cell


@pytest.mark.parametrize("name", ["tiny-dense.serve.tiny-reask",
                                  "tiny-moe.serve.tiny"])
def test_forward_matches_the_port(tiny_root, name):
    cell = _cell(tiny_root, name)
    lm = build_lm(cell.cfg, 5, CPU, torch.float32)
    toks = torch.randint(0, 256, (1, 40), generator=torch.Generator()
                         .manual_seed(1))
    with torch.no_grad():
        want = lm.forward({"tokens": toks})[0]
    calls = family(cell.cfg).prefill_calls(0, 40)
    got = R.serve_logits(cell.cfg, 5, [R.Stream(toks[0].tolist(), 0, calls)],
                         CPU, torch.float32)["fp32"][0]
    assert torch.allclose(got, want, atol=1e-4 * float(want.abs().max()))


def test_moe_capacity_drops_as_the_port_does(tiny_root):
    # a call long enough that some expert overflows its capacity: the
    # reference must drop the same assignments
    cell = _cell(tiny_root, "tiny-moe.serve.tiny")
    lm = build_lm(cell.cfg, 9, CPU, torch.float32)
    toks = torch.randint(0, 256, (1, 96), generator=torch.Generator()
                         .manual_seed(2))
    with torch.no_grad():
        want = lm.forward({"tokens": toks})[0]
    got = R.serve_logits(cell.cfg, 9, [R.Stream(toks[0].tolist(), 0,
                                                [(0, 96)])],
                         CPU, torch.float32)["fp32"][0]
    dropless = R.serve_logits(cell.cfg, 9, [R.Stream(toks[0].tolist(), 0)],
                              CPU, torch.float32)["fp32"][0]
    scale = float(want.abs().max())
    assert torch.allclose(got, want, atol=1e-4 * scale)
    assert not torch.allclose(dropless, want, atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["tiny-dense.serve.tiny-reask",
                                  "tiny-moe.serve.tiny"])
def test_served_tokens_of_a_float32_run_sit_on_the_reference(tiny_root,
                                                             name):
    cell = _cell(tiny_root, name)
    out = cell.kind.run_serve(cell, 21, 1.0, False, CPU, time.perf_counter(),
                              lambda m: None)
    g = cell.kind.served_gaps(cell.cfg, 21, out["checks"], CPU)["fp32"]
    assert out["failed"] == 0 and out["checks"]
    assert g["prefill_gap"] < 1e-4
    if cell.cfg["family"] != "moe":
        # the moe decode shares its capacity with the batch's other rows
        assert g["served_gap"] < 1e-4


def test_training_steps_match_the_port(tiny_root):
    cell = _cell(tiny_root, "tiny-dense.train.tiny")
    out = cell.kind.run_train(cell, 33, 0.5, False, CPU, time.perf_counter(),
                              lambda m: None)
    nums = cell.kind.compare_train(cell.cfg, cell.traffic, 33,
                                   out["program"], CPU)
    assert nums["loss_rel"] < 1e-5
    assert nums["grad_norm_rel"] < 1e-5
    assert nums["grad_leaf"] < 1e-4
    assert nums["change_leaf"] < 1e-3
    assert nums["grad_diff_median"] < 1e-5
