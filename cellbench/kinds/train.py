"""A training cell: the port's training step from ``train/step.py::
make_train_step``, as ``Trainer`` drives it, over batches the benchmark
draws from the seed, and the check of its first steps.

Set-up builds the port's ``LM`` at the configuration's widths, bfloat16
compute over float32 masters (``param_dtype``), under the mix's remat
policy, fills the masters with :mod:`cellbench.weights`' draw, and makes
one train state and one step function.  That step drives the first
``check_steps`` steps (set-up: they load every kernel the window runs)
and the window continues with the same state: no two objects built
alike.  After the first step the optimizer's first moment gives the
gradient it got (``m / (1 - b1)``, clipped); after the last checked step
each leaf's change is read against a copy of the start.  Every step of
the window draws a fresh batch on the card and ends in the loss's fetch,
the one sync a step; no checkpoint is written.

End to end: ``train_tokens_per_s`` is the tokens of every step completed
in the window over the window's seconds, the window closing at the end
of the first step that ends ``--seconds`` after it opened.  The window
is the same with ``--trace 1``; the profiler then traces
``PROFILE_STEPS`` steps after it has closed (two more steps first), so
nothing the profiler costs falls in the window.

The check, after the window, with the program's state freed: the plain
reference takes the same first batches from the same float32 weights
through float32 AdamW (:func:`cellbench.reference.model.
train_reference`); compared are each step's loss, the first gradient's
global norm before clipping, by the worst leaf the first (clipped)
gradient's norm and the change after the checked steps, and the first
gradients' difference, leaf by leaf, at the median leaf.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List, Optional

import torch

from cellbench import traffic as T
from cellbench.bench import device_info, family, reset_peak, sync
from cellbench.program import build_lm
from cellbench.reference import model as R
from cellbench.trace import Profile, Spans, profile_summary

__all__ = ["run", "check", "readings", "run_train", "compare_train",
           "PROFILE_STEPS"]

#: steps the traced run profiles after its window, two more steps first
PROFILE_STEPS = 4


def run_train(cell, seed: int, seconds: float, traced: bool,
              device: torch.device, t_start: float, log) -> dict:
    """One run of a training cell: the e2e numbers, the context the
    per-layer readers read, the program's checked numbers and the
    device."""
    from repro_torch.core.features import FeatureSet
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train.step import init_train_state, make_train_step
    cfg, spec = cell.cfg, cell.traffic
    if not family(cfg).TRAINS:
        raise ValueError(f"the plain reference of the {cfg['family']} "
                         f"family does not follow a training step")
    t0 = time.perf_counter()
    lm = build_lm(cfg, seed, device, getattr(torch, cfg["torch_dtype"]),
                  param_dtype=getattr(torch, spec["param_dtype"]),
                  features=FeatureSet(remat_policy=spec["remat_policy"]))
    adamw = AdamWConfig(**spec["adamw"])
    state = init_train_state(lm, adamw)
    step_fn = make_train_step(lm, adamw, ScheduleConfig(**spec["schedule"]))
    vocab = cfg["vocab_size"]
    spans = Spans(traced)
    b1 = float(spec["adamw"]["b1"])
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    losses: List[float] = []
    checked = int(spec["check_steps"])
    grad_norm = None
    grad_leaf: Dict[str, float] = {}
    first_grad: Dict[str, torch.Tensor] = {}
    for t in range(checked):
        state, m = step_fn(state, T.train_batch(spec, vocab, seed, t, device))
        losses.append(float(m["loss"]))
        if t == 0:
            grad_norm = float(m["grad_norm"])
            grad_leaf = {k: float(v.double().norm()) / (1 - b1)
                         for k, v in state.opt.m.items()}
            first_grad = {k: (v / (1 - b1)).to("cpu", copy=True)
                          for k, v in state.opt.m.items()}
    change_leaf = {k: float((state.params[k].detach() - p0[k])
                            .double().norm()) for k in p0}
    del p0
    gc.collect()
    log(f"[cellbench] set-up: imports and device {t0 - t_start:.2f} s, "
        f"weights and state to the end of step {checked} "
        f"{time.perf_counter() - t0:.2f} s")
    sync(device)
    reset_peak(device)
    step = checked
    done = 0

    def one_step():
        nonlocal step, state, m, batch, loss
        with spans.span("train_step"):
            with spans.span("data"):
                batch = T.train_batch(spec, vocab, seed, step, device)
            state, m = step_fn(state, batch)
            with spans.span("loss_fetch"):
                loss = float(m["loss"])
        step += 1

    loss = float("nan")
    batch = None
    t_open = time.perf_counter()
    while True:
        one_step()
        done += 1
        now = time.perf_counter()
        if now - t_open >= seconds:
            break
    window_s = now - t_open
    prof = None
    if traced:
        # after the window: two steps, then the profiled ones
        for _ in range(2):
            one_step()
        spans.seconds.clear()
        prof = Profile(device)
        prof.start()
        for _ in range(PROFILE_STEPS):
            one_step()
        prof.stop()
    if loss != loss:
        raise FloatingPointError("the loss went to nan in the window")
    tokens = done * int(spec["batch"]) * int(spec["seq"])
    e2e = {"setup_s": t_open - t_start,
           "train_tokens_per_s": tokens / window_s}
    log(f"[cellbench] window {window_s:.3f} s: {done} steps of "
        f"{int(spec['batch'])} x {int(spec['seq'])} tokens; last loss "
        f"{loss:.5f}")
    dev_info = device_info(device, cell.chips)
    ctx = dict(kind="train", cfg=cfg, spec=spec, window_s=window_s,
               steps=done, spans=dict(spans.seconds),
               profile=(profile_summary(prof) if prof is not None
                        and prof.done else None),
               profile_steps=PROFILE_STEPS)
    del state, step_fn, lm, m, batch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prog = dict(loss=losses, grad_norm=grad_norm, grad_leaf=grad_leaf,
                first_grad=first_grad, change_leaf=change_leaf)
    return dict(e2e=e2e, ctx=ctx, device=dev_info, program=prog,
                attempted=checked, failed=0)


def compare_train(cfg: dict, spec: dict, seed: int, prog: dict,
                  device: torch.device, prec: str = "fp32",
                  rows: Optional[slice] = None, ref: Optional[dict] = None
                  ) -> Dict[str, object]:
    """The numbers compared, program (``prog``) against the reference
    (run here unless ``ref`` is given): ``loss_rel`` the largest relative
    gap of a step's loss; ``grad_norm_rel`` the first gradient's global
    norm; ``grad_leaf`` and ``change_leaf`` the worst leaf's gap of norms
    over the larger of that leaf's reference norm and the median leaf's;
    ``grad_diff_median`` the median over the leaves of the norm of the
    first gradients' difference over that same norm, and ``grad_diff``
    the worst leaf's.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (rounding moves them under Adam) are left out of the change;
    ``worst_leaves`` names the leaves that set the two worst-leaf numbers
    and those left out."""
    if ref is None:
        batches = [T.train_batch(spec, cfg["vocab_size"], seed, t, device)
                   for t in range(int(spec["check_steps"]))]
        ref = R.train_reference(cfg, seed, spec, batches, device, prec, rows)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                        ref["loss"]))
    gmed = statistics.median(ref["grad_leaf"].values())
    cmed = statistics.median(ref["change_leaf"].values())

    def worst(p, r, med, keys):
        return max((abs(p[k] - r[k]) / max(r[k], med), k) for k in keys)

    keys = list(ref["grad_leaf"])
    moving = [k for k in keys if ref["grad_leaf"][k] >= 1e-3 * gmed]
    g, g_at = worst(prog["grad_leaf"], ref["grad_leaf"], gmed, keys)
    c, c_at = worst(prog["change_leaf"], ref["change_leaf"], cmed, moving)
    diff = {k: float(torch.linalg.vector_norm(
        prog["first_grad"][k].to(device) - ref["first_grad"][k].to(device),
        dtype=torch.float64)) / max(ref["grad_leaf"][k], gmed) for k in keys}
    d_worst, d_at = max((v, k) for k, v in diff.items())
    return {"loss_rel": loss_rel,
            "grad_norm_rel": abs(prog["grad_norm"] - ref["grad_norm"])
            / ref["grad_norm"],
            "grad_leaf": g, "change_leaf": c,
            "grad_diff_median": statistics.median(diff.values()),
            "grad_diff": d_worst,
            "worst_leaves": {"grad_leaf": g_at, "change_leaf": c_at,
                             "grad_diff": d_at,
                             "left_out_of_change": sorted(
                                 set(keys) - set(moving))}}


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t_start: float, log) -> dict:
    """The kind's run: :func:`run_train`."""
    return run_train(cell, seed, seconds, traced, device, t_start, log)


def check(cell, seed: int, out: dict, device: torch.device, log) -> dict:
    """The numbers compared, the program's first steps against the
    float32 reference's."""
    t0 = time.perf_counter()
    nums = compare_train(cell.cfg, cell.traffic, seed, out["program"],
                         device)
    log(f"[cellbench] reference {time.perf_counter() - t0:.2f} s")
    return nums


def readings(cell, seed: int, seconds: float, device: torch.device,
             controls: bool = True) -> dict:
    """One seed's readings: the program, and with ``controls`` each
    float8 control (the reference in float8 put in the program's place)
    and the fault of half of each batch left out (the mean over the
    rest), each against the float32 reference."""
    out = run_train(cell, seed, seconds, False, device, time.perf_counter(),
                    lambda m: None)
    cfg, spec = cell.cfg, cell.traffic
    batches = [T.train_batch(spec, cfg["vocab_size"], seed, t, device)
               for t in range(int(spec["check_steps"]))]
    ref = R.train_reference(cfg, seed, spec, batches, device)
    res = {"program": compare_train(cfg, spec, seed, out["program"], device,
                                    ref=ref),
           "e2e": out["e2e"]}
    half = slice(0, int(spec["batch"]) // 2)
    for name, kw in (("control_fp8_gemm", dict(prec="fp8_gemm")),
                     ("control_fp8", dict(prec="fp8")),
                     ("half_batch", dict(rows=half))) if controls else ():
        other = R.train_reference(cfg, seed, spec, batches, device, **kw)
        res[name] = compare_train(cfg, spec, seed, other, device, ref=ref)
    return res
