"""The training loop: data -> step -> checkpoint -> ft hooks.

Port of ``repro/train/trainer.py`` (what ``examples/train_e2e_torch.py``
and ``repro_torch.launch.train`` run):

* the data source (:mod:`repro_torch.data`), read at ``batch_at(step)``:
  the synthetic source is a pure function of the step, so a resume sees
  exactly the batches the uninterrupted run saw;
* the train step (:func:`~repro_torch.train.step.make_train_step`),
  which updates the state in place;
* ONE host sync a step: the loss, grad norm and rate come back in one
  transfer after the step is enqueued (the reference's
  ``block_until_ready``), which is also what the step's wall time waits
  for;
* periodic and final checkpoints (:mod:`repro_torch.checkpoint`: atomic,
  retained, written in line) and crash-resume from the latest one;
* straggler detection on the step time (:mod:`repro_torch.ft.straggler`).

``mesh=`` and ``state_shardings=`` shard the state over a device mesh:
item 14b's, refused here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint.store import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.data import DataConfig, make_source
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_train_step)

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    accum_steps: int = 1
    seed: int = 0


class Trainer:
    def __init__(self, lm: LM, data_cfg: DataConfig,
                 trainer_cfg: TrainerConfig,
                 adamw: Optional[AdamWConfig] = None,
                 sched: Optional[ScheduleConfig] = None,
                 mesh=None, state_shardings=None):
        if mesh is not None or state_shardings is not None:
            raise NotImplementedError(
                "Trainer(mesh=, state_shardings=) shards the train state "
                "over a device mesh: not ported yet (ROADMAP.md, item 14b: "
                "the training half of the mesh)")
        self.lm = lm
        self.cfg = trainer_cfg
        self.adamw = adamw or AdamWConfig()
        self.sched = sched or ScheduleConfig(
            total_steps=trainer_cfg.total_steps)
        self.data = make_source(data_cfg)
        self.step_fn = make_train_step(lm, self.adamw, self.sched,
                                       accum_steps=trainer_cfg.accum_steps)
        self.detector = StragglerDetector()
        self.history: List[Dict[str, float]] = []

    # ---------------------------------------------------------------- state
    def init_or_restore(self) -> TrainState:
        """The state drawn from ``seed`` (``LM.init`` on the LM's device),
        then the latest checkpoint under ``ckpt_dir`` restored into it."""
        gen = torch.Generator(device=self.lm.device).manual_seed(
            self.cfg.seed)
        state = init_train_state(self.lm, self.adamw, gen)
        if self.cfg.ckpt_dir:
            step = latest_step(self.cfg.ckpt_dir)
            if step is not None:
                state, _ = restore_checkpoint(self.cfg.ckpt_dir, step,
                                              target=state)
                print(f"[trainer] resumed from step {step}")
        return state

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The data source's batch at ``step``, on the LM's device."""
        return {k: torch.from_numpy(v).to(self.lm.device, non_blocking=True)
                for k, v in self.data.batch_at(step).items()}

    # ----------------------------------------------------------------- loop
    def run(self, state: Optional[TrainState] = None) -> TrainState:
        state = state if state is not None else self.init_or_restore()
        start = int(state.step)
        saved = None
        for step in range(start, self.cfg.total_steps):
            batch = self.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss, gnorm, lr = torch.stack(
                [metrics["loss"], metrics["grad_norm"],
                 metrics["lr"]]).tolist()
            dt = time.perf_counter() - t0
            verdict = self.detector.record(dt)
            if verdict.is_straggler:
                print(f"[ft] straggler step {step}: {dt*1e3:.1f} ms "
                      f"(ema {verdict.ema*1e3:.1f} ms)")
            row = {"step": step, "loss": loss, "grad_norm": gnorm,
                   "lr": lr, "wall_s": dt}
            self.history.append(row)
            if (step % self.cfg.log_every == 0
                    or step == self.cfg.total_steps - 1):
                print(f"[train] step {step:>6} loss {loss:.4f} "
                      f"gnorm {gnorm:.3f} lr {lr:.2e} {dt*1e3:.1f} ms")
            if (self.cfg.ckpt_dir and self.cfg.ckpt_every
                    and (step + 1) % self.cfg.ckpt_every == 0):
                save_checkpoint(self.cfg.ckpt_dir, step + 1, state,
                                keep=self.cfg.ckpt_keep)
                saved = step + 1
        # the final checkpoint, unless the last periodic one is this step
        # (the reference writes the same files twice)
        if self.cfg.ckpt_dir and saved != int(state.step):
            save_checkpoint(self.cfg.ckpt_dir, int(state.step), state,
                            keep=self.cfg.ckpt_keep)
        return state
