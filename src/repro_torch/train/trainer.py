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

**On a mesh** (``mesh=``, ``state_shardings=``; the GSPMD trainer of
the reference jits its step with the state's shardings).  The port is
SPMD: every rank of the mesh runs this loop.  ``lm`` is the whole model
as the host copy on the CPU (as ``Engine(mesh=)`` takes it); the
trainer builds the rank's tensor-parallel LM on the rank's device
(``LM(tp=, dp=)``) and keeps between steps only the rank's slices of the
state under ``state_shardings`` (default: :func:`~repro_torch.train.
step.train_state_pspecs` of ``lm``): fp32 masters and both moments,
split over ``model`` and, by the FSDP rule ``embed -> data``, over
``data``; the weights gathered over ``data`` for a step are transient
(:class:`~repro_torch.train.step.StateLayout`).  Each rank reads the
batch rows of its data coordinate (``DataConfig.process_index`` /
``process_count`` = its index and size on the data axis); with
``accum_steps`` A > 1 over D > 1 data ranks it reads, for microbatch i,
rows ``(i D + r) B / (A D)`` onward, so each microbatch is the one the
reference's ``[A, B / A]`` reshape of the global batch makes.
Checkpoints keep the reference's layout of whole leaves: the slices
gather onto the mesh's first rank, which writes, and a restore reads
whole leaves and cuts each rank's slices, so a run saved on one mesh
shape resumes on another, or unsharded.  Only the mesh's first rank
prints.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.data import DataConfig, make_source
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.models.lm import LM
from repro_torch.optim import (AdamWConfig, OptState, ScheduleConfig,
                               init_opt_state)
from repro_torch.train.step import (StateLayout, TrainState,
                                    init_train_state, make_train_step,
                                    train_state_pspecs)

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
                 mesh: Any = None, state_shardings: Any = None):
        if state_shardings is not None and mesh is None:
            raise ValueError("state_shardings needs the mesh they name")
        self.cfg = trainer_cfg
        self.adamw = adamw or AdamWConfig()
        self.sched = sched or ScheduleConfig(
            total_steps=trainer_cfg.total_steps)
        self.mesh = mesh
        self.host: Optional[LM] = None
        self.layout: Optional[StateLayout] = None
        self.leader = True
        sources = [data_cfg]
        if mesh is None:
            self.lm = lm
        else:
            sources = self._enter_mesh(lm, data_cfg, state_shardings)
        self.sources = [make_source(c) for c in sources]
        self.data = self.sources[0]
        self.step_fn = make_train_step(self.lm, self.adamw, self.sched,
                                       accum_steps=trainer_cfg.accum_steps,
                                       layout=self.layout)
        self.detector = StragglerDetector()
        self.history: List[Dict[str, float]] = []

    def _enter_mesh(self, lm: LM, data_cfg: DataConfig,
                    state_shardings: Any) -> List[DataConfig]:
        """The rank's LM and state layout on ``self.mesh``; returns the
        data configs of the rank's rows (one a microbatch when they
        interleave, see the module note)."""
        from repro_torch.launch import mesh as mesh_mod
        if lm.device.type != "cpu":
            raise ValueError(
                f"a sharded trainer takes the full LM as its host copy on "
                f"the CPU, not on {lm.device}: the trainer puts only this "
                f"rank's slices of the state on its device")
        tp, dp = (mesh_mod.model_axis(self.mesh),
                  mesh_mod.data_axis(self.mesh))
        if tp is None:
            raise ValueError("this rank is not in the training mesh: every "
                             "rank of a training world holds a slice")
        if lm.cfg.num_kv_heads % tp.size:
            raise ValueError(
                f"num_kv_heads={lm.cfg.num_kv_heads} does not divide over "
                f"the model axis ({tp.size} ranks)")
        if state_shardings is None:
            state_shardings = train_state_pspecs(
                lm, self.mesh,
                ef=self.adamw.grad_compression == "int8_ef")
        specs = state_shardings.params
        if (state_shardings.opt.m != specs or state_shardings.opt.v != specs
                or state_shardings.opt.ef not in (None, specs)):
            raise ValueError("the moments (and the error feedback) must "
                             "shard like the params")
        self.host = lm
        self.lm = LM(lm.cfg, lm.dtype, mesh_mod.rank_device(),
                     features=lm.features, param_dtype=lm.param_dtype,
                     rules=lm.rules, tp=tp, dp=dp)
        self.lm.requires_grad_(True)
        self.layout = StateLayout(self.lm, specs, self.mesh,
                                  dict(lm.named_parameters()))
        self.leader = (int(mesh_mod.mesh_ranks(self.mesh).flat[0])
                       == torch.distributed.get_rank())
        a = self.cfg.accum_steps
        if a == 1 or dp.size == 1:
            return [dataclasses.replace(data_cfg, process_index=dp.index,
                                        process_count=dp.size)]
        return [dataclasses.replace(data_cfg,
                                    process_index=i * dp.size + dp.index,
                                    process_count=a * dp.size)
                for i in range(a)]

    def _log(self, msg: str) -> None:
        if self.leader:
            print(msg)

    # ---------------------------------------------------------------- state
    def init_or_restore(self) -> TrainState:
        """The state drawn from ``seed`` (``LM.init`` on the LM's device;
        on a mesh, on the host copy, then cut into the rank's slices),
        then the latest checkpoint under ``ckpt_dir`` restored into it."""
        lm = self.host if self.layout is not None else self.lm
        lm.init(torch.Generator(device=lm.device).manual_seed(self.cfg.seed))
        state = self.init_state()
        step = (latest_step(self.cfg.ckpt_dir) if self.cfg.ckpt_dir
                else None)
        if step is None:
            return state
        if self.layout is None:
            state, _ = restore_checkpoint(self.cfg.ckpt_dir, step,
                                          target=state)
        else:
            self._restore_sharded(step, state)
        self._log(f"[trainer] resumed from step {step}")
        return state

    def init_state(self) -> TrainState:
        """A fresh state over the weights the LM holds now, drawing
        nothing (on a mesh: the host copy's, cut into the rank's
        slices)."""
        if self.layout is None:
            return init_train_state(self.lm, self.adamw)
        params = self.layout.init_params(dict(self.host.named_parameters()))
        return TrainState(params=params,
                          opt=init_opt_state(params, self.adamw),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.lm.device))

    def _restore_sharded(self, step: int, state: TrainState) -> None:
        """Checkpoint ``step``'s whole leaves into the host, then each
        leaf's slice into ``state``, in place."""
        full = dict(self.host.named_parameters())

        def zeros(dtype=None):
            return {k: torch.zeros(p.shape, dtype=dtype or p.dtype)
                    for k, p in full.items()}

        mdt = next(iter(state.opt.m.values())).dtype
        whole = TrainState(
            params=full,
            opt=OptState(m=zeros(mdt), v=zeros(mdt),
                         step=torch.zeros((), dtype=torch.int32),
                         ef=None if state.opt.ef is None else zeros(
                             torch.float32)),
            step=torch.zeros((), dtype=torch.int32))
        with torch.no_grad():
            restore_checkpoint(self.cfg.ckpt_dir, step, target=whole)
            for mine, src in ((state.params, whole.params),
                              (state.opt.m, whole.opt.m),
                              (state.opt.v, whole.opt.v),
                              (state.opt.ef, whole.opt.ef)):
                for k, t in (mine or {}).items():
                    t.copy_(self.layout.cut(k, src[k]))
            state.opt.step.copy_(whole.opt.step)
            state.step.copy_(whole.step)

    def _save(self, step: int, state: TrainState) -> None:
        """One checkpoint of whole leaves (on a mesh: the slices gather
        onto the mesh's first rank, which writes, and the mesh waits for
        it)."""
        if self.layout is None:
            save_checkpoint(self.cfg.ckpt_dir, step, state,
                            keep=self.cfg.ckpt_keep)
            return
        full, opt = self.layout.full, state.opt
        trees = [full(t, first=True)
                 for t in (state.params, opt.m, opt.v, opt.ef or {})]
        if self.leader:
            whole = TrainState(
                params=trees[0],
                opt=OptState(m=trees[1], v=trees[2], step=opt.step.cpu(),
                             ef=None if opt.ef is None else trees[3]),
                step=state.step.cpu())
            save_checkpoint(self.cfg.ckpt_dir, step, whole,
                            keep=self.cfg.ckpt_keep)
        # every rank of the mesh waits for the write (a collective on each
        # axis orders every rank after the leader's)
        t = torch.zeros(1, device=self.lm.device)
        for axis in self.layout.axes.values():
            axis.all_reduce(t)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The data source's batch at ``step`` (on a mesh, this rank's
        rows), on the LM's device."""
        parts = [src.batch_at(step) for src in self.sources]
        return {k: torch.from_numpy(np.concatenate([p[k] for p in parts])
                                    if len(parts) > 1 else parts[0][k]
                                    ).to(self.lm.device, non_blocking=True)
                for k in parts[0]}

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
                self._log(f"[ft] straggler step {step}: {dt*1e3:.1f} ms "
                          f"(ema {verdict.ema*1e3:.1f} ms)")
            row = {"step": step, "loss": loss, "grad_norm": gnorm,
                   "lr": lr, "wall_s": dt}
            self.history.append(row)
            if (step % self.cfg.log_every == 0
                    or step == self.cfg.total_steps - 1):
                self._log(f"[train] step {step:>6} loss {loss:.4f} "
                          f"gnorm {gnorm:.3f} lr {lr:.2e} {dt*1e3:.1f} ms")
            if (self.cfg.ckpt_dir and self.cfg.ckpt_every
                    and (step + 1) % self.cfg.ckpt_every == 0):
                self._save(step + 1, state)
                saved = step + 1
        # the final checkpoint, unless the last periodic one is this step
        # (the reference writes the same files twice)
        if self.cfg.ckpt_dir and saved != int(state.step):
            self._save(int(state.step), state)
        return state
