"""train_step factory: loss and gradients, grad accumulation, AdamW.

Port of ``repro/train/step.py``.  The reference's step is a pure
function of (TrainState, batch), jitted with the state donated.  Here the
state's ``params`` ARE the LM's parameters (``dict(lm.named_parameters())``)
and the step updates them and the moments in place, the counterpart of
donation: ``make_train_step(lm, ...)`` closes over the LM, and the state
it is given must be :func:`init_train_state`'s over that LM (or a
checkpoint restored into it).

Gradient accumulation follows ``repro/train/step.py:68-88``: the batch
splits along its leading axis into ``accum_steps`` microbatches; each
one's fp32 gradients add into one buffer, which is then divided by
``accum_steps``; the loss is the mean of the microbatch means.  A
parameter no path reaches gets a zero gradient, as ``jax.grad`` gives.
Nothing in the step reads a number back to the host: the step counter,
the rate and the metrics stay 0-d device tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import roofline
from repro_torch.models.lm import LM
from repro_torch.optim import (AdamWConfig, OptState, ScheduleConfig,
                               apply_updates, init_opt_state, lr_at)

__all__ = ["TrainState", "make_train_step", "init_train_state",
           "train_state_pspecs", "model_flops"]

Batch = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # the LM's own parameters
    opt: OptState
    step: torch.Tensor                # 0-d int32 on the params' device


def init_train_state(lm: LM, adamw: AdamWConfig,
                     generator: Optional[torch.Generator] = None
                     ) -> TrainState:
    """A fresh state over ``lm``'s parameters, made trainable (re-drawn
    from ``LM.init``'s distributions first when ``generator`` is given;
    else the weights it holds, e.g. bridged ones)."""
    if generator is not None:
        lm.init(generator)
    lm.requires_grad_(True)
    params = dict(lm.named_parameters())
    return TrainState(params=params, opt=init_opt_state(params, adamw),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=lm.device))


def model_flops(lm: LM, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch x seq`` tokens:
    ``6 N T + 12 L H Dh S T`` (PaLM's count: N the parameters a token
    multiplies, the MoE's active ones; L the self-attention applications,
    each over its full S x S, causal masking not discounted; the
    recurrent families' scans not counted)."""
    cfg = lm.cfg
    t = batch * seq
    attn = {"hybrid": -(-cfg.n_layers // cfg.attn_every),
            "xlstm": 0}.get(cfg.family, cfg.n_layers)
    ac = cfg.attn_config()
    return (roofline.model_flops(lm.num_params(), t,
                                 n_active_params=lm.num_active_params())
            + 12.0 * attn * ac.num_heads * ac.head_dim * seq * t)


def train_state_pspecs(lm: LM, mesh, params_shape=None, ef: bool = False):
    """The sharded TrainState's specs belong to the mesh slice."""
    raise NotImplementedError(
        "train_state_pspecs shards the train state over a device mesh: not "
        "ported yet (ROADMAP.md, item 14b)")


def _grads(lm: LM, params: Dict[str, torch.Tensor], batch: Batch
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                      Dict[str, torch.Tensor]]:
    loss, aux = lm.loss(batch)
    ps = list(params.values())
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = {k: (torch.zeros_like(p) if g is None else g)
             for (k, p), g in zip(params.items(), gs)}
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(lm: LM, adamw: AdamWConfig, sched: ScheduleConfig,
                    accum_steps: int = 1
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """(state, batch) -> (state', metrics): ``loss``, ``step``,
    ``grad_norm``, ``lr`` and, with ``accum_steps == 1``, ``ce`` and
    ``aux``.  ``batch`` holds tensors on the LM's device."""

    def train_step(state: TrainState, batch: Batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state.params
        if accum_steps == 1:
            loss, aux, grads = _grads(lm, params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum_steps:
                raise ValueError(f"batch {n} does not split into "
                                 f"{accum_steps} microbatches")
            micro = {k: v.chunk(accum_steps) for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=lm.device)
            keys = list(params)
            for i in range(accum_steps):
                l, _, g = _grads(lm, params, {k: v[i]
                                              for k, v in micro.items()})
                torch._foreach_add_([grads[k] for k in keys],
                                    [g[k].float() for k in keys])
                loss = loss + l
            torch._foreach_div_(list(grads.values()), float(accum_steps))
            loss = loss / accum_steps
            aux = {}
        lr = lr_at(state.opt.step, sched)
        new_params, new_opt, om = apply_updates(params, grads, state.opt,
                                                lr, adamw)
        metrics = {"loss": loss, "step": state.step, **om}
        metrics.update({k: v for k, v in aux.items() if k != "ntok"})
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
