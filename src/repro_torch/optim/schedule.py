"""Learning-rate schedules (pure functions of the step counter).

Port of ``repro/optim/schedule.py``.  :func:`lr_at` is tensor in, tensor
out: the step counter stays on the device and so does the rate, so a
train step reads no number back to the host for it.  The arithmetic is
the reference's, in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import torch

__all__ = ["ScheduleConfig", "lr_at"]


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_ratio: float = 0.1
    kind: str = "cosine"          # cosine | linear | constant


def lr_at(step: Union[torch.Tensor, int], cfg: ScheduleConfig
          ) -> torch.Tensor:
    """The rate at ``step`` (a 0-d tensor, or an int for a host value),
    as a 0-d fp32 tensor on the step's device: linear warmup to
    ``peak_lr`` over ``warmup_steps``, then ``kind``'s decay to
    ``min_ratio * peak_lr`` at ``total_steps``."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.kind == "cosine":
        decay = cfg.min_ratio + (1 - cfg.min_ratio) * 0.5 * \
            (1 + torch.cos(math.pi * frac))
    elif cfg.kind == "linear":
        decay = cfg.min_ratio + (1 - cfg.min_ratio) * (1 - frac)
    else:
        decay = torch.ones_like(s)
    return torch.where(s < cfg.warmup_steps, warm, cfg.peak_lr * decay)
