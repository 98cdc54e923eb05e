"""AdamW with global-norm clipping and optional int8 error-feedback grad
compression (see compress.py).

Port of ``repro/optim/adamw.py``, step for step: gradients to fp32,
error feedback when asked, clipping by the global norm, bias-corrected
moments (stored in ``moment_dtype``), the decay added to the update,
``lr * u`` subtracted in fp32 and the result cast to the parameter's
dtype.  ``torch.optim.AdamW`` is a different function: it decays the
parameter before the step (``p *= 1 - lr * wd``) and knows no clipping.

Trees are dicts of tensors named as the LM's parameters
(``dict(lm.named_parameters())``).  :func:`apply_updates` runs as
multi-tensor loops (``torch._foreach_*``: one launch covers many tensors)
and updates parameters and moments IN PLACE, the counterpart of the
reference's donated state; it returns the same dicts.  The step counter,
the rate and the clip scale stay 0-d device tensors, so a step makes no
host sync.

**Which leaves decay.**  The reference decays a leaf when ``p.ndim >= 2``
and stacks every per-layer leaf on a leading layers axis, so each stacked
norm scale ``[L, d]`` and bias ``[L, H, Dh]`` decays while ``final_norm``
and the hybrid's unstacked ``shared_attn`` norms do not.  The port keeps
one tensor a layer, so the rank in the rule is the reference's: the port
rank plus one under a stacked subtree (:func:`decays`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.bridge import reference_leaf
from repro_torch.optim.compress import (CompressState, compress_decompress,
                                        init_compress_state)

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "apply_updates",
           "global_norm", "decays"]

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compression: str = "none"    # none | int8_ef
    moment_dtype: str = "float32"     # float32 | bfloat16 (halves m + v)


class OptState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor                # 0-d int32, on the params' device
    ef: Optional[CompressState] = None   # error-feedback residuals


def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    if cfg.moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"moment_dtype {cfg.moment_dtype!r} not in "
                         f"{tuple(_MOMENT_DTYPES)}")
    return _MOMENT_DTYPES[cfg.moment_dtype]


def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: AdamWConfig) -> OptState:
    mdt = _moment_dtype(cfg)
    dev = next(iter(params.values())).device

    def zeros():
        return {k: torch.zeros_like(p, dtype=mdt, requires_grad=False)
                for k, p in params.items()}

    ef = (init_compress_state(params) if cfg.grad_compression == "int8_ef"
          else None)
    return OptState(m=zeros(), v=zeros(),
                    step=torch.zeros((), dtype=torch.int32, device=dev),
                    ef=ef)


def global_norm(tree: Any, layout: Any = None,
                names: Optional[list] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, a 0-d fp32 tensor.  The
    sums accumulate in fp64: the CPU's fp32 norm kernel loses 0.27% on
    one 136 M-element leaf (qwen2-0.5b's embedding), where the card's
    and the reference's fp32 reductions do not.  With a mesh ``layout``
    the leaves are slices named ``names`` (the tree's keys by default),
    summed over the axes each is split on (see the module note)."""
    if isinstance(tree, Mapping):
        names = names or list(tree)
        leaves = list(tree.values())
    else:
        leaves = list(tree)
    if layout is not None:
        sq = layout.sq_norms(names, leaves)
        return layout.over_splits(names, sq, "sum").sum().sqrt().float()
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float64)
    return torch.stack(norms).square().sum().sqrt().float()


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether ``name`` decays: the reference's ``p.ndim >= 2`` on the
    reference leaf (the port rank plus one under a stacked subtree)."""
    stacked = reference_leaf(name)[1] is not None
    return p.dim() + int(stacked) >= 2


def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], opt: OptState,
                  lr: torch.Tensor, cfg: AdamWConfig, layout: Any = None
                  ) -> Tuple[Dict[str, torch.Tensor], OptState,
                             Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, opt', metrics).  With
    a mesh ``layout`` every tree holds this rank's slices."""
    names = list(params)
    g = [grads[k].float() for k in names]
    ef = opt.ef
    if cfg.grad_compression == "int8_ef":
        gd, ef = compress_decompress(dict(zip(names, g)), ef, layout)
        g = [gd[k] for k in names]
    gnorm = global_norm(g, layout, names)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    g = torch._foreach_mul(g, scale)

    step = opt.step + 1
    sf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, sf)
    b2c = 1.0 - torch.pow(cfg.b2, sf)

    with torch.no_grad():
        m = [opt.m[k] for k in names]
        v = [opt.v[k] for k in names]
        m32 = [t.float() for t in m]          # the moments themselves
        v32 = [t.float() for t in v]          # when they are fp32
        torch._foreach_mul_(m32, cfg.b1)
        torch._foreach_add_(m32, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(v32, cfg.b2)
        torch._foreach_addcmul_(v32, g, g, value=1 - cfg.b2)
        if m32[0] is not m[0]:                # bf16: store, then reread
            torch._foreach_copy_(m, m32)
            torch._foreach_copy_(v, v32)
            m32 = [t.float() for t in m]
            v32 = [t.float() for t in v]
        u = torch._foreach_div(m32, b1c)                       # mhat
        den = torch._foreach_div(v32, b2c)                     # vhat
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        torch._foreach_div_(u, den)
        del den
        p32 = [params[k].float() for k in names]
        if cfg.weight_decay:
            dec = [i for i, k in enumerate(names) if decays(k, params[k])]
            if dec:
                torch._foreach_add_([u[i] for i in dec],
                                    [p32[i] for i in dec],
                                    alpha=cfg.weight_decay)
        torch._foreach_mul_(u, lr)
        torch._foreach_sub_(p32, u)
        low = [i for i, k in enumerate(names) if p32[i] is not params[k]]
        if low:
            torch._foreach_copy_([params[names[i]] for i in low],
                                 [p32[i] for i in low])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(opt.m, opt.v, step, ef), metrics
