"""The dense family (Qwen2): pre-norm blocks of GQA attention with q/k/v
biases and a SwiGLU MLP.

Every family file holds the same names: the leaves of a layer as the
port names and lays them out, the plain forward of a layer, the sizes
the port's config takes beyond the shared ones, and the counts the
yardstick's arithmetic needs.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from cellbench.reference import model as R

#: the plain reference follows the training step (one row at a time)
TRAINS = True
#: leaves held in float32 in a bfloat16 model
FP32_LEAVES: Tuple[str, ...] = ()


def layer_leaves(cfg: dict, i: int) -> List[tuple]:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    p = f"blocks.{i}."
    return R.attention_leaves(cfg, p) + [
        (p + "ln2.scale", (d,), "ones"),
        (p + "mlp.w_gate", (d, ff), "normal"),
        (p + "mlp.w_up", (d, ff), "normal"),
        (p + "mlp.w_down", (ff, d), "normal")]


def mlp_active_params(cfg: dict) -> int:
    """Weights of a layer past its attention that one token multiplies."""
    return 3 * cfg["hidden_size"] * cfg["intermediate_size"]


def idle_layer_params(cfg: dict) -> int:
    """Weights of a layer that a token does not touch."""
    return 0


def lm_kwargs(cfg: dict, base) -> dict:
    """The port's ``LMConfig`` fields for the family's own sizes."""
    return dict(d_ff=cfg["intermediate_size"])


def prefill_calls(past: int, prompt_len: int) -> list:
    """The calls a prefill's tokens shared (a dense layer does not care)."""
    return []


def layer_forward(p: Dict[str, torch.Tensor], xs: List[torch.Tensor],
                  cfg: dict, i: int, prec: str,
                  calls: Sequence[Sequence[Tuple[int, int]]]
                  ) -> List[torch.Tensor]:
    pre, eps = f"blocks.{i}.", cfg["rms_norm_eps"]
    xs = [x + R.attention(p, R.rms_norm(x, p[pre + "ln1.scale"], eps), cfg,
                          pre + "attn.", prec) for x in xs]
    lens = [x.shape[0] for x in xs]
    x = torch.cat(xs)
    hn = R.rms_norm(x, p[pre + "ln2.scale"], eps)
    x = x + R.swiglu(hn, p[pre + "mlp.w_gate"], p[pre + "mlp.w_up"],
                     p[pre + "mlp.w_down"], prec)
    return list(x.split(lens))
