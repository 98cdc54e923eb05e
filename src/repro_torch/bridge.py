"""Parameter bridge: the JAX package's params tree -> the port's weights.

The JAX ``LM.init`` returns a nested dict whose per-layer leaves are
stacked on a leading layers axis (``blocks/attn/wq`` is ``[L, d, H, Dh]``,
``blocks/moe/w_gate`` is ``[L, E, d, f]``, ``mamba/in_proj`` is
``[L, d, E]``, ``mlstm/wq`` is ``[L/2, di, H, dh]``:
the xlstm family stacks its mLSTM and sLSTM blocks over its
``n_layers // 2`` pairs; the encdec family its ``encoder`` over
``enc_layers`` and its ``decoder`` over ``n_layers``).  LayerNorm's
``bias`` leaves map across like any other.  The port keeps one module per
layer with the same leaf names, so the bridge only flattens the tree to dotted
names and splits the layers axis — no transposes, because both sides keep
the same weight layouts.  Leaves arrive as numpy arrays (the
tests convert with ``jax.device_get``); this module never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.models import moe, ssm, xlstm
from repro_torch.models.lm import PORTED_FAMILIES, LMConfig

__all__ = ["params_from_jax"]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def params_from_jax(np_params: Mapping[str, Any], cfg: LMConfig,
                    dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device] = "cpu"
                    ) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``LM(cfg, dtype, device)`` built from the JAX
    params tree (numpy leaves); load it with ``lm.load_state_dict``.

    Stacked subtrees (``blocks.*`` of the dense, moe and vlm families,
    ``mamba.*`` of the hybrid, ``mlstm.*`` and ``slstm.*`` of the xlstm,
    ``encoder.*`` and ``decoder.*`` of the encdec) are split over their
    leading axis (``n_layers``; ``n_layers // 2`` pairs for the xlstm
    family; ``enc_layers`` for the encoder) into ``blocks.{i}.*`` /
    ``mamba.{i}.*`` / ``mlstm.{i}.*`` / ``encoder.{i}.*``; everything
    else (the hybrid's one ``shared_attn`` block, the encdec's
    ``enc_final_norm`` included) is copied as is.  Mamba2's
    :data:`~repro_torch.models.ssm.FP32_LEAVES`, the xLSTM blocks' :data:`~repro_torch.models.xlstm.FP32_LEAVES` and
    the MoE layers' :data:`~repro_torch.models.moe.FP32_LEAVES` (router
    and shared gate) stay fp32 whatever ``dtype`` is."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    n = cfg.n_layers
    depths, fp32_leaves = {
        "dense": ({"blocks.": n}, ()),
        "moe": ({"blocks.": n}, moe.FP32_LEAVES),
        "vlm": ({"blocks.": n}, ()),
        "hybrid": ({"mamba.": n}, ssm.FP32_LEAVES),
        "xlstm": ({"mlstm.": n // 2, "slstm.": n // 2}, xlstm.FP32_LEAVES),
        "encdec": ({"encoder.": cfg.enc_layers or n, "decoder.": n}, ()),
    }[cfg.family]
    prefixes = tuple(depths)
    state: Dict[str, torch.Tensor] = {}

    def put(name: str, arr: np.ndarray) -> None:
        fp32 = (name.startswith(prefixes)
                and name.rsplit(".", 1)[-1] in fp32_leaves)
        state[name] = torch.from_numpy(arr).to(
            device=device, dtype=torch.float32 if fp32 else dtype)

    for name, leaf in _flatten(np_params).items():
        arr = np.array(leaf, dtype=np.float32)          # a writable copy
        stacked = next((p for p in prefixes if name.startswith(p)), None)
        if stacked is None:
            put(name, arr)
            continue
        depth = depths[stacked]
        if arr.shape[0] != depth:
            raise ValueError(f"{name}: leading axis {arr.shape[0]} is not "
                             f"the {depth} stacked layers of "
                             f"{cfg.family!r} (n_layers={cfg.n_layers})")
        rest = name[len(stacked):]
        for i in range(depth):
            put(f"{stacked}{i}.{rest}", arr[i].copy())
    return state
