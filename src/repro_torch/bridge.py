"""Parameter bridge: the JAX package's params tree -> the port's weights.

The JAX ``LM.init`` returns a nested dict whose per-layer leaves are
stacked on a leading layers axis (``blocks/attn/wq`` is ``[L, d, H, Dh]``,
``mamba/in_proj`` is ``[L, d, E]``).  The port keeps one module per layer
with the same leaf names, so the bridge only flattens the tree to dotted
names and splits the layers axis — no transposes, because both sides keep
the same weight layouts.  Leaves arrive as numpy arrays (the
tests convert with ``jax.device_get``); this module never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.models.lm import PORTED_FAMILIES, LMConfig
from repro_torch.models.ssm import FP32_LEAVES

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

    Stacked subtrees (``blocks.*`` of the dense family, ``mamba.*`` of the
    hybrid) are split over their leading ``n_layers`` axis into
    ``blocks.{i}.*`` / ``mamba.{i}.*``; everything else (the hybrid's one
    ``shared_attn`` block included) is copied as is.  Mamba2's
    :data:`~repro_torch.models.ssm.FP32_LEAVES` stay fp32 whatever
    ``dtype`` is."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    stacked = "blocks." if cfg.family == "dense" else "mamba."
    state: Dict[str, torch.Tensor] = {}

    def put(name: str, arr: np.ndarray) -> None:
        fp32 = (name.startswith("mamba.")
                and name.rsplit(".", 1)[-1] in FP32_LEAVES)
        state[name] = torch.from_numpy(arr).to(
            device=device, dtype=torch.float32 if fp32 else dtype)

    for name, leaf in _flatten(np_params).items():
        arr = np.array(leaf, dtype=np.float32)          # a writable copy
        if name.startswith(stacked):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} is "
                                 f"not n_layers={cfg.n_layers}")
            rest = name[len(stacked):]
            for i in range(cfg.n_layers):
                put(f"{stacked}{i}.{rest}", arr[i].copy())
        else:
            put(name, arr)
    return state
