"""The program under test as every cell builds it: the port's ``LM`` at a
configuration's widths, filled with the seed's weights.

The sizes the port's config takes beyond the shared ones come from the
configuration's family, ``reference/<family>.py::lm_kwargs``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cellbench import weights as W
from cellbench.bench import family

__all__ = ["lm_config", "build_lm"]


def lm_config(cfg: dict):
    """The port's ``LMConfig`` for a configuration file: the port's
    registered config of that name (its defaults for what the file does
    not state, such as its attention chunking) with every size the file
    states."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LMConfig
    try:
        base = get_arch(cfg["name"]).config
    except KeyError:
        base = LMConfig(name=cfg["name"], family=cfg["family"], vocab=0,
                        d_model=0, n_layers=0, num_heads=0, num_kv_heads=0,
                        d_ff=0)
    kw = dict(name=cfg["name"], family=cfg["family"],
              vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
              n_layers=cfg["num_hidden_layers"],
              num_heads=cfg["num_attention_heads"],
              num_kv_heads=cfg["num_key_value_heads"],
              qkv_bias=bool(cfg.get("qkv_bias")),
              tie_embeddings=bool(cfg["tie_word_embeddings"]),
              rope_theta=float(cfg["rope_theta"]),
              norm_eps=float(cfg["rms_norm_eps"]), head_dim=0)
    kw.update(family(cfg).lm_kwargs(cfg, base))
    return dataclasses.replace(base, **kw)


def build_lm(cfg: dict, seed: int, device: torch.device,
             dtype: torch.dtype, param_dtype: Optional[torch.dtype] = None,
             features=None):
    """The port's LM with the seed's weights (every parameter set once)."""
    from repro_torch.models.lm import LM
    lm = LM(lm_config(cfg), dtype, device, features=features,
            param_dtype=param_dtype)
    params = dict(lm.named_parameters())
    seen = set()
    with torch.no_grad():
        for group in W.draw_all(cfg, seed, device, param_dtype or dtype):
            for name, t in group.items():
                if name not in params or params[name].shape != t.shape:
                    raise ValueError(f"the port has no leaf {name} "
                                     f"{tuple(t.shape)}")
                params[name].copy_(t)
                seen.add(name)
            del group
    missing = sorted(set(params) - seen)
    if missing:
        raise ValueError(f"leaves the draw does not set: {missing[:5]}")
    return lm
