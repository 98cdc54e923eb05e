"""Weights drawn from the seed, the same for the program and the reference.

A configuration's leaves fall into groups: the embedding, one group a
layer (its leaves listed by the family, ``reference/<family>.py``), and
the head (final norm and, untied, the output matrix).  Each
group has a generator of its own, seeded from the run's seed and the
group's name, so the reference can draw layer ``i`` again alone, layer by
layer, long after the program's copy is gone.  A group's drawn leaves of
one dtype come from ONE ``normal_`` call over a flat buffer on the
device; each leaf is a view of it.  Every matrix, bias and the embedding
is N(0, initializer_range^2), as the source's ``_init_weights`` draws its
linear layers; norm scales are 1.

Leaf names and layouts are the port's (``blocks.{i}.attn.wq`` is
``[d, H, Dh]``), so the loader needs no transposes; nothing here imports
the port.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Tuple

import torch

from cellbench.bench import family

Leaf = Tuple[str, Tuple[int, ...], str]       # name, shape, "normal" | "ones"

__all__ = ["groups", "draw_group", "draw_all", "group_seed", "leaf_dtype"]

def groups(cfg: dict) -> List[Tuple[str, List[Leaf]]]:
    """The configuration's leaf groups, in draw order."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    out = [("embed", [("embed.table", (v, d), "normal")])]
    fam = family(cfg)
    out += [(f"layer.{i}", fam.layer_leaves(cfg, i))
            for i in range(cfg["num_hidden_layers"])]
    head: List[Leaf] = [("final_norm.scale", (d,), "ones")]
    if not cfg["tie_word_embeddings"]:
        head.append(("lm_head.w", (d, v), "normal"))
    out.append(("head", head))
    return out


def group_seed(seed: int, group: str) -> int:
    """A 63-bit generator seed for ``group`` of the run ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def leaf_dtype(cfg: dict, name: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf is held in when the model's is ``dtype``: float32
    for the leaves the family keeps so (``FP32_LEAVES``)."""
    keep = family(cfg).FP32_LEAVES
    return torch.float32 if name.rsplit(".", 1)[-1] in keep else dtype


def draw_group(cfg: dict, seed: int, group: str, leaves: List[Leaf],
               device: torch.device, dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """The leaves of ``group``: one ``normal_`` call per dtype over a flat
    buffer, each leaf a view of it; ``ones`` leaves filled with 1."""
    std = float(cfg["initializer_range"])
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    out: Dict[str, torch.Tensor] = {}
    by_dtype: Dict[torch.dtype, List[Leaf]] = {}
    for leaf in leaves:
        dt = leaf_dtype(cfg, leaf[0], dtype)
        if leaf[2] == "ones":
            out[leaf[0]] = torch.ones(leaf[1], dtype=dt, device=device)
        else:
            by_dtype.setdefault(dt, []).append(leaf)
    for dt, ls in by_dtype.items():
        n = sum(_numel(s) for _, s, _ in ls)
        flat = torch.empty(n, dtype=dt, device=device)
        flat.normal_(0.0, std, generator=gen)
        off = 0
        for name, shape, _ in ls:
            out[name] = flat[off:off + _numel(shape)].view(shape)
            off += _numel(shape)
    return out


def draw_all(cfg: dict, seed: int, device: torch.device,
             dtype: torch.dtype) -> Iterator[Dict[str, torch.Tensor]]:
    """Every group's leaves, one group at a time."""
    for group, leaves in groups(cfg):
        yield draw_group(cfg, seed, group, leaves, device, dtype)


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
