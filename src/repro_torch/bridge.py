"""Parameter bridge: the JAX package's params tree <-> the port's weights.

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

:func:`params_to_jax` is the inverse: it stacks the per-layer tensors of a
``state_dict`` (or of any tree named like one: the optimizer's moments
and error-feedback residuals) back onto the leading layers axis, as
numpy.  :func:`stack_to_jax` does the same in torch, keeping bf16, for
the checkpoint writer, and :func:`reference_leaf` names the reference
leaf a port tensor belongs to (the optimizer's decay rule and int8 scales
follow the reference's leaves, not the port's tensors).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models import moe, ssm, xlstm
from repro_torch.models.lm import PORTED_FAMILIES, LMConfig

__all__ = ["params_from_jax", "params_to_jax", "stack_to_jax",
           "reference_leaf", "group_by_leaf", "leaf_tree", "STACKED"]

#: the subtrees the reference stacks on a leading layers axis (the port
#: keeps one module a layer under the same name: ``blocks.{i}.*``)
STACKED = ("blocks", "mamba", "mlstm", "slstm", "encoder", "decoder")


def reference_leaf(name: str) -> Tuple[str, Optional[int]]:
    """(the reference leaf's dotted name, the layer index or None) of the
    port tensor ``name``: ``blocks.3.attn.wq`` -> (``blocks.attn.wq``,
    3); an unstacked name (``embed.table``, ``shared_attn.ln1.scale``)
    is its own leaf."""
    head, _, rest = name.partition(".")
    if head in STACKED:
        idx, _, leaf = rest.partition(".")
        if idx.isdigit():
            return f"{head}.{leaf}", int(idx)
    return name, None


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


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, leaf in flat.items():
        node = out
        *parents, last = name.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def group_by_leaf(tensors: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Union[torch.Tensor, List[torch.Tensor]]]:
    """Port-named tensors grouped by reference leaf (dotted names): a
    stacked leaf's per-layer tensors as a list in layer order, any other
    leaf's tensor as is."""
    groups: Dict[str, Dict[Optional[int], torch.Tensor]] = {}
    for name, t in tensors.items():
        leaf, layer = reference_leaf(name)
        groups.setdefault(leaf, {})[layer] = t
    out: Dict[str, Union[torch.Tensor, List[torch.Tensor]]] = {}
    for leaf, by_layer in groups.items():
        if None in by_layer:
            out[leaf] = by_layer[None]
            continue
        n = len(by_layer)
        if sorted(by_layer) != list(range(n)):
            raise ValueError(f"{leaf}: layers {sorted(by_layer)} are not "
                             f"0..{n - 1}")
        out[leaf] = [by_layer[i] for i in range(n)]
    return out


def leaf_tree(tensors: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """:func:`group_by_leaf` nested as the reference's tree (dicts by
    name part), each leaf a tensor or a stacked leaf's list of tensors."""
    return _nest(group_by_leaf(tensors))


def stack_to_jax(tensors: Mapping[str, torch.Tensor]
                 ) -> Dict[str, Any]:
    """The reference's nested tree of torch tensors from port-named
    tensors: each stacked subtree's per-layer tensors stacked on a new
    leading axis in layer order (on their device, in their dtype),
    everything else as is."""
    return _nest({leaf: (torch.stack([t.detach() for t in g])
                         if isinstance(g, list) else g)
                  for leaf, g in group_by_leaf(tensors).items()})


def params_to_jax(state_dict: Mapping[str, torch.Tensor], cfg: LMConfig
                  ) -> Dict[str, Any]:
    """The JAX params tree (numpy copies, float32 where the tensor is a
    float; bf16 widens exactly) from a port ``state_dict`` of ``cfg``, or
    from any tree named like one (``OptState.m``/``v``/``ef``).  The
    inverse of :func:`params_from_jax`."""
    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        t = node.detach().cpu()
        return np.array((t.float() if t.is_floating_point() else t).numpy())

    tree = walk(stack_to_jax(state_dict))
    n = cfg.n_layers
    depths = {"blocks": n, "mamba": n, "mlstm": n // 2, "slstm": n // 2,
              "encoder": cfg.enc_layers or n, "decoder": n}
    for head, depth in depths.items():
        for name, leaf in _flatten(tree.get(head, {}), head + ".").items():
            if leaf.shape[0] != depth:
                raise ValueError(f"{name}: {leaf.shape[0]} layers, the "
                                 f"config has {depth}")
    return tree
