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

Under a ``torch.profiler`` session the step records its spans
(:func:`repro_torch.core.marker.span`): ``train.step`` around the whole
call, ``train.optimizer`` from the rate through the update (the global
norm and the clip included), and the model's own inside ``LM.loss``.

**On a mesh** (``make_train_step(..., layout=)``; ``repro/train/step.py:
45-55`` and the GSPMD step the reference jits with ``state_shardings``).
The LM is a rank's tensor-parallel one (``LM(tp=, dp=)``) and the state
holds this rank's slices under the state's specs
(:func:`train_state_pspecs`, fit to what the LM holds:
:class:`StateLayout`).  A leaf split over ``data`` too (the reference's
FSDP rule, ``embed -> data``) is gathered over ``data`` into the LM's
parameter for the step and released after it; every other leaf of the
state IS the LM's parameter.  The step then runs as above on the rank's
rows (the loss is the global batch's), sums every gradient over the data
axis in one flat reduce, keeps the slice of a split leaf, and updates
the slices (AdamW's global norm and int8 scales over the mesh:
:mod:`repro_torch.optim.adamw`).
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.core import roofline
from repro_torch.core.marker import span
from repro_torch.models.lm import LM
from repro_torch.optim import (AdamWConfig, OptState, ScheduleConfig,
                               apply_updates, init_opt_state, lr_at)

__all__ = ["TrainState", "make_train_step", "init_train_state",
           "train_state_pspecs", "model_flops", "StateLayout"]

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


def train_state_pspecs(lm: LM, mesh: Any, params_shape=None,
                       ef: bool = False) -> TrainState:
    """Specs for the whole TrainState (``repro/train/step.py:45-55``):
    the moments (and the error-feedback residuals with ``ef``) shard like
    the params, the step counters are replicated (``()``).  ``lm`` is the
    whole model (its shapes feed the divisibility guard unless
    ``params_shape`` is given)."""
    pspec = lm.param_pspecs(mesh, params_shape)
    return TrainState(params=pspec,
                      opt=OptState(m=pspec, v=pspec, step=(),
                                   ef=pspec if ef else None),
                      step=())


def _names(entry: Any) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _drop(spec: Sequence[Any], axis: str) -> Tuple[Any, ...]:
    """``spec`` without ``axis``."""
    out = []
    for entry in spec:
        names = tuple(a for a in _names(entry) if a != axis)
        out.append(None if not names else
                   names[0] if len(names) == 1 else names)
    return tuple(out)


class StateLayout:
    """Where each leaf of a sharded train state lives on this rank, and
    the moves a step makes (see the module note).

    ``lm`` is the rank's tensor-parallel LM on its device; ``specs`` the
    params' specs over the whole model (``train_state_pspecs(...).
    params``), fit here to what ``lm`` holds (``LM.rank_pspecs``: a leaf
    the LM keeps whole on the model axis, the MoE router or the sLSTM
    recurrence, is kept whole in the state too; Mamba2's ``in_proj`` and
    the mLSTM's leaves are cut by heads, ``LM.model_splits``, through
    ``LM.expand_splits``/``contract_splits``); ``full_shapes`` the whole
    model's parameters (anything with a ``.shape``), keyed by name."""

    def __init__(self, lm: LM, specs: Mapping[str, Any], mesh: Any,
                 full_shapes: Mapping[str, Any]):
        from repro_torch.launch import mesh as mesh_mod
        self.lm = lm
        self.names, self.sizes = mesh_mod.mesh_layout(mesh)
        self.coord = mesh_mod.mesh_coordinate(mesh)
        if self.coord is None:
            raise ValueError("this rank is not in the training mesh: every "
                             "rank of a training world holds a slice")
        self.axes = {a: mesh_mod.axis_of(mesh, a) for a in self.names}
        self.compute = dict(lm.named_parameters())
        self.specs = lm.rank_pspecs({k: specs[k] for k in self.compute},
                                    full_shapes)
        self.splits = lm.model_splits()
        for k, p in self.compute.items():
            whole = torch.empty(full_shapes[k].shape, device="meta")
            want = tuple(self.cut(k, whole, skip=("data",)).shape)
            if want != tuple(p.shape):
                raise ValueError(
                    f"{k}: the state's spec {self.specs[k]} cuts "
                    f"{tuple(full_shapes[k].shape)} into {want} on the "
                    f"model axis, the rank's LM holds {tuple(p.shape)}")
        #: leaves split over an axis besides ``model``: gathered for a step
        self.gathered = [k for k in self.compute
                         if set(self.split_axes(k)) - {"model"}]

    def split_axes(self, name: str) -> Tuple[str, ...]:
        """The mesh axes leaf ``name`` is split on."""
        return tuple(a for e in self.specs[name] for a in _names(e)
                     if self.sizes[self.names.index(a)] > 1)

    def cut(self, name: str, full: torch.Tensor,
            skip: Sequence[str] = ()) -> torch.Tensor:
        """This rank's slice of the whole leaf ``full`` (of a model-axis
        block with ``skip=("model",)``)."""
        from repro_torch.ft.elastic import local_slice
        spec = self.specs[name]
        for a in skip:
            spec = _drop(spec, a)
        if "model" not in skip and name in self.splits:
            full = self.lm.expand_splits({name: full})[name]
        return local_slice(full, spec, self.names, self.sizes, self.coord)

    def init_params(self, full: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """The state's params from the whole model's weights ``full``: a
        leaf the step gathers is a slice of its own; every other leaf is
        the LM's parameter, filled in place."""
        out = {}
        with torch.no_grad():
            for k, p in self.compute.items():
                piece = self.cut(k, full[k])
                if k in self.gathered:
                    out[k] = piece.to(p.device, p.dtype).contiguous()
                    p.data = p.data.new_empty(0)          # transient
                else:
                    p.copy_(piece)
                    out[k] = p
        return out

    def gather(self, params: Mapping[str, torch.Tensor]) -> None:
        """Fill the LM's gathered parameters from the state's slices (a
        collective over the axes each is split on besides ``model``)."""
        from repro_torch.ft.elastic import gather_slice
        with torch.no_grad():
            for k in self.gathered:
                self.compute[k].data = gather_slice(
                    params[k], self.specs[k], self.axes, skip=("model",))

    def release(self) -> None:
        """Free the LM's gathered parameters until the next step."""
        for k in self.gathered:
            p = self.compute[k]
            p.data = p.data.new_empty(0)

    def reduce_grads(self, grads: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Every gradient summed over the data axis (one flat reduce a
        dtype), and a gathered leaf's cut to this rank's slice."""
        dp = self.lm.dp
        out = dict(grads)
        if dp is not None and dp.size > 1:
            by_dtype: Dict[torch.dtype, list] = {}
            for k, g in grads.items():
                by_dtype.setdefault(g.dtype, []).append(k)
            for keys in by_dtype.values():
                flat = dp.all_reduce(torch.cat(
                    [grads[k].reshape(-1) for k in keys]))
                for k, piece in zip(keys, flat.split(
                        [grads[k].numel() for k in keys])):
                    out[k] = piece.view_as(grads[k])
        for k in self.gathered:
            out[k] = self.cut(k, out[k], skip=("model",)).contiguous()
        return out

    def over_splits(self, names: Sequence[str], values: torch.Tensor,
                    op: str) -> torch.Tensor:
        """``values`` (one a leaf, in ``names`` order) summed (or maxed)
        over the axes each leaf is split on: a collective an axis over
        the leaves split on it."""
        out = values.clone()
        for a in self.names:
            rows = [i for i, k in enumerate(names) if a in self.split_axes(k)]
            if rows:
                idx = torch.tensor(rows, device=values.device)
                out[idx] = self.axes[a].all_reduce(out[idx], op)
        return out

    def full(self, tree: Mapping[str, torch.Tensor], first: bool = False
             ) -> Optional[Dict[str, torch.Tensor]]:
        """Whole leaves on the host from this rank's slices (a collective
        over every axis a leaf is split on).  With ``first`` only the
        mesh's first rank gets them (a gather); the others get None."""
        from repro_torch.ft.elastic import gather_slice
        out = {k: gather_slice(t.detach(), self.specs[k], self.axes,
                               first=first)
               for k, t in tree.items()}
        if first and any(self.coord):
            return None
        return self.lm.contract_splits({k: v.cpu() for k, v in out.items()})

    def sq_norms(self, names: Sequence[str],
                 leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        """Each slice's sum of squares (fp64), a leaf of
        :meth:`LM.model_splits` counting its copies of the whole parts
        only at model index 0, so :meth:`over_splits` sums every element
        of the whole leaf once."""
        from repro_torch.models.layers import whole_part_mask
        tp = self.lm.tp
        out = []
        for k, t in zip(names, leaves):
            sp = self.splits.get(k)
            if sp is not None and len(sp.parts) > 1 and tp.index:
                t = t * whole_part_mask(sp, tp.size, t.shape).to(t.device)
            out.append(t)
        return torch.stack(torch._foreach_norm(out, 2,
                                               dtype=torch.float64)).square()


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
                    accum_steps: int = 1,
                    layout: Optional[StateLayout] = None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """(state, batch) -> (state', metrics): ``loss``, ``step``,
    ``grad_norm``, ``lr`` and, with ``accum_steps == 1``, ``ce`` and
    ``aux``.  ``batch`` holds tensors on the LM's device (on a mesh,
    ``layout``, this rank's rows; see the module note)."""

    def train_step(state: TrainState, batch: Batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("train.step"):
            return _step(state, batch)

    def _step(state: TrainState, batch: Batch
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state.params
        if layout is not None:
            layout.gather(params)
            params = layout.compute
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
        if layout is not None:
            layout.release()
            grads = layout.reduce_grads(grads)
        with span("train.optimizer"):
            lr = lr_at(state.opt.step, sched)
            new_params, new_opt, om = apply_updates(
                state.params, grads, state.opt, lr, adamw, layout)
        metrics = {"loss": loss, "step": state.step, **om}
        metrics.update({k: v for k, v in aux.items() if k != "ntok"})
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
