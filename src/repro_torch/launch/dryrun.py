"""Multi-pod dry run: a shape-and-count walk of one rank of every
(arch x shape x mesh) cell.

Port of ``repro/launch/dryrun.py``.  The JAX dry run lowers and compiles
each cell's real step function for the production mesh of 256 (or 512)
host devices and reads ``memory_analysis()``, ``cost_analysis()`` and the
HLO.  Torch has no such compiler, so the port walks ONE rank of the
production mesh on the ``meta`` device, which allocates nothing and
launches nothing:

* the full ``LM`` (its parameter count) and the rank's tensor-parallel
  ``LM`` (``tp``/``dp`` of the mesh's shape, ``mesh_axes(multi_pod)``:
  ``(16, 16)`` or ``(2, 16, 16)``) are built on ``meta``;
* a **counting axis** (:class:`CountingAxis`) stands in for each mesh
  axis: the same ``size`` and ``index`` as the rank's, collectives that
  return meta tensors of the right shape and declare their wire bytes
  and counts by kind (:func:`repro_torch.core.events.record_collective`,
  the events the ``ICI`` group reads; the links are NVLink);
* the cell's real entry point runs on the rank's rows of
  :func:`repro_torch.configs.input_specs`: the train step
  (``make_train_step`` over a ``StateLayout``: the FSDP gathers, forward,
  backward, the gradient reduce and AdamW) under :data:`TRAIN_POLICY`,
  ``LM.prefill``, or ``LM.decode_step``;
* FLOPs and bytes are the port's declared events (each kernel's and
  ``LM._declare_ops``), the counts the perfctr groups read; on ``meta``
  the registry sends every kernel family to its plain version, which
  declares the same work;
* argument bytes are exact: the rank's slices of the parameters and the
  train or decode state, cut by the specs (``LM.rank_pspecs``, through
  ``fit_spec``; the prefill and decode state by ``LM.state_pspecs``, the
  reference's ``_state_shardings``: a KV cache's sequence over the mesh
  axes the batch leaves free, ``walk.cache_seq``, its bytes and shape a
  rank ``walk.kv_cache_bytes`` / ``kv_cache_shape``);
  ``peak_bytes_per_device`` and ``temp_bytes`` are an
  ESTIMATE, the most meta bytes live at once during the walk on top of
  the arguments (``memory_analysis.estimated`` names them);
* the XLA-only structure counts (``FUSION_COUNT``, ``WHILE_COUNT``,
  ``HLO_LINES``, ...) have no counterpart: ``structure`` holds the
  rank's kernel launches by registry family instead
  (``registry.tally``: one launch each on the card);
* the record ends with ``core.roofline.analyze`` on the H100's
  ``ChipSpec`` (``t_nvlink`` from the declared wire bytes over NVLink;
  how H100s join across nodes is not modelled).

Where the port departs from the reference's cell, the record says so:

* the port's tensor parallelism splits whole kv heads (and ssm and
  mLSTM heads; under ``kv_shard="headdim"`` each half of the head dim),
  so where the model axis of 16 does not divide them the walk splits the
  weights over the largest divisor that does and the rest of the axis
  holds replicas (``mesh_walked``); the decode state is still cut over
  the whole axis (``cache_seq``), and sequence parallelism splits over
  the walked degree;
* the serving walks (``prefill``, ``decode``) hold each weight's
  model-axis block whole over ``data`` (the port's serving rules,
  ``SERVE_RULES``: no FSDP), with the batch rows split as the
  reference's ``batch -> (pod, data)`` rule splits them;
* every policy knob is walked (``unported`` stays empty):
  ``sequence_parallel`` (``act_seq -> model``, :func:`_rules_for`) and
  ``kv_shard="headdim"`` (the decode cells' ``cache_seq -> data``,
  ``head_dim -> model``); ``accum_steps`` is cut to a divisor of the
  rank's rows where it does not divide them (``accum_walked``); the CLI
  sets only the knobs the walk honours (``--sp``, ``--kv-shard``
  among them);
* the decode state's departures (``LM.state_pspecs``): a rank re-lays
  the recurrent states (the hybrid's Mamba2 state, the mLSTM's) from the
  reference's cut into the heads its blocks compute and back around each
  step, with declared all-gathers, and holds a ``headdim`` cut of the
  head dim in pairs (RoPE's halves);
* no pin strategy: the walk holds one rank at coordinate 0, so a
  device order changes nothing it counts (no ``pin_strategy``, no
  ``pin`` in the record);
* the sLSTM's time loop is walked for one step (every step has the same
  shapes and no collective; the live-bytes estimate then holds one
  step's saved tensors where a run holds ``S``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-1.2b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The walk runs anywhere (no card needed): seconds to a few minutes a
cell (each op on ``meta`` costs ~0.1-0.3 ms of host time).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, get_arch, input_specs, list_archs
from repro_torch.core import events, hwinfo
from repro_torch.core.features import default_features
from repro_torch.core.roofline import analyze, model_flops
from repro_torch.kernels import registry
from repro_torch.launch import cli
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.layers import DEFAULT_RULES, logical_to_mesh
from repro_torch.models.lm import LM, _split_heads

__all__ = ["run_cell", "main", "TRAIN_POLICY", "TrainPolicy",
           "DEFAULT_POLICY", "CountingAxis", "walk", "skip_reason"]

#: the chip every record is analysed for
CHIP = hwinfo.H100_SXM


@dataclasses.dataclass(frozen=True)
class TrainPolicy:
    accum_steps: int = 1
    remat: str = "dots_no_batch"
    sequence_parallel: bool = False       # act_seq -> model
    moment_dtype: str = "float32"
    scan_unroll: int = 1
    attn_softmax: str = "naive"           # "fused": the traffic-lean softmax
    kv_shard: str = "seq"                 # decode cache: "seq" | "headdim"


#: per-arch train policy (``repro/launch/dryrun.py:52-87``)
TRAIN_POLICY: Dict[str, TrainPolicy] = {
    "mistral-large-123b": TrainPolicy(accum_steps=16, remat="full",
                                      sequence_parallel=True,
                                      moment_dtype="bfloat16"),
    "qwen3-moe-235b-a22b": TrainPolicy(accum_steps=16, remat="full",
                                       sequence_parallel=True,
                                       moment_dtype="bfloat16"),
    "qwen2-vl-7b": TrainPolicy(accum_steps=8, sequence_parallel=True),
    "stablelm-3b": TrainPolicy(accum_steps=4),
    "seamless-m4t-medium": TrainPolicy(accum_steps=8, remat="full"),
    "qwen2-moe-a2.7b": TrainPolicy(accum_steps=8, remat="full"),
    "zamba2-1.2b": TrainPolicy(accum_steps=8),
    "qwen2-0.5b": TrainPolicy(accum_steps=8),
}
DEFAULT_POLICY = TrainPolicy(accum_steps=4)

#: the serving walks' rules: the model axis splits, no FSDP over data
SERVE_RULES = DEFAULT_RULES.replace(embed=None)


class CountingAxis(mesh_mod.ModelAxis):
    """A mesh axis with no process group: this rank's ``size`` and
    ``index``, and collectives that return tensors of the right shape
    (meta on a meta input) and declare their wire bytes and counts
    (:func:`repro_torch.core.events.record_collective`), as a
    :class:`~repro_torch.launch.mesh.MeshAxis` does around its real
    collectives.  The autograd pattern is the base class's."""

    def __init__(self, size: int, index: int = 0):
        super().__init__(None, size, index)

    def _reduce(self, x: torch.Tensor, op: str,
                fresh: bool = False) -> torch.Tensor:
        events.record_collective("all-reduce", x.numel() * x.element_size(),
                                 self.size)
        return torch.empty_like(x)

    def _gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] *= self.size
        events.record_collective(
            "all-gather", x.numel() * x.element_size() * self.size,
            self.size)
        return x.new_empty(shape)

    def _reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] //= self.size
        events.record_collective(
            "reduce-scatter", x.numel() * x.element_size() // self.size,
            self.size)
        return x.new_empty(shape)


class _WalkMesh:
    """A duck-typed mesh of ``shape`` over ``axes`` (``mesh_layout`` reads
    it) with this process's rank at coordinate 0 and no process groups."""

    def __init__(self, shape, axes, index=None):
        me = (torch.distributed.get_rank()
              if torch.distributed.is_initialized() else 0)
        ranks = np.arange(int(np.prod(shape)))
        if me < ranks.size:
            ranks[[0, me]] = ranks[[me, 0]]
        else:
            ranks[0] = me
        self.axis_names = tuple(axes)
        self.devices = ranks.reshape(shape)
        index = tuple(index or (0,) * len(axes))
        self._axes = {a: CountingAxis(n, i)
                      for a, n, i in zip(axes, shape, index)}

    def axis_of(self, name):
        """This rank's counting axis ``name`` (``mesh.axis_of`` reads
        it)."""
        return self._axes[name]

    def get_group(self, name):
        return None


class _LiveBytes(TorchDispatchMode):
    """The most bytes of new storages alive at once under the mode: each
    op's outputs whose storage is new count until the last tensor of the
    walk holding it is freed (an estimate: views and in-place outputs
    share their input's storage, ``external`` storages never count)."""

    def __init__(self, external=()):
        super().__init__()
        self.seen = {_key(t) for t in external}
        self.refs: Dict[int, list] = {}
        self.live = self.peak = 0

    def _drop(self, key):
        entry = self.refs[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self.refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            key = _key(t)
            if key in self.refs:
                self.refs[key][0] += 1
            elif key not in self.seen:
                self.seen.add(key)
                n = t.untyped_storage().nbytes()
                self.refs[key] = [1, n]
                self.live += n
                self.peak = max(self.peak, self.live)
            else:
                continue
            weakref.finalize(t, self._drop, key)
        return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _model_degree(cfg, m: int, headdim: bool = False) -> int:
    """The largest divisor of the model axis ``m`` that divides every
    head count the port's tensor parallelism splits (under
    ``kv_shard="headdim"``, each half of the head dim for the
    attention's heads)."""
    need = list(_split_heads(cfg, headdim).values())
    return max(t for t in range(1, m + 1)
               if m % t == 0 and all(n % t == 0 for n in need))


def _rows(rules, mesh, b: int, s: int) -> int:
    """This rank's rows of a [b, s] batch under ``batch -> (pod, data)``
    (the divisibility guard replicates a batch the axes do not divide)."""
    spec = logical_to_mesh(("batch", "seq"), rules, mesh, dim_sizes=(b, s))
    names, sizes = mesh_mod.mesh_layout(mesh)
    axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    n = int(np.prod([sizes[names.index(a)] for a in axes if a]))
    return b // n


def _rules_for(arch_id: str, policy: TrainPolicy, kind: str):
    """The walk's rules for a cell of ``kind`` under ``policy``
    (``repro/launch/dryrun.py:90-102``): the train rules, with
    ``act_seq -> model`` under ``sequence_parallel``; the serving rules
    (:data:`SERVE_RULES`), with ``kv_shard="headdim"``'s decode layout
    (``cache_seq -> data``, ``head_dim -> model``, heads and kv heads
    whole) for a decode cell."""
    del arch_id                     # the policy already is the arch's
    if kind == "train":
        rules = DEFAULT_RULES
        if policy.sequence_parallel:
            rules = rules.replace(act_seq=("model",))
        return rules
    rules = SERVE_RULES
    if kind == "decode" and policy.kv_shard == "headdim":
        rules = rules.replace(cache_seq=("data",), head_dim=("model",),
                              heads=None, kv_heads=None)
    return rules


def walk(cfg, kind: str, batch: Dict[str, torch.Tensor], *,
         mesh_shape=(1, 1), axes=("data", "model"), index=None,
         policy: TrainPolicy = DEFAULT_POLICY, features=None,
         rules=DEFAULT_RULES, dtype=torch.bfloat16, seq_len: int = 0,
         device: str = "meta", mesh: Any = None,
         state_shape=None, global_batch: Optional[int] = None
         ) -> Dict[str, Any]:
    """One rank's walk of one step of ``cfg``: ``kind`` ``train`` (the
    train step over ``batch``, this rank's rows), ``prefill`` or
    ``decode`` (against a state of ``seq_len``), on a mesh of
    ``mesh_shape`` over ``axes`` with counting axes at ``index`` (a
    coordinate; 0 on every axis by default).  Returns the declared
    events, the argument and output bytes, the live-bytes estimate and
    the registry calls by family.  ``device="cpu"`` with a real ``mesh``
    (a ``DeviceMesh`` of the process group; its axes replace the
    counting ones) runs the same step on real tensors: the run a walk is
    held to.

    A prefill or decode walks the rank's cut of the whole decode state
    of ``global_batch`` rows (``batch``'s by default) under
    ``LM.state_pspecs`` and ``rules``, on a mesh of ``state_shape``
    (``mesh_shape`` by default; the production mesh where the weights'
    model axis is walked at a smaller degree, ``mesh_walked``)."""
    from repro_torch.optim import AdamWConfig, ScheduleConfig, init_opt_state
    from repro_torch.train import step as step_mod
    if mesh is not None:
        axes, mesh_shape = mesh_mod.mesh_layout(mesh)
        state_mesh = mesh
    else:
        mesh = _WalkMesh(mesh_shape, axes, index)
        state_mesh = _WalkMesh(state_shape or mesh_shape, axes, index)
    ranks = {a: mesh_mod.axis_of(mesh, a) for a in axes}
    tp = ranks.get("model") or CountingAxis(1)
    dp = mesh_mod.DataAxis([ranks[a] for a in mesh_mod.BATCH_AXES
                            if a in ranks])
    feats = features or default_features()
    train = kind == "train"
    pdt = torch.float32 if train else dtype
    host = LM(cfg, dtype, device, features=feats, param_dtype=pdt,
              rules=rules)
    info: Dict[str, Any] = {"n_params": host.num_params(),
                            "n_active_params": host.num_active_params()}
    if train:
        lm = LM(cfg, dtype, device, features=feats, param_dtype=pdt,
                rules=rules, tp=tp, dp=dp).requires_grad_(True)
        specs = step_mod.train_state_pspecs(host, mesh).params
        layout = step_mod.StateLayout(lm, specs, mesh,
                                      dict(host.named_parameters()))
        layout.axes = dict(ranks, model=tp)
        adamw = AdamWConfig(moment_dtype=policy.moment_dtype)
        with torch.no_grad():
            params = layout.init_params(dict(host.named_parameters()))
        state = step_mod.TrainState(
            params, init_opt_state(params, adamw),
            torch.zeros((), dtype=torch.int32, device=device))
        rows = next(iter(batch.values())).shape[0]
        accum = math.gcd(policy.accum_steps, rows)
        fn = step_mod.make_train_step(lm, adamw, ScheduleConfig(),
                                      accum_steps=accum, layout=layout)
        args = (state, batch)
        info["accum_walked"] = accum
    else:
        whole = host.init_decode_state(
            global_batch or batch["tokens"].shape[0], seq_len)
        rules = host.state_rules(whole, state_mesh, rules)
        lm = LM(cfg, dtype, device, features=feats, param_dtype=pdt,
                rules=rules, tp=tp, mesh=state_mesh)
        state = lm.cut_state(whole)
        del whole
        info["cache_seq"] = {a: lm._axis(a).size for a in
                             (rules.lookup("cache_seq") or ())}
        kvs = [x for x, kind in _state_leaves(state) if kind == "kv"]
        info["kv_bytes"] = _nbytes(kvs)
        info["kv_shape"] = list(kvs[0].shape) if kvs else None
        if kind == "prefill":
            def fn(st, bt):
                return lm.prefill(bt, st)
        else:
            def fn(st, bt):
                return lm.decode_step(bt["tokens"], st)
        args = (state, batch)
    arg_bytes = _nbytes(args) + (0 if train else _nbytes(
        dict(lm.named_parameters())))
    grad_ctx = contextlib.nullcontext() if train else torch.inference_mode()
    live = _LiveBytes(external=[t for t in tree_flatten(args)[0]
                                if isinstance(t, torch.Tensor)]
                      + list(lm.parameters()))
    with events.collect() as ev, registry.tally() as calls, grad_ctx, live:
        out = fn(*args)
    info.update(events=ev, calls=dict(calls), argument_bytes=arg_bytes,
                state_bytes=_nbytes(state), output_bytes=_nbytes(out),
                temp_bytes=live.peak, peak_bytes=arg_bytes + live.peak)
    return info


def _state_leaves(state):
    """(leaf, kind) of a decode state (``lm._map_state``'s kinds)."""
    from repro_torch.models.lm import _map_state
    out = []
    _map_state(lambda x, kind: out.append((x, kind)), state)
    return out


def skip_reason(spec, shape_name: str) -> Optional[str]:
    """Why a cell is skipped (None when it runs): the arch's own skips,
    then long_500k for an arch that is not sub-quadratic."""
    reason = spec.skipped(shape_name)
    if reason is None and shape_name == "long_500k" and \
            not spec.config.sub_quadratic:
        reason = "full-attention arch skips long_500k"
    return reason


def _policy_config(spec, policy: TrainPolicy):
    cfg = spec.config
    if policy.attn_softmax != cfg.attn_softmax:
        cfg = dataclasses.replace(cfg, attn_softmax=policy.attn_softmax)
    return cfg


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None,
             verbose: bool = True,
             policy_override: Optional[TrainPolicy] = None,
             config_overrides: Optional[Dict[str, Any]] = None,
             tag: str = "",
             session=None) -> Dict[str, Any]:
    """Walk one cell; return (and optionally write) its record.

    ``policy_override`` / ``config_overrides`` / ``tag``: the same cell
    with one knob changed, written under a tagged filename so baselines
    are never overwritten.  ``session`` (a
    :class:`repro_torch.core.session.ProfileSession`) turns the whole
    cell into a cache entry: a re-run with the same (cell, policy,
    overrides, toolchain) returns the stored record without walking."""
    t_start = time.time()
    spec = get_arch(arch_id)
    if config_overrides:
        spec = dataclasses.replace(
            spec, config=dataclasses.replace(spec.config, **config_overrides))
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell = f"{arch_id}/{shape_name}/{mesh_name}" + (f"@{tag}" if tag else "")

    reason = skip_reason(spec, shape_name)
    if reason:
        rec = {"cell": cell, "status": "skipped", "reason": reason}
        _emit(rec, out_dir, verbose)
        return rec

    policy = policy_override or TRAIN_POLICY.get(arch_id, DEFAULT_POLICY)
    digest = None
    if session is not None:
        digest, _ = session.cell_digest(
            cell=cell, policy=dataclasses.asdict(policy),
            config_overrides=config_overrides or {})
        cached = session.cache.get(digest)
        if cached is not None:
            rec = dict(cached["record"], cache="hit")
            _emit(rec, out_dir, verbose)
            return rec

    try:
        rec = _walk_cell(spec, shape, multi_pod, policy, cell, mesh_name,
                         arch_id, shape_name, t_start)
    except Exception as e:
        rec = {"cell": cell, "status": "FAILED",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
        _emit(rec, out_dir, verbose)
        return rec
    if session is not None:
        session.note_lowering()
        session.cache.put(digest, {"kind": "dryrun-cell", "record": rec})
    _emit(rec, out_dir, verbose)
    if verbose:
        print(f"  memory (bytes): {rec['memory_analysis']}")
        print(f"  roofline: {rec['roofline_render']}")
    return rec


def _walk_cell(spec, shape, multi_pod, policy, cell, mesh_name, arch_id,
               shape_name, t_start) -> Dict[str, Any]:
    mesh_shape, axes = mesh_axes = mesh_mod.mesh_axes(multi_pod)
    cfg = _policy_config(spec, policy)
    train = shape.kind == "train"
    rules = _rules_for(arch_id, policy, shape.kind)
    headdim = "model" in (rules.lookup("head_dim") or ())
    m = dict(zip(axes, mesh_shape))["model"]
    t = _model_degree(cfg, m, headdim)
    walked = tuple(t if a == "model" else n for a, n in zip(axes, mesh_shape))
    feats = default_features().with_(remat_policy=policy.remat)
    batch = input_specs(cfg, shape)
    mesh = _WalkMesh(mesh_shape, axes)
    rows = _rows(rules, mesh, shape.global_batch, shape.seq_len)
    batch = {k: v[:rows] for k, v in batch.items()}
    info = walk(cfg, shape.kind, batch, mesh_shape=walked, axes=axes,
                policy=policy, features=feats, rules=rules,
                seq_len=shape.seq_len, state_shape=mesh_shape,
                global_batch=shape.global_batch)
    t_walk = time.time()
    ev = info["events"]
    ev.counts["HBM_PEAK_BYTES"] = float(info["peak_bytes"])
    n_active = info["n_active_params"]
    tokens = (shape.global_batch * shape.seq_len if shape.kind != "decode"
              else shape.global_batch)
    mf = model_flops(n_active, tokens, training=train)
    num_devices = int(np.prod(mesh_shape))
    rt = analyze(ev, cell=cell, chip=CHIP, model_flops_total=mf,
                 num_devices=num_devices)
    arg = info["argument_bytes"]
    return {
        "cell": cell,
        "status": "ok",
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind,
        "policy": dataclasses.asdict(policy),
        "n_params": info["n_params"],
        "n_active_params": n_active,
        "walk": {"device": "meta", "rank_rows": rows,
                 "mesh_walked": dict(zip(axes, walked)),
                 "mesh_axes": dict(zip(mesh_axes[1], mesh_axes[0])),
                 "accum_walked": info.get("accum_walked"),
                 "cache_seq": info.get("cache_seq"),
                 "kv_cache_bytes": info.get("kv_bytes"),
                 "kv_cache_shape": info.get("kv_shape"),
                 "unported": {}},
        "memory_analysis": {
            "argument_bytes": arg,
            "output_bytes": info["output_bytes"],
            "temp_bytes": info["temp_bytes"],
            "alias_bytes": info["state_bytes"],
            "peak_bytes_per_device": info["peak_bytes"],
            "hbm_fraction": info["peak_bytes"] / CHIP.hbm_bytes,
            "estimated": ["temp_bytes", "peak_bytes_per_device",
                          "hbm_fraction"],
        },
        "cost_analysis": {
            "flops_per_device": ev["FLOPS_TOTAL"],
            "bytes_per_device": ev["BYTES_ACCESSED"],
            "transcendentals": 0.0,
        },
        "collectives": {
            k: ev[k] for k in
            ("ICI_AG_BYTES", "ICI_AR_BYTES", "ICI_RS_BYTES", "ICI_A2A_BYTES",
             "ICI_CP_BYTES", "ICI_TOTAL_BYTES", "ICI_AG_COUNT",
             "ICI_AR_COUNT", "ICI_RS_COUNT", "ICI_A2A_COUNT", "ICI_CP_COUNT")
        },
        "structure": {"launches_by_family": info["calls"],
                      "launches": int(sum(info["calls"].values())),
                      "note": "kernel launches by registry family in place "
                              "of XLA's fusion, while-loop and HLO counts"},
        "roofline": rt.row(),
        "roofline_render": rt.render(),
        "events": {k: float(v) for k, v in ev.counts.items()},
        "timings_s": {"walk": round(t_walk - t_start, 2)},
    }


def _emit(rec: Dict[str, Any], out_dir: Optional[str], verbose: bool):
    if verbose:
        status = rec["status"]
        extra = rec.get("reason") or rec.get("error") or ""
        print(f"[dryrun] {rec['cell']:<52} {status} {extra[:90]}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = rec["cell"].replace("/", "__") + ".json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1, default=float)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--out", default="experiments/dryrun")
    cli.add_impl_args(ap)
    cli.add_cache_args(ap)
    cli.add_json_args(ap, what="sweep summary")
    ap.add_argument("--parallel", type=int, default=1,
                    help="fan cells out across N sweep workers")
    ap.add_argument("--tag", default="", help="suffix for the record file")
    ap.add_argument("--attn", default=None,
                    choices=["naive", "fused", "kernel"],
                    help="attention softmax_mode")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--remat", default=None,
                    choices=["none", "dots", "dots_no_batch", "full"])
    ap.add_argument("--sp", type=int, default=None,
                    help="sequence_parallel 0|1")
    ap.add_argument("--chunk-threshold", type=int, default=None)
    ap.add_argument("--chunk-size", type=int, default=None)
    ap.add_argument("--kv-shard", default=None, choices=["seq", "headdim"])
    args = ap.parse_args(argv)

    cfg_over: Dict[str, Any] = {}
    if args.chunk_threshold is not None:
        cfg_over["attn_chunk_threshold"] = args.chunk_threshold
    if args.chunk_size is not None:
        cfg_over["chunk_size"] = args.chunk_size

    def policy_for(arch):
        base = TRAIN_POLICY.get(arch, DEFAULT_POLICY)
        kw = {}
        if args.attn is not None:
            kw["attn_softmax"] = args.attn
        if args.accum is not None:
            kw["accum_steps"] = args.accum
        if args.remat is not None:
            kw["remat"] = args.remat
        if args.sp is not None:
            kw["sequence_parallel"] = bool(args.sp)
        if args.kv_shard is not None:
            kw["kv_shard"] = args.kv_shard
        return dataclasses.replace(base, **kw) if kw else None

    archs = ([args.arch] if args.arch else
             [s.arch_id for s in list_archs()])
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if not (args.all or args.arch or args.shape):
        ap.error("pass --all or --arch/--shape")

    session = cli.session_from_args(args)
    if args.tune:
        cli.run_tune_suite(session)

    failures = cells = 0
    with cli.impl_context(args):
        for multi in meshes:
            def cell_fn(arch, shape, _multi=multi):
                return run_cell(arch, shape, _multi, out_dir=args.out,
                                policy_override=policy_for(arch),
                                config_overrides=cfg_over or None,
                                tag=args.tag, session=session,
                                verbose=args.parallel <= 1)
            recs = session.sweep(archs, shapes, parallel=args.parallel,
                                 multi_pod=multi, cell_fn=cell_fn)
            failures += sum(r["status"] == "FAILED" for r in recs)
            cells += len(recs)
    print(f"[dryrun] done, {failures} failures   ({session.stats()})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"cells": cells, "failures": failures,
                       "out": args.out, "tag": args.tag,
                       "session": session.stats()}, f, indent=2)
        print(f"[dryrun] wrote {args.json}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
