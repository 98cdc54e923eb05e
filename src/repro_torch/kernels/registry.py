"""One kernel registry: named impls, one override ladder, one tuner.

Port of ``repro/kernels/registry.py`` (LIKWID's API bet, the paper's §II:
a small, stable, named surface you can force from the environment).
Every implementation is a :class:`KernelSpec` registered with
:func:`register_impl`; each family has a heuristic and a fact extractor
(:func:`register_family`).  :func:`select` resolves one
override ladder per family: the :func:`use_impl` thread-local context,
then ``REPRO_IMPL`` (``"attention=cuda_flash,paged_decode=torch_paged"``),
then the legacy ``REPRO_ATTN_IMPL`` name (mapped onto the attention and
paged_decode families, :data:`LEGACY_ATTN_MAP`), then the heuristic.
``ServeConfig.impls`` / ``attn_impl`` and the launcher's ``--impl`` pin
through the same context.

Impl names name the port's routes, one to one with the reference's
(:data:`REFERENCE_NAMES`), beside the port's own (:data:`PORT_ONLY`):

=============  ===================  ====================================
family         reference            port
=============  ===================  ====================================
attention      pallas_flash         cuda_flash   (kernel #1)
               jnp_flash            torch_flash  (the autograd twin)
               full                 full         (masked softmax over
                                                 materialized scores)
               (none)               cuda_flash_train  (the training
                                                 kernels, forward and
                                                 backward)
paged_decode   pallas_paged         cuda_paged   (kernel #2)
               jnp_paged            torch_paged
               pallas_paged_q8      cuda_paged_q8  (kernel #3)
               jnp_paged_q8         torch_paged_q8
stream_triad   pallas_triad         cuda_triad   (kernel #6)
               xla_triad            torch_triad
jacobi7        wavefront, naive     wavefront, naive  (kernel #7, T
                                                 sweeps a launch or one)
ssd_scan       pallas_ssd           cuda_ssd     (kernel #5)
               jnp_scan             torch_scan
sampling       pallas_greedy/topk/  cuda_greedy/topk/topp  (kernel #4
               topp                 over the Gumbel-shifted logits)
               jnp_greedy/topk/topp torch_greedy/topk/topp
=============  ===================  ====================================

**Gradients** (``repro/kernels/registry.py:963-991``).  Kernels #1-#7
are loaded through ``ctypes``: what they return has no ``grad_fn``, so a
training step through one would drop its gradient without an error.
The ``attention`` and ``ssd_scan`` families therefore take a
``differentiable`` fact, which :func:`run` sets when autograd records
the call (:func:`needs_grad`: grad mode on and an input that requires a
gradient).  With it, the ``ssd_scan`` heuristic returns ``torch_scan``
(the reference's ``jnp_scan``, "the grad path"), and the ``attention``
heuristic returns ``cuda_flash_train`` where the call's facts meet the
training kernels' conditions (the card, bf16, a head dim they build, no
query offset or ragged lengths, whole GQA groups:
``flash_attention_train.takes``), else ``torch_flash`` (the flash core as
an autograd ``Function``, the reference's ``jnp_flash``).
``cuda_flash_train`` is the port's own impl, with no reference name: the
training kernels' forward and backward as an autograd ``Function``
(``kernels/flash_attention_train.py``; the JAX package trains through
plain ops and has no such kernel).  ``cuda_flash`` and ``cuda_ssd`` raise
when called with ``differentiable``, or with an input that needs a
gradient, and :func:`select` refuses a pin to either under it, so
neither ``use_impl`` nor ``REPRO_IMPL`` can route training into a
kernel without a gradient.  (The reference lets a pin beat
``differentiable``; its Pallas kernels then fail in autodiff instead.)

Both packages read the same ``REPRO_IMPL``, so :func:`parse_impl_spec`,
:func:`use_impl` and :func:`get_spec` also take the reference's names and
return the port's.

**The tuner.**  The kernel impl of each family (``cuda_flash``, both
paged impls, the three ``cuda_*`` sampling impls, ``cuda_ssd``,
``cuda_triad``, ``wavefront``) declares a :class:`TuneSpace` over the
knob its kernel really has::

    attention     cuda_flash     (bq, bk)        FLASH_PAIRS per dtype
    paged_decode  cuda_paged     (page_size, split)   split = CTAs a row
                  cuda_paged_q8  (page_size, split)   (own keys)
    sampling      cuda_*         (split,)        argmax CTAs a row
    ssd_scan      cuda_ssd       (chunk,)
    stream_triad  cuda_triad     (block_rows,)
    jacobi7       wavefront      (block_x,)

:func:`autotune` sweeps a space through ``ProfileSession.measure``,
gates each candidate on shared memory, records the winner(s) in a
lock-guarded process table and persists them in the artifact cache, so
a fresh process warm-starts with zero sweeps and zero timed probes;
:func:`best` serves the table (then disk, then the nearest tuned
neighbour, then the space's ``default``) to the runners, which read it
only when the caller passes no tile.  With no record every ``default``
is exactly the tile the wrappers took before the tuner existed.  The tune
keys are the reference's, byte for byte, for the same facts (dtype names
``float32`` / ``bfloat16``, backend ``cuda`` / ``cpu``), and a record's
and a dump's field names are the reference's, so one perf report reads
either package's ``TUNE_TABLE.json``.

**What a runner does.**  ``cuda_*`` runners (and ``wavefront`` /
``naive``) call the kernel wrappers: CUDA tensors launch the kernel or
raise, CPU tensors run the plain version (the port's counterpart of the
reference's Pallas interpret mode).  ``torch_*`` and ``full`` call the
plain versions on either device and declare their work to the open event
collections as plain work (no launch); a pinned plain impl on the card
leaves the kernel counters at 0.  Nothing swaps a failed build or launch
for the plain version.

**Where the port differs** (``ROADMAP.md``, deliberate departures):

* the heuristics' backend is the device type of the call's tensors
  (``backend`` fact), never a process-wide default, so CPU tensors on a
  machine with a card take the CPU's choices; :func:`select` without a
  ``backend`` fact takes ``cuda``, the port's default device;
* on CUDA, prefill attention takes ``cuda_flash`` at every query length
  and head dim (the TPU rule sends ``sq < 8`` or ``dh % 8`` to
  ``full``): the flash kernel masks ragged edges itself, and its wrapper
  raises for a head dim it does not hold
  (``flash_attention.SUPPORTED_HEAD_DIMS``); the plain version runs on
  the card only when pinned;
* the paged runners take the wrappers' grouped layout (q4
  ``[B,KVH,G,Dh]``, k/v_new ``[B,KVH,Dh]``), and the SSD runners take a
  carried ``initial_state``, which the port's kernel holds;
* selection runs on every call (eager), where JAX resolves it once per
  trace: an env value is parsed once, cached by its string, and inside
  :func:`env_snapshot` (the engine takes one per prefill, decode and
  segment) the variables are read once, so a call costs a few dict
  lookups.  :func:`best` memoizes its resolution per call site's exact
  facts (defaults included); a record put, a clear or a new cache root
  drops the memo.  A changed ``$REPRO_CACHE_DIR`` inside a running
  process takes :func:`clear_tune_table`;
* the score is **measured device seconds** on the card (the reference
  scores a roofline over the lowered program's cost, which the port does
  not have, and whose bytes would barely depend on the tile); on the CPU
  it is the reference's score, ``max(FLOPs / peak, bytes / bandwidth)``
  over the declared events, so CPU sweeps are deterministic;
* the gate is **shared memory per block**, 227 KiB (48 KiB for the int8
  paged kernel, which takes no opt-in), through the wrappers' own
  footprint functions, with the keyword ``smem_fraction`` (default 1.0:
  the footprints are exact) where the reference gates VMEM with
  ``vmem_fraction``; a sweep entry stores ``smem_fraction``;
* each space's candidates are the port's tiles (the flash kernel's
  default is ``(64, 64)`` in bf16, the reference's ``(128, 256)``).

**Mesh facts** (``repro/kernels/registry.py:301-355``): a sharded
engine enters :func:`use_mesh_facts` (``mesh_shape``, ``mesh_axis``,
``per_device_heads``) around its work, so every :func:`best`,
:func:`resolve` and :func:`autotune` keys its record per sharding
(:func:`mesh_key_tag` on the attention and paged keys), with the
unsharded key as the last neighbour (:func:`_unsharded_fallback`).  An
unsharded key is byte-identical to the pre-mesh one, so every tune record
already written stays warm.  The kernels' ``supports`` refuse
``per_device_heads == 0`` (a head sharding that does not divide).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import threading
import warnings
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.core import hwinfo
from repro_torch.core.artifact_cache import ArtifactCache, canonical_digest
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import flash_attention_train as flash_train_mod
from repro_torch.kernels import jacobi7 as jacobi_mod
from repro_torch.kernels import paged_decode as paged_mod
from repro_torch.kernels import sampling as sampling_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels import stream_triad as triad_mod
from repro_torch.models.linear_scan import _chunked_linear_attention

__all__ = [
    "KernelSpec", "TuneSpace", "TuneRecord", "register_impl",
    "needs_grad", "tally",
    "register_family", "families", "impls", "get_spec", "describe",
    "use_impl", "parse_impl_spec", "override_for", "select", "run",
    "autotune", "best", "record", "clear_tune_table", "tune_table",
    "dump_tune_table", "LEGACY_ATTN_MAP", "REFERENCE_NAMES",
    "legacy_mapping", "env_snapshot", "SMEM_PER_BLOCK", "resolve",
    "PORT_ONLY", "call_facts", "carry_pins",
    "served_sites", "best_at", "MESH_FACTS", "use_mesh_facts",
    "mesh_facts", "mesh_key_tag",
]

#: shared memory one block may opt in to on sm_90 (227 KiB): the gate
SMEM_PER_BLOCK = _build.SMEM_OPT_IN


def _backend(backend: Optional[str]) -> str:
    return backend or "cuda"


def _pow2_up(n: int) -> int:
    """Round up to a power of two (>= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _dtype_name(dtype) -> str:
    """``float32`` / ``bfloat16`` / ... for a torch dtype or its name (the
    reference's ``jnp.dtype(dtype).name``)."""
    return str(dtype).replace("torch.", "")


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else \
        getattr(torch, _dtype_name(dtype))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=_torch_dtype(dtype)).element_size()


# ---------------------------------------------------------------------------
# the data model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TuneSpace:
    """Declarative tune space for one (tunable) implementation.

    ``key(**facts)`` names the sweep (and, unless ``lookup_key`` is given,
    the record :func:`best` looks up); ``candidates(**facts)`` yields
    candidate tuples; ``smem(cand, itemsize, **facts)`` is the shared
    memory one block of the kernel needs, gated against ``smem_limit``
    before anything runs; ``probe(cand, **facts)`` returns ``(module-level
    fn, args)`` for ``ProfileSession.measure``, the args tensors made from
    a seed on the facts' backend (module-level and seeded, so the cache
    key is stable across processes); ``plain(cand, **facts)`` returns the
    plain version over the same args (what a sweep's outputs are held
    to); ``record_keys(scores, **facts)`` optionally fans one sweep into
    several lookup records (the paged sweep records a winner per
    page_size); ``default`` is the untuned choice (a tuple, or a callable
    over the lookup facts): the tile the wrapper takes with no tile given.
    """

    key: Callable[..., str]
    candidates: Callable[..., Sequence[Tuple]]
    smem: Callable[..., float]
    probe: Callable[..., Tuple[Callable, Tuple]]
    default: Any
    plain: Optional[Callable[..., Callable]] = None
    lookup_key: Optional[Callable[..., str]] = None
    record_keys: Optional[Callable[..., Dict[str, Tuple[Tuple, float]]]] = None
    #: ``neighbors(**facts)`` yields fact-overrides for nearby tune
    #: buckets, nearest first; :func:`best` adopts the first neighbor
    #: with a recorded winner that still fits the shared-memory gate for
    #: the ACTUAL facts (cross-shape warm starts without new sweeps)
    neighbors: Optional[Callable[..., Sequence[Dict[str, Any]]]] = None
    #: the shared memory a block of this kernel may have
    smem_limit: int = SMEM_PER_BLOCK

    def resolve_default(self, **facts) -> Tuple:
        d = self.default
        return tuple(d(**facts)) if callable(d) else tuple(d)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered implementation, declared in one place."""

    family: str
    name: str
    fn: Callable                               # runner, model layout
    supports: Optional[Callable[..., bool]] = None   # static capability
    layout: str = ""                           # calling-convention contract
    oracle: str = ""                           # dotted path of the oracle
    tune: Optional[TuneSpace] = None           # only on the tunable impl
    doc: str = ""


@dataclasses.dataclass
class _Family:
    name: str
    impls: Dict[str, KernelSpec] = dataclasses.field(default_factory=dict)
    heuristic: Optional[Callable[..., str]] = None
    facts: Optional[Callable[..., Dict[str, Any]]] = None
    layout: str = ""


_FAMILIES: Dict[str, _Family] = {}

#: the reference's impl names -> the port's, per family
REFERENCE_NAMES: Dict[str, Dict[str, str]] = {
    "attention": {"pallas_flash": "cuda_flash", "jnp_flash": "torch_flash",
                  "full": "full"},
    "paged_decode": {"pallas_paged": "cuda_paged",
                     "jnp_paged": "torch_paged",
                     "pallas_paged_q8": "cuda_paged_q8",
                     "jnp_paged_q8": "torch_paged_q8"},
    "stream_triad": {"pallas_triad": "cuda_triad",
                     "xla_triad": "torch_triad"},
    "jacobi7": {"wavefront": "wavefront", "naive": "naive"},
    "ssd_scan": {"pallas_ssd": "cuda_ssd", "jnp_scan": "torch_scan"},
    "sampling": {"jnp_greedy": "torch_greedy", "jnp_topk": "torch_topk",
                 "jnp_topp": "torch_topp", "pallas_greedy": "cuda_greedy",
                 "pallas_topk": "cuda_topk", "pallas_topp": "cuda_topp"},
}


#: the port's impls that have no reference name, per family
PORT_ONLY: Dict[str, Tuple[str, ...]] = {"attention": ("cuda_flash_train",)}


def register_impl(family: str, name: str, *,
                  supports: Optional[Callable[..., bool]] = None,
                  layout: str = "", oracle: str = "",
                  tune: Optional[TuneSpace] = None) -> Callable:
    """Decorator: register the wrapped callable as impl ``name`` of
    ``family``.  The callable is the runner (model layout in, model
    layout out); registration is declarative — no ladder code."""
    def deco(fn: Callable) -> Callable:
        fam = _FAMILIES.setdefault(family, _Family(name=family))
        fam.impls[name] = KernelSpec(
            family=family, name=name, fn=fn, supports=supports,
            layout=layout, oracle=oracle, tune=tune,
            doc=(fn.__doc__ or "").strip().splitlines()[0]
            if fn.__doc__ else "")
        return fn
    return deco


def register_family(name: str, *, heuristic: Callable[..., str],
                    facts: Optional[Callable] = None,
                    layout: str = "") -> None:
    """Attach the unforced-selection heuristic (and, optionally, the
    static-fact extractor :func:`run` uses to self-select) to a family."""
    fam = _FAMILIES.setdefault(name, _Family(name=name))
    fam.heuristic = heuristic
    fam.facts = facts
    fam.layout = layout or fam.layout


def _family(name: str) -> _Family:
    fam = _FAMILIES.get(name)
    if fam is None:
        raise ValueError(f"unknown kernel family {name!r}; "
                         f"choose from {sorted(_FAMILIES)}")
    return fam


def families() -> Tuple[str, ...]:
    return tuple(sorted(_FAMILIES))


def impls(family: str) -> Tuple[str, ...]:
    return tuple(_family(family).impls)


def get_spec(family: str, name: str) -> KernelSpec:
    """The spec of impl ``name`` (the port's name or the reference's)."""
    fam = _family(family)
    spec = fam.impls.get(name)
    if spec is None:
        spec = fam.impls.get(REFERENCE_NAMES.get(family, {}).get(name, ""))
    if spec is None:
        raise ValueError(f"unknown {family} impl {name!r}; "
                         f"choose from {tuple(fam.impls)}")
    return spec


def describe() -> str:
    """Human-readable registry table (families, impls, tune spaces)."""
    lines = []
    for fname in families():
        for spec in _FAMILIES[fname].impls.values():
            tuned = "tunable" if spec.tune is not None else ""
            lines.append(f"{fname:>13}  {spec.name:<15} {tuned:<8} "
                         f"{spec.doc}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the override ladder (one per family)
# ---------------------------------------------------------------------------

_TLS = threading.local()

#: legacy ``REPRO_ATTN_IMPL`` / ``ServeConfig.attn_impl`` names, mapped
#: onto per-family overrides.  ``paged_decode`` pins the DECODE side only
#: and is transparent to prefill selection (no ``attention`` entry).
LEGACY_ATTN_MAP: Dict[str, Dict[str, str]] = {
    "cuda_flash": {"attention": "cuda_flash", "paged_decode": "cuda_paged"},
    "torch_flash": {"attention": "torch_flash",
                    "paged_decode": "torch_paged"},
    "full": {"attention": "full", "paged_decode": "torch_paged"},
    "paged_decode": {"paged_decode": "cuda_paged"},
}


def legacy_mapping(name: str) -> Optional[Dict[str, str]]:
    """:data:`LEGACY_ATTN_MAP`'s entry for ``name`` (the port's spelling
    or the reference's), None for an unknown name."""
    return LEGACY_ATTN_MAP.get(REFERENCE_NAMES["attention"].get(name, name))


def parse_impl_spec(spec: str) -> Dict[str, str]:
    """Parse ``"attention=cuda_flash,paged_decode=cuda_paged"`` into a
    validated {family: impl} mapping of the port's names (the
    ``REPRO_IMPL`` / ``--impl`` grammar; the reference's names map
    through :data:`REFERENCE_NAMES`)."""
    out: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad impl spec {part!r} (want family=impl[,family=impl...];"
                f" families: {families()})")
        fam, name = (t.strip() for t in part.split("=", 1))
        out[fam] = get_spec(fam, name).name     # validates both halves
    return out


@functools.lru_cache(maxsize=16)
def _env_impls(value: str) -> Dict[str, str]:
    """``REPRO_IMPL``'s mapping, parsed once per value (never mutated)."""
    return parse_impl_spec(value)


@contextlib.contextmanager
def use_impl(spec: Optional[str] = None, **impl_kw: Optional[str]):
    """Force per-family implementations for everything run inside.

    Accepts a spec string (``use_impl("attention=cuda_flash")``) and/or
    keywords (``use_impl(attention="cuda_flash")``).  Thread-local;
    nested contexts merge with inner-wins-per-family; ``None`` values are
    no-ops so callers can thread optional config fields straight
    through."""
    wanted = dict(parse_impl_spec(spec)) if spec else {}
    for fam, name in impl_kw.items():
        if name is None:
            continue
        wanted[fam] = get_spec(fam, name).name   # validate eagerly
    prev = getattr(_TLS, "impls", None)
    _TLS.impls = {**(prev or {}), **wanted}
    try:
        yield
    finally:
        _TLS.impls = prev


def carry_pins(fn: Callable) -> Callable:
    """``fn`` run under the pins in force now (:func:`use_impl`'s and
    :func:`env_snapshot`'s thread-local state), whatever thread calls it
    later.  Autograd runs a card's backward, and with it a checkpoint's
    recompute, on its own device thread, where the caller's pins are not
    set: the recompute must take the forward's route."""
    pins = (getattr(_TLS, "impls", None), getattr(_TLS, "env", None))

    def pinned(*args, **kwargs):
        prev = (getattr(_TLS, "impls", None), getattr(_TLS, "env", None))
        _TLS.impls, _TLS.env = pins
        try:
            return fn(*args, **kwargs)
        finally:
            _TLS.impls, _TLS.env = prev
    return pinned


@contextlib.contextmanager
def env_snapshot():
    """Read ``REPRO_IMPL`` and ``REPRO_ATTN_IMPL`` once for everything run
    inside (thread-local), as JAX reads them once per trace.  An absent
    variable costs ``os.environ`` a raised KeyError a read (~1-2 us on a
    serving host), paid on every call of every family outside a snapshot;
    the engine takes one around each prefill, decode and segment."""
    prev = getattr(_TLS, "env", None)
    _TLS.env = (os.environ.get("REPRO_IMPL"),
                os.environ.get("REPRO_ATTN_IMPL"))
    try:
        yield
    finally:
        _TLS.env = prev


#: the sharding facts every mesh-aware tune key understands.  Unsharded
#: call sites never set them (``None``), so single-device keys are
#: byte-identical to the pre-mesh scheme and stay warm.
MESH_FACTS = ("mesh_shape", "mesh_axis", "per_device_heads")


@contextlib.contextmanager
def use_mesh_facts(**facts):
    """Ambient sharding facts for everything run inside the block.

    A sharded engine enters this around its work so that :func:`best`
    lookups, which see the rank's local shapes, key their tune records per
    sharding: ``use_mesh_facts(mesh_shape=(1, 2), mesh_axis="model",
    per_device_heads=2)``.  Thread-local; nested contexts merge with
    inner-wins; ``None`` values are dropped so callers can thread optional
    config straight through."""
    wanted = {k: v for k, v in facts.items() if v is not None}
    unknown = set(wanted) - set(MESH_FACTS)
    if unknown:
        raise ValueError(f"unknown mesh facts {sorted(unknown)}; "
                         f"expected a subset of {MESH_FACTS}")
    prev = getattr(_TLS, "mesh_facts", None)
    merged = {**(prev or {}), **wanted}
    _TLS.mesh_facts = merged
    try:
        yield
    finally:
        _TLS.mesh_facts = prev


def mesh_facts() -> Dict[str, Any]:
    """The ambient sharding facts (empty dict when unsharded)."""
    return dict(getattr(_TLS, "mesh_facts", None) or {})


def mesh_key_tag(*, mesh_shape=None, mesh_axis=None,
                 per_device_heads=None) -> str:
    """Tune-key component for a sharding: '' unsharded (keys unchanged),
    ``-mesh1x2.model.pdh2`` under a (1, 2) mesh with the kv heads split
    over ``model`` leaving 2 per device."""
    if mesh_shape is None:
        return ""
    shape = "x".join(str(int(s)) for s in mesh_shape)
    pdh = ("" if per_device_heads is None
           else f".pdh{int(per_device_heads)}")
    return f"-mesh{shape}.{mesh_axis or 'model'}{pdh}"


def _unsharded_fallback(facts: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Neighbour delta clearing the mesh facts: under a sharding the
    UNSHARDED key is the fallback neighbour (a single-device sweep is a
    better prior than the declared default), tried after the same-
    sharding shape neighbours."""
    if facts.get("mesh_shape") is None:
        return []
    return [{k: None for k in MESH_FACTS}]


def _heads_ok(per_device_heads=None) -> bool:
    """A kernel needs at least one whole kv head per device
    (``per_device_heads=0`` marks an indivisible head sharding)."""
    return per_device_heads is None or per_device_heads >= 1


def override_for(family: str) -> Optional[str]:
    """The forced impl for ``family``: context, else ``REPRO_IMPL``, else
    the legacy ``REPRO_ATTN_IMPL`` mapping; None when unforced."""
    ctx = getattr(_TLS, "impls", None)
    if ctx and family in ctx:
        return ctx[family]
    snap = getattr(_TLS, "env", None)
    env, legacy = snap if snap is not None else (
        os.environ.get("REPRO_IMPL"), os.environ.get("REPRO_ATTN_IMPL"))
    if env:
        mapping = _env_impls(env)                # raises on bad spec
        if family in mapping:
            return mapping[family]
    if legacy:
        mapping = legacy_mapping(legacy)
        if mapping is None:
            raise ValueError(f"REPRO_ATTN_IMPL={legacy!r} not in "
                             f"{tuple(LEGACY_ATTN_MAP)}")
        if family in mapping:
            return mapping[family]
    return None


def needs_grad(*ts) -> bool:
    """Whether autograd records a call on ``ts``: grad mode on and one
    of them (tensors or None) requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _refuse_grad(family: str, name: str) -> None:
    raise RuntimeError(
        f"{family} impl {name!r} is a hand-written kernel with no gradient "
        f"(loaded through ctypes): it cannot run under autograd; the "
        f"differentiable twin is "
        f"{ {'attention': 'torch_flash', 'ssd_scan': 'torch_scan'}[family]!r}"
        f" (ROADMAP.md, queue 1 item 13)")


def select(family: str, **facts) -> str:
    """Pick an implementation name from static facts.

    An override (context / env) beats the heuristic, except that a pin to
    an impl whose ``supports`` rejects ``differentiable=True`` raises
    when the facts say the call is differentiable; unforced, the
    family's heuristic decides."""
    fam = _family(family)
    forced = override_for(family)
    if forced is not None:
        spec = get_spec(family, forced)
        if (facts.get("differentiable") and spec.supports is not None
                and not spec.supports(differentiable=True)):
            _refuse_grad(family, spec.name)
        return forced
    return fam.heuristic(**facts)


def call_facts(family: str, *args, **kwargs) -> Dict[str, Any]:
    """The static facts of a call on model-layout args, as the family's
    fact extractor gives them (empty for a family without one)."""
    fam = _family(family)
    return fam.facts(*args, **kwargs) if fam.facts is not None else {}


def run(family: str, *args, impl: Optional[str] = None, **kwargs):
    """Run ``family`` on model-layout args; ``impl=None`` self-selects
    via :func:`call_facts` + :func:`select`."""
    if impl is None:
        impl = select(family, **call_facts(family, *args, **kwargs))
    counts = getattr(_TLS, "tally", None)
    if counts is not None:
        counts[family] = counts.get(family, 0) + 1
    return get_spec(family, impl).fn(*args, **kwargs)


@contextlib.contextmanager
def tally() -> Iterator[Dict[str, int]]:
    """Count this thread's :func:`run` calls by family inside the block
    (the dry run's launches by kernel family: each call is one kernel
    launch on the card)."""
    prev = getattr(_TLS, "tally", None)
    _TLS.tally = counts = {}
    try:
        yield counts
    finally:
        _TLS.tally = prev


# ---------------------------------------------------------------------------
# the tune table (lock-guarded: sweep workers race on it) + persistence
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TuneRecord:
    """Outcome of one autotune sweep — or its disk-persisted resurrection
    (``swept=False``: served from the tune cache, nothing measured)."""

    family: str
    key: str
    choice: Tuple
    score_s: float
    scores: Dict[Tuple, float]          # candidate -> score (inf = gated)
    lowerings: int                      # timed probes (0 = fully warm)
    swept: bool = True                  # False: loaded, not measured
    #: winner's declared events (FLOPS_TOTAL / BYTES_ACCESSED) — what
    #: perf_report needs to place the choice on the roofline
    winner_events: Dict[str, float] = dataclasses.field(default_factory=dict)
    interpolated: bool = False          # adopted from a neighbor bucket
    #: the one timer behind every score of the sweep on the card
    #: (``"profiler"`` or ``"events"``); None where scored by the roofline
    timer: Optional[str] = None


class _TuneTable:
    """The process-wide winner table, consulted by :func:`best` on every
    runner call.  Every mutation is lock-guarded: ``ProfileSession.sweep``
    workers autotune concurrently.

    Disk misses are negative-cached (``note_miss``/``missed``) so an
    untuned shape pays the filesystem probe once per process, not once
    per call; recording a key discards its miss marker.  On top of both,
    :func:`best` memoizes each call site's resolved choice (``memo``):
    every ``put``, ``clear`` or ``drop_misses`` empties the memo and
    bumps ``generation``, so a memo entry is never older than the table
    it was resolved from."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._recs: Dict[Tuple[str, str], TuneRecord] = {}
        self._miss: set = set()
        self.memo: Dict[Any, Tuple] = {}
        self.generation = 0

    def _invalidate(self) -> None:
        self.memo = {}
        self.generation += 1

    def get(self, family: str, key: str) -> Optional[TuneRecord]:
        with self._lock:
            return self._recs.get((family, key))

    def put(self, rec: TuneRecord) -> None:
        with self._lock:
            self._recs[(rec.family, rec.key)] = rec
            self._miss.discard((rec.family, rec.key))
            self._invalidate()

    def missed(self, family: str, key: str) -> bool:
        with self._lock:
            return (family, key) in self._miss

    def note_miss(self, family: str, key: str) -> None:
        with self._lock:
            self._miss.add((family, key))

    def drop_misses(self) -> None:
        """Invalidate every negative-cached miss (records stay): the set
        of disk roots just changed, so a prior miss proves nothing."""
        with self._lock:
            self._miss.clear()
            self._invalidate()

    def clear(self, family: Optional[str] = None) -> None:
        with self._lock:
            if family is None:
                self._recs.clear()
                self._miss.clear()
            else:
                for k in [k for k in self._recs if k[0] == family]:
                    del self._recs[k]
                self._miss = {k for k in self._miss if k[0] != family}
            self._invalidate()

    def memo_put(self, mkey: Any, choice: Tuple, generation: int) -> None:
        """Memoize ``choice`` unless the table changed since
        ``generation`` was read (the resolution may be stale)."""
        with self._lock:
            if self.generation == generation:
                self.memo[mkey] = choice

    def snapshot(self) -> List[TuneRecord]:
        with self._lock:
            return list(self._recs.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._recs)


_TABLE = _TuneTable()


def tune_table() -> _TuneTable:
    return _TABLE


def clear_tune_table(family: Optional[str] = None) -> None:
    """Forget everything this process learned about winners: the table,
    the negative-cached misses, the memo and (on a full clear) the extra
    cache roots and the served call sites (:func:`served_sites`).
    Disk-persisted records survive — ``best`` re-reads the default root
    on the next miss."""
    _TABLE.clear(family)
    if family is None:
        _forget_tune_roots()
        _SITES.clear()


def dump_tune_table() -> Dict[str, Any]:
    """JSON-ready dump of every in-process record (the CI artifact)."""
    return {"records": [
        {"family": r.family, "key": r.key, "choice": list(r.choice),
         "score_s": r.score_s, "lowerings": r.lowerings, "swept": r.swept,
         "scores": {str(list(c)): s for c, s in sorted(r.scores.items())},
         "winner_events": dict(r.winner_events),
         "interpolated": r.interpolated, "timer": r.timer}
        for r in sorted(_TABLE.snapshot(), key=lambda r: (r.family, r.key))
    ]}


def _toolchain() -> Dict[str, str]:
    from repro_torch.core.session import _toolchain as tc
    return tc()


def _tune_digest(kind: str, family: str, key: str) -> str:
    """Content digest for a persisted tune entry — keyed like probes
    (the toolchain includes the port's source fingerprint, kernels
    included, so a code edit invalidates winners instead of serving
    stale tilings)."""
    return canonical_digest({"kind": kind, "family": family, "key": key,
                             "toolchain": _toolchain()})


# cache roots autotune persisted winners to this process, beyond the
# default root — best() consults these too, so a custom
# ProfileSession(cache_dir=...) sweep is visible to the runners even after
# clear_tune_table().  (Cross-process, best()-only warm starts read the
# DEFAULT root: point $REPRO_CACHE_DIR at the sweep's cache dir, or call
# autotune once per process — free when warm — to re-register the root.)
# Lock-guarded: sweep workers add roots while runners snapshot them.
_EXTRA_TUNE_ROOTS: set = set()
_ROOTS_LOCK = threading.Lock()


def _note_tune_root(cache: ArtifactCache) -> None:
    if cache.enabled and cache.root != ArtifactCache(None).root:
        with _ROOTS_LOCK:
            fresh = cache.root not in _EXTRA_TUNE_ROOTS
            _EXTRA_TUNE_ROOTS.add(cache.root)
        if fresh:
            # misses negative-cached BEFORE this root became visible are
            # stale: keys absent from the old roots may be persisted
            # here (e.g. after clear_tune_table() forgot the root)
            _TABLE.drop_misses()


def _forget_tune_roots() -> None:
    with _ROOTS_LOCK:
        _EXTRA_TUNE_ROOTS.clear()


def _tune_caches() -> List[ArtifactCache]:
    """The caches :func:`best` reads when the in-process table misses —
    ``$REPRO_CACHE_DIR`` (resolved per miss, i.e. the place
    ProfileSession probes land by default) plus any roots winners were
    persisted to this process."""
    default = ArtifactCache(None)
    with _ROOTS_LOCK:
        extras = sorted(_EXTRA_TUNE_ROOTS)
    return [default] + [ArtifactCache(r) for r in extras
                        if r != default.root]


def _rec_to_entry(rec: TuneRecord, candidates: Sequence[Tuple],
                  smem_fraction: float,
                  records: Dict[str, Tuple[Tuple, float]],
                  rec_events: Dict[str, Dict[str, float]]) -> Dict[str, Any]:
    return {
        "kind": "tune-sweep", "family": rec.family, "key": rec.key,
        "choice": list(rec.choice), "score_s": rec.score_s,
        "scores": [[list(c), s] for c, s in rec.scores.items()],
        "candidates": [list(c) for c in candidates],
        "smem_fraction": smem_fraction, "timer": rec.timer,
        "winner_events": dict(rec.winner_events),
        "records": {k: {"choice": list(c), "score_s": s,
                        "winner_events": rec_events.get(k, {})}
                    for k, (c, s) in records.items()},
    }


#: digests already warned about this process — corrupt tune entries warn
#: ONCE, not per lookup
_QUARANTINE_WARNED: set = set()
_QUARANTINE_LOCK = threading.Lock()


def _quarantine_tune_entry(cache: ArtifactCache, digest: str, family: str,
                           key: str, err: Exception) -> None:
    """A persisted tune-table entry failed to parse: move it aside as
    ``*.corrupt`` (post-mortem evidence, never served again), warn once
    per process, and let the caller fall through to a re-sweep/miss —
    a damaged cache degrades to a cold cache, never to a crash."""
    cache.quarantine(digest)
    with _QUARANTINE_LOCK:
        if digest in _QUARANTINE_WARNED:
            return
        _QUARANTINE_WARNED.add(digest)
    warnings.warn(
        f"corrupt tune-table entry for {family}[{key}] "
        f"({type(err).__name__}: {err}) quarantined to *.corrupt under "
        f"{cache.root}; re-sweeping", RuntimeWarning, stacklevel=3)


def _entry_to_rec(family: str, key: str, entry: Dict[str, Any]) -> TuneRecord:
    return TuneRecord(
        family=family, key=key, choice=tuple(entry["choice"]),
        score_s=float(entry["score_s"]),
        scores={tuple(c): float(s) for c, s in entry["scores"]},
        lowerings=0, swept=False,
        winner_events=dict(entry.get("winner_events") or {}),
        timer=entry.get("timer"))


def _roofline_seconds(ev, chip: hwinfo.ChipSpec) -> float:
    """max(compute term, memory term) from declared events (the CPU's
    score: no device time there)."""
    t_c = ev["FLOPS_TOTAL"] / chip.peak_bf16_flops
    t_m = ev["BYTES_ACCESSED"] / chip.hbm_bw
    return max(t_c, t_m)


def _tuned_spec(family: str, impl: Optional[str] = None) -> KernelSpec:
    fam = _family(family)
    if impl is not None:
        spec = get_spec(family, impl)
        if spec.tune is None:
            raise ValueError(f"{family}/{impl} declares no tune space")
        return spec
    tuned = [s for s in fam.impls.values() if s.tune is not None]
    if not tuned:
        raise ValueError(f"family {family!r} has no tunable impl")
    return tuned[0]


def _gated(ts: TuneSpace, cand: Tuple, facts: Dict[str, Any],
           smem_fraction: float) -> bool:
    """Whether ``cand`` needs more shared memory than a block may have."""
    need = ts.smem(tuple(cand), _itemsize(facts["dtype"]), **facts)
    return need > ts.smem_limit * smem_fraction


def autotune(family: str, session, *, impl: Optional[str] = None,
             candidates: Optional[Sequence[Tuple]] = None,
             chip: Optional[hwinfo.ChipSpec] = None,
             backend: Optional[str] = None,
             smem_fraction: float = 1.0, force: bool = False,
             **facts) -> TuneRecord:
    """Sweep the family's tune space for one shape; record + persist the
    winner(s).

    Each candidate that fits the shared-memory gate runs through
    ``session.measure`` on ``backend`` (default ``cuda``) at inputs made
    from a seed: scored by its measured device seconds on the card, by
    the roofline over its declared events on the CPU.  The candidates of
    one sweep are compared under one timer: when the profiler's records
    served some and CUDA events others, every candidate is timed again
    by events (``TuneRecord.timer``).  Warm start is
    two-level: a sweep whose persisted record matches (same tune key,
    same candidate set, same ``smem_fraction``, same toolchain) returns
    WITHOUT running anything (``swept=False`` — zero sweeps, zero timed
    probes); a changed candidate set re-sweeps, but each probe is itself
    a content-addressed cache entry, so even that re-times nothing that
    was measured before.  ``force=True`` ignores the persisted record.
    Winners land in the lock-guarded table :func:`best` consults and on
    disk for the next process.
    """
    spec = _tuned_spec(family, impl)
    ts = spec.tune
    backend = _backend(backend)
    facts = dict({**mesh_facts(), **facts}, backend=backend)
    facts.setdefault("dtype", torch.float32)
    key = ts.key(**facts)
    cands = tuple(tuple(c) for c in
                  (candidates if candidates is not None
                   else ts.candidates(**facts)))

    _note_tune_root(session.cache)
    digest = _tune_digest("tune-sweep", family, key)
    if not force:
        entry = session.cache.get(digest)
        if (entry is not None
                and entry.get("candidates") == [list(c) for c in cands]
                and entry.get("smem_fraction") == smem_fraction):
            try:
                rec = _entry_to_rec(family, key, entry)
                subs = [(rkey, tuple(sub["choice"]), float(sub["score_s"]),
                         dict(sub.get("winner_events") or {}))
                        for rkey, sub in (entry.get("records") or {}).items()]
            except (KeyError, TypeError, ValueError, AttributeError) as e:
                # schema-valid JSON, garbage content (truncated write,
                # hand edit, version skew): quarantine + fall through to
                # a fresh sweep instead of crashing a runner
                _quarantine_tune_entry(session.cache, digest, family,
                                       key, e)
            else:
                for rkey, rchoice, rscore, rev in subs:
                    _TABLE.put(TuneRecord(
                        family=family, key=rkey, choice=rchoice,
                        score_s=rscore, scores=rec.scores,
                        lowerings=0, swept=False, winner_events=rev,
                        timer=rec.timer))
                return rec

    lowerings0 = session.lowerings
    fits = [c for c in cands if not _gated(ts, c, facts, smem_fraction)]
    ms = _measure_candidates(ts, fits, facts, session, family, key, chip,
                             "auto")
    timers = {m.timer for m in ms.values()}
    if len(timers) > 1:          # profiler for some, events for others
        ms = _measure_candidates(ts, fits, facts, session, family, key,
                                 chip, "events")
        timers = {m.timer for m in ms.values()}
    scores: Dict[Tuple, float] = {}
    cand_events: Dict[Tuple, Dict[str, float]] = {}
    for cand in cands:
        m = ms.get(cand)
        if m is None:
            scores[cand] = float("inf")      # gated before anything runs
            continue
        scores[cand] = (m.device_s if m.device_s is not None
                        else _roofline_seconds(m.events, m.chip))
        cand_events[cand] = {
            "FLOPS_TOTAL": float(m.events["FLOPS_TOTAL"]),
            "BYTES_ACCESSED": float(m.events["BYTES_ACCESSED"]),
        }
    timer = timers.pop() if len(timers) == 1 else None

    finite = {c: s for c, s in scores.items() if s != float("inf")}
    if not finite:
        raise ValueError(f"no {family} candidate fits shared memory for "
                         f"{key} (candidates {cands})")
    choice, score = min(finite.items(), key=lambda kv: (kv[1], kv[0]))
    lowerings = session.lowerings - lowerings0
    rec = TuneRecord(family=family, key=key, choice=choice, score_s=score,
                     scores=scores, lowerings=lowerings, swept=True,
                     winner_events=cand_events.get(choice, {}), timer=timer)

    if ts.record_keys is not None:
        records = ts.record_keys(scores, **facts)
    else:
        records = {key: (choice, score)}
    rec_events = {rkey: cand_events.get(tuple(rchoice), {})
                  for rkey, (rchoice, _s) in records.items()}
    for rkey, (rchoice, rscore) in records.items():
        _TABLE.put(TuneRecord(family=family, key=rkey,
                              choice=tuple(rchoice), score_s=rscore,
                              scores=scores, lowerings=lowerings,
                              swept=True,
                              winner_events=rec_events.get(rkey, {}),
                              timer=timer))
    session.cache.put(digest, _rec_to_entry(rec, cands, smem_fraction,
                                            records, rec_events))
    for rkey, (rchoice, rscore) in records.items():
        session.cache.put(
            _tune_digest("tune-choice", family, rkey),
            {"kind": "tune-choice", "family": family, "key": rkey,
             "choice": list(rchoice), "score_s": rscore, "timer": timer,
             "winner_events": rec_events.get(rkey, {})})
    return rec


def _measure_candidates(ts: TuneSpace, cands: Sequence[Tuple],
                        facts: Dict[str, Any], session, family: str,
                        key: str, chip: Optional[hwinfo.ChipSpec],
                        timer: str) -> Dict[Tuple, Any]:
    """Each candidate's ``session.measure`` under ``timer``."""
    out = {}
    for cand in cands:
        fn, args = ts.probe(cand, **facts)
        out[cand] = session.measure(
            fn, *args, region=f"{family}[{key}]{list(cand)}", chip=chip,
            timer=timer)
        del fn, args
    return out


def _best_from_disk(family: str, key: str) -> Optional[Tuple]:
    """Resolve one tune key from the persisted caches; loads the record
    into the table on a hit, returns None (without negative-caching —
    the caller decides) on a miss."""
    digest = _tune_digest("tune-choice", family, key)
    for cache in _tune_caches():
        entry = cache.get(digest)
        if entry is None or "choice" not in entry:
            continue
        try:
            choice = tuple(entry["choice"])
            rec = TuneRecord(
                family=family, key=key, choice=choice,
                score_s=float(entry.get("score_s", "nan")),
                scores={}, lowerings=0, swept=False,
                winner_events=dict(entry.get("winner_events") or {}),
                timer=entry.get("timer"))
        except (TypeError, ValueError, AttributeError) as e:
            # a damaged persisted winner reads as a miss in THIS cache;
            # later roots may still hold a healthy copy
            _quarantine_tune_entry(cache, digest, family, key, e)
            continue
        _TABLE.put(rec)
        return choice
    return None


def _best_from_neighbors(family: str, ts: TuneSpace,
                         keyf: Callable[..., str], exact_key: str,
                         facts: Dict[str, Any]) -> Optional[Tuple]:
    """Cross-shape generalization: adopt the nearest tuned bucket's
    winner instead of falling to the declared default.  A neighbor's
    choice is only adopted when it passes the spec's shared-memory gate
    for the ACTUAL facts; the adoption is recorded under the exact key
    (``interpolated=True``), so a runner pays the neighbor scan once per
    process per shape."""
    for delta in ts.neighbors(**facts):
        nfacts = {**facts, **delta}
        nkey = keyf(**nfacts)
        if nkey == exact_key:
            continue
        rec = _TABLE.get(family, nkey)
        if rec is None and not _TABLE.missed(family, nkey):
            if _best_from_disk(family, nkey) is None:
                _TABLE.note_miss(family, nkey)
            else:
                rec = _TABLE.get(family, nkey)
        if rec is None:
            continue
        choice = rec.choice
        if _gated(ts, choice, facts, 1.0):
            continue                     # oversized for the actual shape
        _TABLE.put(TuneRecord(
            family=family, key=exact_key, choice=tuple(choice),
            score_s=rec.score_s, scores={}, lowerings=0, swept=False,
            winner_events=dict(rec.winner_events), interpolated=True))
        return tuple(choice)
    return None


def resolve(family: str, *, impl: Optional[str] = None,
            **facts) -> Tuple[Tuple, str]:
    """``(choice, source)`` of :func:`best`'s resolution, unmemoized:
    ``source`` is ``"swept"`` / ``"disk"`` (a record of the table, swept
    in this process or loaded from a persisted sweep), ``"neighbour"``
    (adopted from a nearby tuned bucket) or ``"default"``."""
    ts = _tuned_spec(family, impl).tune
    facts = {**mesh_facts(), **facts}
    facts = dict(facts, backend=_backend(facts.get("backend")))
    facts.setdefault("dtype", torch.float32)
    keyf = ts.lookup_key or ts.key
    key = keyf(**facts)
    rec = _TABLE.get(family, key)
    if rec is not None:
        return rec.choice, ("neighbour" if rec.interpolated else
                            "swept" if rec.swept else "disk")
    if not _TABLE.missed(family, key):
        choice = _best_from_disk(family, key)
        if choice is not None:
            return choice, "disk"
        _TABLE.note_miss(family, key)
    if ts.neighbors is not None:
        choice = _best_from_neighbors(family, ts, keyf, key, facts)
        if choice is not None:
            return choice, "neighbour"
    return ts.resolve_default(**facts), "default"


#: every call site :func:`best` resolved this process (family, impl,
#: facts), in first-seen order: what a launcher reports as served
_SITES: Dict[Any, Tuple[str, Optional[str], Dict[str, Any]]] = {}


def served_sites() -> List[Tuple[str, Optional[str], Dict[str, Any]]]:
    """``(family, impl, facts)`` of every call site :func:`best` resolved
    in this process."""
    return list(_SITES.values())


def best(family: str, *, impl: Optional[str] = None, **facts) -> Tuple:
    """The tuned choice for this shape: in-process table, else the
    disk-persisted record (a fresh process warm-starts with zero
    sweeps), else — for families declaring a ``neighbors`` hook — the
    nearest tuned bucket's winner (gated for the actual shape), else the
    spec's declared default.  The resolution is memoized per exact facts
    (the memo empties when the table changes), and a disk miss is
    negative-cached, so an untuned shape probes the filesystem once per
    process.  The runners, which ask on every call that names no tile,
    go through :func:`best_at`."""
    return best_at(family, impl, tuple(facts.items()), lambda: facts)


def best_at(family: str, impl: Optional[str], site: Tuple,
            facts: Callable[[], Dict[str, Any]]) -> Tuple:
    """:func:`best` memoized on ``site``, a key the caller forms cheaply
    from its call (the tensors' shapes, dtype and device type), which
    must fix the facts; ``facts()`` builds them only when the memo
    misses.  The ambient mesh facts join the memo key and the facts."""
    ambient = getattr(_TLS, "mesh_facts", None)
    mkey = (family, impl, site,
            tuple(ambient.items()) if ambient else None)
    hit = _TABLE.memo.get(mkey)
    if hit is not None:
        return hit
    gen = _TABLE.generation
    fa = {**(ambient or {}), **facts()}
    choice = resolve(family, impl=impl, **fa)[0]
    _TABLE.memo_put(mkey, choice, gen)
    _SITES.setdefault((family, impl, tuple(fa.items())),
                      (family, impl, dict(fa)))
    return choice


def record(family: str, key: str, choice: Tuple,
           score_s: float = float("nan")) -> None:
    """Pin a choice manually (e.g. replayed from a saved bench record);
    in-process only."""
    _TABLE.put(TuneRecord(family=family, key=key, choice=tuple(choice),
                          score_s=score_s, scores={}, lowerings=0,
                          swept=False))


def _seeded(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _randn(gen: torch.Generator, shape, dtype, scale: float = 1.0
           ) -> torch.Tensor:
    """Standard normal ``shape`` drawn in fp32 on the generator's device,
    scaled, then cast to ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return (x * scale if scale != 1.0 else x).to(_torch_dtype(dtype))


def _probe_device(backend: str) -> torch.device:
    return torch.device(_backend(backend))


# ===========================================================================
# family: attention (prefill; the model layout [B,S,H,Dh])
# ===========================================================================

def attention_tune_key(*, b: int, h: int, kvh: int, sq: int, sk: int,
                       dh: int, dtype, causal: bool = True,
                       backend: Optional[str] = None,
                       mesh_shape=None, mesh_axis=None,
                       per_device_heads=None, **_ignored) -> str:
    """Per-shape tune key, the reference's byte for byte.  ``b`` is
    bucketed to powers of two: the continuous-batching scheduler's live
    mix varies batch from segment to segment, and a winning (bq, bk)
    tiling is a per-row property.  Under a mesh the sharding facts join
    the key (:func:`mesh_key_tag`): each rank runs the kernel over its
    head slice."""
    return (f"b{_pow2_up(b)}h{h}kvh{kvh}sq{sq}sk{sk}dh{dh}"
            f"-{_dtype_name(dtype)}-{'causal' if causal else 'full'}"
            f"-{_backend(backend)}"
            + mesh_key_tag(mesh_shape=mesh_shape, mesh_axis=mesh_axis,
                           per_device_heads=per_device_heads))


def _attention_smem(cand, itemsize, *, dh, dtype, **facts) -> int:
    bq, bk = cand
    if tuple(cand) not in flash_mod.FLASH_PAIRS[_torch_dtype(dtype)]:
        return math.inf                 # not built for this dtype
    return flash_mod.flash_smem_bytes(bq, bk, dh, _torch_dtype(dtype))


def _flash_probe(q, k, v, kv_valid, *, causal: bool, bq: int, bk: int):
    """Module-level probe target: partial-wrapping this per candidate
    gives every (bq, bk) a stable cross-process fingerprint."""
    return flash_mod.flash_attention_bhsd(q, k, v, causal=causal,
                                          kv_valid=kv_valid, bq=bq, bk=bk)


def _flash_plain(q, k, v, kv_valid, *, causal: bool):
    return flash_mod.flash_attention_plain(q, k, v, causal=causal,
                                           kv_valid=kv_valid)


def _attention_probe(cand, *, b, h, kvh, sq, sk, dh, dtype, causal=True,
                     backend=None, **facts):
    bq, bk = cand
    gen = _seeded(_probe_device(backend), 0)
    args = (_randn(gen, (b, h, sq, dh), dtype),
            _randn(gen, (b, kvh, sk, dh), dtype),
            _randn(gen, (b, kvh, sk, dh), dtype),
            torch.full((b,), sk, dtype=torch.int32, device=gen.device))
    return functools.partial(_flash_probe, causal=causal, bq=bq, bk=bk), args


def _attention_neighbors(*, b: int, sq: int, sk: int, **_facts
                         ) -> List[Dict[str, Any]]:
    """Nearby tuned buckets, nearest first: the batch bucket one/two
    pow2 steps away (same sequence — a winning (bq, bk) tiling is a
    per-row property), then the whole sequence scaled by pow2 (sq and
    sk together)."""
    out: List[Dict[str, Any]] = []
    bb = _pow2_up(b)
    for f in (2, 4):
        if bb // f >= 1:
            out.append({"b": bb // f})
        out.append({"b": bb * f})
    for f in (2, 4):
        if sq // f >= 1 and sk // f >= 1:
            out.append({"sq": sq // f, "sk": sk // f})
        out.append({"sq": sq * f, "sk": sk * f})
    out.extend(_unsharded_fallback(_facts))
    return out


_ATTENTION_TUNE = TuneSpace(
    key=attention_tune_key,
    candidates=lambda *, dtype, **f: flash_mod.FLASH_PAIRS[
        _torch_dtype(dtype)],
    smem=_attention_smem,
    probe=_attention_probe,
    plain=lambda cand, *, causal=True, **f: functools.partial(
        _flash_plain, causal=causal),
    default=lambda *, dtype, **f: flash_mod.default_blocks(
        _torch_dtype(dtype)),
    neighbors=_attention_neighbors,
)

_ATTENTION_LAYOUT = ("q [B,Sq,H,Dh]; k/v [B,Sk,KVH,Dh] -> [B,Sq,H,Dh]; "
                     "q_offset host int, kv_len [B] int32 or None")


def _attention_facts(q, k, v, *, causal: bool = True,
                     chunk_threshold: int = 2048,
                     differentiable: bool = False, q_offset: int = 0,
                     kv_len=None, **_kw) -> Dict[str, Any]:
    return dict(sq=q.shape[1], sk=k.shape[1], dh=q.shape[-1], causal=causal,
                flash_min_seq=chunk_threshold, backend=q.device.type,
                differentiable=differentiable or needs_grad(q, k, v),
                dtype=q.dtype, q_offset=q_offset, ragged=kv_len is not None,
                heads=q.shape[2], kv_heads=k.shape[2])


def _attention_heuristic(*, sq: int, sk: int, dh: int, causal: bool = True,
                         backend: Optional[str] = None,
                         flash_min_seq: Optional[int] = None,
                         differentiable: bool = False, dtype=None,
                         q_offset: int = 0, ragged: bool = False,
                         heads: int = 1, kv_heads: int = 1) -> str:
    del sk, causal                  # part of the contract, unused for now
    if differentiable:
        if _backend(backend) == "cuda" and flash_train_mod.takes(
                dtype=dtype, dh=dh, q_offset=q_offset, ragged=ragged,
                heads=heads, kv_heads=kv_heads):
            return "cuda_flash_train"
        return "torch_flash"        # kernel #1 has no gradient
    if _backend(backend) == "cuda":
        return "cuda_flash"         # raises for a head dim it lacks
    if flash_min_seq is not None and sq > flash_min_seq:
        return "torch_flash"
    return "full"


register_family("attention", heuristic=_attention_heuristic,
                facts=_attention_facts, layout=_ATTENTION_LAYOUT)


def _bhsd(*ts):
    return tuple(t.transpose(1, 2) for t in ts)


@register_impl("attention", "cuda_flash", tune=_ATTENTION_TUNE,
               layout=_ATTENTION_LAYOUT,
               oracle="repro_torch.kernels.flash_attention."
                      "flash_attention_plain",
               # mesh fact: the kernel needs a whole kv head per device
               supports=lambda differentiable=False, per_device_heads=None,
                   **f: not differentiable and _heads_ok(per_device_heads))
def _run_cuda_flash(q, k, v, *, q_offset: int = 0, causal: bool = True,
                    kv_len=None, chunk_size: int = 512,
                    chunk_threshold: int = 2048,
                    blocks: Optional[Tuple[int, int]] = None,
                    differentiable: bool = False):
    """flash_attention_bhsd — kernel #1, blockwise online-softmax GQA."""
    if differentiable or needs_grad(q, k, v):
        _refuse_grad("attention", "cuda_flash")
    b, sq, h, dh = q.shape
    bq, bk = blocks or best_at(
        "attention", None, (q.shape, k.shape, q.dtype, causal,
                            q.device.type),
        lambda: dict(b=b, h=h, kvh=k.shape[2], sq=sq, sk=k.shape[1], dh=dh,
                     dtype=q.dtype, causal=causal, backend=q.device.type))
    out = flash_mod.flash_attention_bhsd(*_bhsd(q, k, v), causal=causal,
                                         q_offset=q_offset, kv_valid=kv_len,
                                         bq=bq, bk=bk)
    return out.transpose(1, 2)


@register_impl("attention", "torch_flash", layout=_ATTENTION_LAYOUT,
               oracle="repro_torch.kernels.flash_attention."
                      "flash_attention_plain")
def _run_torch_flash(q, k, v, *, q_offset: int = 0, causal: bool = True,
                     kv_len=None, chunk_size: int = 512,
                     chunk_threshold: int = 2048, blocks=None,
                     differentiable: bool = False):
    """the flash core as an autograd Function (the reference's
    jnp_flash), any device: online softmax forward, tile-recompute
    backward."""
    from repro_torch.models.attention import flash_attention_train
    out = flash_attention_train(q, k, v, q_offset, causal, kv_len=kv_len)
    qb, kb = _bhsd(q, k)
    flash_mod.declare_flash(qb, kb, kv_len, causal=causal,
                            q_offset=q_offset, launch=False)
    return out


@register_impl("attention", "full", layout=_ATTENTION_LAYOUT,
               oracle="repro_torch.kernels.flash_attention."
                      "flash_attention_plain")
def _run_full(q, k, v, *, q_offset: int = 0, causal: bool = True,
              kv_len=None, chunk_size: int = 512,
              chunk_threshold: int = 2048, blocks=None,
              differentiable: bool = False):
    """scores-materialized masked softmax (paper-faithful baseline)."""
    from repro_torch.models.attention import full_attention
    out = full_attention(q, k, v, q_offset=q_offset, causal=causal,
                         kv_len=kv_len, chunk_size=chunk_size,
                         chunk_threshold=chunk_threshold)
    qb, kb = _bhsd(q, k)
    flash_mod.declare_flash(qb, kb, kv_len, causal=causal,
                            q_offset=q_offset, launch=False)
    return out


@register_impl("attention", "cuda_flash_train", layout=_ATTENTION_LAYOUT,
               oracle="repro_torch.kernels.flash_attention_train."
                      "flash_train_plain_forward",
               supports=lambda per_device_heads=None, **f:
                   _heads_ok(per_device_heads))
def _run_cuda_flash_train(q, k, v, *, q_offset: int = 0,
                          causal: bool = True, kv_len=None,
                          chunk_size: int = 512, chunk_threshold: int = 2048,
                          blocks=None, differentiable: bool = False):
    """flash_train - the training kernels: forward, dQ, dK/dV, autograd."""
    if q_offset != 0 or kv_len is not None:
        raise ValueError("cuda_flash_train takes self-attention from "
                         "position 0 over every key: no q_offset, no "
                         "kv_len")
    return flash_train_mod.flash_train(q, k, v, causal=causal)


# ===========================================================================
# family: paged_decode (decode attention over the serve/kv_pool pages)
# ===========================================================================

_PAGED_LAYOUT = ("q4 [B,KVH,G,Dh]; k/v_pages [P,ps,KVH,Dh]; page_table "
                 "[B,NP] i32; lengths [B] i32; k/v_new [B,KVH,Dh] "
                 "-> [B,KVH,G,Dh]")
_PAGED_Q8_LAYOUT = (_PAGED_LAYOUT +
                    "; int8 pages + k/v_scale [P,ps] f32 per-token scales")


#: (page_size, split) grid: page_size trades pool fragmentation against a
#: page's copy size, split is the CTAs (one cluster) a row's pages spread
#: over (``paged_decode.split_plan`` picks it from shapes when untuned)
DEFAULT_PAGED_CANDIDATES: Tuple[Tuple[int, int], ...] = tuple(
    (ps, sp) for ps in (8, 16, 32) for sp in (1, 2, 4, 8))


def _paged_ctx_bucket(ctx) -> int:
    """Context is bucketed to powers of two: the scheduler's live table
    width drifts segment to segment, and a split tuned at ctx=512 serves
    ctx=700 fine."""
    return _pow2_up(max(int(ctx), 1))


def paged_lookup_key(*, b: int, kvh: int, g: int, dh: int, page_size: int,
                     dtype, ctx: int = 0, backend: Optional[str] = None,
                     quantized: bool = False, mesh_shape=None,
                     mesh_axis=None, per_device_heads=None,
                     **_ignored) -> str:
    """The reference's lookup key, byte for byte: keyed on the pow2 ctx
    BUCKET, not the raw page-table width; mesh facts join it (each rank
    walks its kv-head slice of the page pool)."""
    tag = "q8" if quantized else ""
    return (f"paged{tag}-b{b}kvh{kvh}g{g}dh{dh}ps{page_size}"
            f"ctx{_paged_ctx_bucket(ctx)}"
            f"-{_dtype_name(dtype)}-{_backend(backend)}"
            + mesh_key_tag(mesh_shape=mesh_shape, mesh_axis=mesh_axis,
                           per_device_heads=per_device_heads))


def paged_sweep_key(*, b: int, kvh: int, g: int, dh: int, ctx: int, dtype,
                    backend: Optional[str] = None,
                    quantized: bool = False, mesh_shape=None,
                    mesh_axis=None, per_device_heads=None,
                    **_ignored) -> str:
    tag = "q8" if quantized else ""
    return (f"paged{tag}-sweep-b{b}kvh{kvh}g{g}dh{dh}ctx{ctx}"
            f"-{_dtype_name(dtype)}-{_backend(backend)}"
            + mesh_key_tag(mesh_shape=mesh_shape, mesh_axis=mesh_axis,
                           per_device_heads=per_device_heads))


def _paged_smem(cand, itemsize, *, g, dh, **facts) -> int:
    ps, _split = cand
    return paged_mod.fp_smem_bytes(ps, dh, g, itemsize)


def _paged_inputs(ps: int, *, b, kvh, g, dh, ctx, dtype, backend,
                  quantized: bool):
    """A decode call's inputs, made from a seed: every row at ``ctx - 1``
    past tokens over a row-major table of ``ceil(ctx / ps)`` pages (page
    0 is the null page)."""
    np_w = max(-(-ctx // ps), 1)
    p_total = b * np_w + 1
    gen = _seeded(_probe_device(backend), 1)
    dev = gen.device
    if quantized:
        def codes():
            return torch.randint(-127, 128, (p_total, ps, kvh, dh),
                                 generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.int8)

        def scales():
            u = torch.rand((p_total, ps), generator=gen, device=dev)
            return 0.005 + 0.045 * u
        pages = (codes(), codes(), scales(), scales())
    else:
        pages = (_randn(gen, (p_total, ps, kvh, dh), dtype),
                 _randn(gen, (p_total, ps, kvh, dh), dtype))
    table = torch.arange(1, p_total, dtype=torch.int32,
                         device=dev).reshape(b, np_w)
    lengths = torch.full((b,), max(ctx - 1, 0), dtype=torch.int32,
                         device=dev)
    q4 = _randn(gen, (b, kvh, g, dh), dtype)
    kn = _randn(gen, (b, kvh, dh), dtype)
    vn = _randn(gen, (b, kvh, dh), dtype)
    return (q4, *pages, table, lengths, kn, vn)


def _paged_probe_fn(q4, kp, vp, pt, lens, kn, vn, *, split: int):
    """Module-level probe target (stable fingerprint per (page_size via
    shapes, split via partial) candidate)."""
    return paged_mod.paged_decode_attention_grouped(q4, kp, vp, pt, lens,
                                                    kn, vn, split=split)


def _paged_probe(cand, *, b, kvh, g, dh, ctx, dtype, backend=None,
                 **facts):
    ps, split = cand
    args = _paged_inputs(ps, b=b, kvh=kvh, g=g, dh=dh, ctx=ctx, dtype=dtype,
                         backend=backend, quantized=False)
    return functools.partial(_paged_probe_fn, split=split), args


def _paged_record_keys(scores, *, b, kvh, g, dh, dtype, ctx=0, backend=None,
                       quantized: bool = False, mesh_shape=None,
                       mesh_axis=None, per_device_heads=None,
                       **facts) -> Dict[str, Tuple[Tuple, float]]:
    """One lookup record per swept page_size: whatever page_size the pool
    was built with, a runner finds its winning split.  Mesh facts fan
    out with the sweep's."""
    per_ps: Dict[int, Tuple[Tuple, float]] = {}
    for (ps, split), s in scores.items():
        if s == float("inf"):
            continue
        cur = per_ps.get(ps)
        if cur is None or (s, split) < (cur[1], cur[0][1]):
            per_ps[ps] = ((ps, split), s)
    return {paged_lookup_key(b=b, kvh=kvh, g=g, dh=dh, page_size=ps,
                             ctx=ctx, dtype=dtype, backend=backend,
                             quantized=quantized, mesh_shape=mesh_shape,
                             mesh_axis=mesh_axis,
                             per_device_heads=per_device_heads): rec
            for ps, rec in per_ps.items()}


def _paged_neighbors(*, b: int, ctx: int = 0, **_facts
                     ) -> List[Dict[str, Any]]:
    """Nearby paged tune buckets, nearest first: the ctx bucket one/two
    pow2 steps away (live context widths vary request to request), then
    the batch scaled the same way (slot-count drift)."""
    out: List[Dict[str, Any]] = []
    cb = _paged_ctx_bucket(ctx)
    for f in (2, 4):
        if cb // f >= 1:
            out.append({"ctx": cb // f})
        out.append({"ctx": cb * f})
    for f in (2, 4):
        if b // f >= 1:
            out.append({"b": b // f})
        out.append({"b": b * f})
    out.extend(_unsharded_fallback(_facts))
    return out


def _paged_default(*, page_size, b, kvh, ctx=0, **_facts) -> Tuple[int, int]:
    """Today's launch: the pool's page size, :func:`split_plan`'s CTAs."""
    np_w = max(-(-int(ctx) // page_size), 1)
    return page_size, paged_mod.split_plan(b, kvh, np_w)


_PAGED_TUNE = TuneSpace(
    key=paged_sweep_key,
    candidates=lambda **f: DEFAULT_PAGED_CANDIDATES,
    smem=_paged_smem,
    probe=_paged_probe,
    plain=lambda cand, **f: paged_mod.paged_decode_plain,
    default=_paged_default,
    lookup_key=paged_lookup_key,
    record_keys=_paged_record_keys,
    neighbors=_paged_neighbors,
)


# --- int8 tune space: the same grid, its own keys (the winning split
# differs when pages are 4x smaller on the wire), a probe over int8 pages +
# f32 scales, and the int8 kernel's shared memory (no opt-in: 48 KiB)

def _paged_q8_sweep_key(**facts) -> str:
    facts.pop("quantized", None)
    return paged_sweep_key(quantized=True, **facts)


def _paged_q8_lookup_key(**facts) -> str:
    facts.pop("quantized", None)
    return paged_lookup_key(quantized=True, **facts)


def _paged_q8_record_keys(scores, **facts) -> Dict[str, Tuple[Tuple, float]]:
    facts.pop("quantized", None)
    return _paged_record_keys(scores, quantized=True, **facts)


def _paged_q8_smem(cand, itemsize, *, g, dh, **facts) -> int:
    ps, _split = cand
    return paged_mod.q8_smem_bytes(ps, dh, g)


def _paged_q8_probe_fn(q4, kp, vp, ksc, vsc, pt, lens, kn, vn, *,
                       split: int):
    return paged_mod.paged_decode_attention_q8_grouped(
        q4, kp, vp, ksc, vsc, pt, lens, kn, vn, split=split)


def _paged_q8_probe(cand, *, b, kvh, g, dh, ctx, dtype, backend=None,
                    **facts):
    ps, split = cand
    args = _paged_inputs(ps, b=b, kvh=kvh, g=g, dh=dh, ctx=ctx, dtype=dtype,
                         backend=backend, quantized=True)
    return functools.partial(_paged_q8_probe_fn, split=split), args


_PAGED_Q8_TUNE = TuneSpace(
    key=_paged_q8_sweep_key,
    candidates=lambda **f: DEFAULT_PAGED_CANDIDATES,
    smem=_paged_q8_smem,
    probe=_paged_q8_probe,
    plain=lambda cand, **f: paged_mod.paged_decode_q8_plain,
    default=_paged_default,
    lookup_key=_paged_q8_lookup_key,
    record_keys=_paged_q8_record_keys,
    neighbors=_paged_neighbors,
    smem_limit=paged_mod.Q8_SMEM_LIMIT,
)


def _paged_facts(q4, *_args, k_scale=None, **_kw) -> Dict[str, Any]:
    return dict(quantized=k_scale is not None, backend=q4.device.type)


def _paged_heuristic(*, backend: Optional[str] = None,
                     quantized: bool = False, **_facts) -> str:
    cuda = _backend(backend) == "cuda"
    if quantized:
        return "cuda_paged_q8" if cuda else "torch_paged_q8"
    return "cuda_paged" if cuda else "torch_paged"


register_family("paged_decode", heuristic=_paged_heuristic,
                facts=_paged_facts, layout=_PAGED_LAYOUT)


def _paged_split(impl: str, q4, k_pages, page_table) -> int:
    """The tuned split for a call (``best``; untuned: ``split_plan``)."""
    def facts():
        ps = k_pages.shape[1]
        b, kvh, g, dh = q4.shape
        return dict(b=b, kvh=kvh, g=g, dh=dh, page_size=ps,
                    ctx=page_table.shape[1] * ps, dtype=q4.dtype,
                    backend=q4.device.type)
    return best_at("paged_decode", impl,
                   (q4.shape, k_pages.shape[1], page_table.shape[1],
                    q4.dtype, q4.device.type), facts)[1]


@register_impl("paged_decode", "cuda_paged", tune=_PAGED_TUNE,
               layout=_PAGED_LAYOUT,
               oracle="repro_torch.kernels.paged_decode.paged_decode_plain",
               # the table-walking kernel needs a whole kv-head slice
               supports=lambda quantized=False, per_device_heads=None, **f:
                   not quantized and _heads_ok(per_device_heads))
def _run_cuda_paged(q4, k_pages, v_pages, page_table, lengths, k_new, v_new,
                    *, split: Optional[int] = None):
    """paged_decode_attention_grouped — kernel #2, a cluster per row."""
    return paged_mod.paged_decode_attention_grouped(
        q4, k_pages, v_pages, page_table, lengths, k_new, v_new,
        split=split or _paged_split("cuda_paged", q4, k_pages, page_table))


@register_impl("paged_decode", "torch_paged", layout=_PAGED_LAYOUT,
               oracle="repro_torch.kernels.paged_decode.paged_decode_plain",
               supports=lambda quantized=False, **f: not quantized)
def _run_torch_paged(q4, k_pages, v_pages, page_table, lengths, k_new,
                     v_new, *, split=None):
    """paged_decode_plain — gather the live pages, two-part softmax."""
    out = paged_mod.paged_decode_plain(q4, k_pages, v_pages, page_table,
                                       lengths, k_new, v_new)
    paged_mod.declare_paged(q4, k_pages, lengths, scales=False,
                            launch=False)
    return out


@register_impl("paged_decode", "cuda_paged_q8", tune=_PAGED_Q8_TUNE,
               layout=_PAGED_Q8_LAYOUT,
               oracle="repro_torch.kernels.paged_decode."
                      "paged_decode_q8_plain",
               supports=lambda quantized=False, per_device_heads=None, **f:
                   quantized and _heads_ok(per_device_heads))
def _run_cuda_paged_q8(q4, k_pages, v_pages, page_table, lengths, k_new,
                       v_new, *, k_scale, v_scale,
                       split: Optional[int] = None):
    """paged_decode_attention_q8_grouped — kernel #3 over int8 pages."""
    return paged_mod.paged_decode_attention_q8_grouped(
        q4, k_pages, v_pages, k_scale, v_scale, page_table, lengths, k_new,
        v_new, split=split or _paged_split("cuda_paged_q8", q4, k_pages,
                                           page_table))


@register_impl("paged_decode", "torch_paged_q8", layout=_PAGED_Q8_LAYOUT,
               oracle="repro_torch.kernels.paged_decode."
                      "paged_decode_q8_plain",
               supports=lambda quantized=False, **f: quantized)
def _run_torch_paged_q8(q4, k_pages, v_pages, page_table, lengths, k_new,
                        v_new, *, k_scale, v_scale, split=None):
    """paged_decode_q8_plain — gather and dequantize, two-part softmax."""
    out = paged_mod.paged_decode_q8_plain(q4, k_pages, v_pages, k_scale,
                                          v_scale, page_table, lengths,
                                          k_new, v_new)
    paged_mod.declare_paged(q4, k_pages, lengths, scales=True, launch=False)
    return out


# ===========================================================================
# family: stream_triad (paper case study 1, §III)
# ===========================================================================

LANES = triad_mod.LANES
#: rows of 128 a tile: the kernel's default is one 16-byte vector a thread
#: (8 rows of fp32, 16 of bf16), the others half to eight times that
_TRIAD_BLOCK_ROWS: Tuple[int, ...] = (4, 8, 16, 32, 64, 128)


def triad_tune_key(*, n: int, dtype, backend: Optional[str] = None,
                   **_ignored) -> str:
    return f"triad-n{n}-{_dtype_name(dtype)}-{_backend(backend)}"


def _triad_candidates(*, n: int, **facts) -> Tuple[Tuple[int], ...]:
    rows = max(n // LANES, 1)
    cands = tuple((br,) for br in _TRIAD_BLOCK_ROWS if br <= rows)
    return cands or ((rows,),)


def _triad_probe_fn(b, c, *, s: float, block_rows: int):
    """Module-level probe target for the triad block_rows sweep."""
    return triad_mod.stream_triad(b, c, s=s, block_rows=block_rows,
                                  pipelined=True)


def _triad_plain(b, c, *, s: float):
    return triad_mod.stream_triad_plain(b, c, s)


def _triad_probe(cand, *, n, dtype, backend=None, **facts):
    (br,) = cand
    gen = _seeded(_probe_device(backend), 2)
    args = (_randn(gen, (n,), dtype), _randn(gen, (n,), dtype))
    return functools.partial(_triad_probe_fn, s=2.5, block_rows=br), args


_TRIAD_TUNE = TuneSpace(
    key=triad_tune_key,
    candidates=_triad_candidates,
    smem=lambda cand, itemsize, **f: 0,      # registers only
    probe=_triad_probe,
    plain=lambda cand, **f: functools.partial(_triad_plain, s=2.5),
    default=lambda *, dtype, **f: (
        triad_mod.default_block_rows(_itemsize(dtype)),),
)

_TRIAD_LAYOUT = "b, c: flat [N] (N % 128 == 0) -> a = b + s*c"


def _triad_heuristic(*, backend: Optional[str] = None, **_facts) -> str:
    return "cuda_triad" if _backend(backend) == "cuda" else "torch_triad"


register_family("stream_triad", heuristic=_triad_heuristic,
                facts=lambda b, *a, **k: dict(backend=b.device.type),
                layout=_TRIAD_LAYOUT)


@register_impl("stream_triad", "cuda_triad", tune=_TRIAD_TUNE,
               layout=_TRIAD_LAYOUT,
               oracle="repro_torch.kernels.stream_triad.stream_triad_plain")
def _run_cuda_triad(b, c, *, s: float = 2.5,
                    block_rows: Optional[int] = None,
                    pipelined: bool = True):
    """stream_triad — kernel #6, the HBM-stream case study."""
    br = block_rows or best_at(
        "stream_triad", None, (b.shape, b.dtype, b.device.type),
        lambda: dict(n=b.shape[0], dtype=b.dtype,
                     backend=b.device.type))[0]
    return triad_mod.stream_triad(b, c, s=s, block_rows=br,
                                  pipelined=pipelined)


@register_impl("stream_triad", "torch_triad", layout=_TRIAD_LAYOUT,
               oracle="repro_torch.kernels.stream_triad.stream_triad_plain")
def _run_torch_triad(b, c, *, s: float = 2.5, block_rows=None,
                     pipelined: bool = True):
    """stream_triad_plain — fp32 math, one rounding (the baseline)."""
    out = triad_mod.stream_triad_plain(b, c, s)
    triad_mod.declare_triad(b, launch=False)
    return out


# ===========================================================================
# family: jacobi7 (paper case studies 2+3, §IV-§V)
# ===========================================================================

#: x extents a CTA's column streams: the default (``jacobi7.BLOCK_X``,
#: 128) and a quarter to twice it
_JACOBI_BLOCK_X: Tuple[int, ...] = (32, 64, 128, 256)


def jacobi_tune_key(*, shape: Tuple[int, int, int], sweeps: int, dtype,
                    backend: Optional[str] = None, **_ignored) -> str:
    x, y, z = shape
    return (f"jacobi7-x{x}y{y}z{z}t{sweeps}"
            f"-{_dtype_name(dtype)}-{_backend(backend)}")


def _jacobi_candidates(*, shape, sweeps, **facts) -> Tuple[Tuple[int], ...]:
    ox = shape[0] - 2 * sweeps
    cands = tuple((bx,) for bx in _JACOBI_BLOCK_X if bx <= ox)
    return cands or ((max(ox, 1),),)


def _jacobi_smem(cand, itemsize, *, shape, sweeps, **facts) -> float:
    """The planes' bytes (independent of ``block_x``: the x extent
    streams), or inf when the tile needs more threads than a block has."""
    (bx,) = cand
    tile = (bx, *jacobi_mod.TILE_YZ)
    if jacobi_mod.block_threads(sweeps, tile) > jacobi_mod.MAX_THREADS:
        return math.inf
    return jacobi_mod.smem_footprint(sweeps, tile, itemsize)


def _jacobi_probe_fn(x, *, sweeps: int, block_x: int):
    """Module-level probe target for the jacobi7 block_x sweep."""
    return jacobi_mod.jacobi7_wavefront(x, sweeps=sweeps, block_x=block_x)


def _jacobi_probe(cand, *, shape, sweeps, dtype, backend=None, **facts):
    (bx,) = cand
    gen = _seeded(_probe_device(backend), 3)
    return (functools.partial(_jacobi_probe_fn, sweeps=sweeps, block_x=bx),
            (_randn(gen, tuple(shape), dtype),))


_JACOBI_TUNE = TuneSpace(
    key=jacobi_tune_key,
    candidates=_jacobi_candidates,
    smem=_jacobi_smem,
    probe=_jacobi_probe,
    plain=lambda cand, *, sweeps, **f: functools.partial(
        jacobi_mod.jacobi7_valid_plain, sweeps=sweeps),
    default=(jacobi_mod.BLOCK_X,),
)

_JACOBI_LAYOUT = ("x [X,Y,Z] fp32 -> [X-2T,Y-2T,Z-2T] after T = sweeps "
                  "valid-mode 7-point sweeps")


def _jacobi_heuristic(**_facts) -> str:
    # the wavefront variant IS the paper's point (T sweeps per residency);
    # naive is the per-sweep-round-trip baseline
    return "wavefront"


register_family("jacobi7", heuristic=_jacobi_heuristic,
                layout=_JACOBI_LAYOUT)


@register_impl("jacobi7", "wavefront", tune=_JACOBI_TUNE,
               layout=_JACOBI_LAYOUT,
               oracle="repro_torch.kernels.jacobi7.jacobi7_valid_plain")
def _run_jacobi_wavefront(x, *, sweeps: int = 1, omega: float = 1.0 / 6.0,
                          block_x: Optional[int] = None):
    """T sweeps a launch of kernel #7 (~1 HBM round-trip in all)."""
    bx = block_x or best_at(
        "jacobi7", None, (x.shape, sweeps, x.dtype, x.device.type),
        lambda: dict(shape=tuple(x.shape), sweeps=sweeps, dtype=x.dtype,
                     backend=x.device.type))[0]
    return jacobi_mod.jacobi7_wavefront(x, sweeps=sweeps, omega=omega,
                                        block_x=bx)


@register_impl("jacobi7", "naive", layout=_JACOBI_LAYOUT,
               oracle="repro_torch.kernels.jacobi7.jacobi7_valid_plain")
def _run_jacobi_naive(x, *, sweeps: int = 1, omega: float = 1.0 / 6.0,
                      block_x: Optional[int] = None):
    """one sweep a launch — T sweeps cost T full HBM round-trips."""
    for _ in range(sweeps):
        x = jacobi_mod.jacobi7_naive(
            x, omega=omega, block_x=block_x or jacobi_mod.BLOCK_X)
    return x


# ===========================================================================
# family: ssd_scan (mLSTM / Mamba2 chunked gated linear attention)
# ===========================================================================

DEFAULT_SSD_CHUNK = 128

#: chunks both routes take (1..1024; the bf16 route pads a chunk to 64)
_SSD_CHUNKS: Tuple[int, ...] = (32, 64, 128, 256, 512)


def ssd_tune_key(*, b: int, s: int, h: int, dk: int, dv: int,
                 normalize: bool = False, dtype,
                 backend: Optional[str] = None, **_ignored) -> str:
    return (f"ssd-b{b}s{s}h{h}dk{dk}dv{dv}"
            f"-{'norm' if normalize else 'raw'}"
            f"-{_dtype_name(dtype)}-{_backend(backend)}")


def _ssd_candidates(*, s: int, **facts) -> Tuple[Tuple[int], ...]:
    cands = tuple((c,) for c in _SSD_CHUNKS if c <= s)
    return cands or ((s,),)


def _ssd_smem(cand, itemsize, *, dk, dtype, **facts) -> int:
    (c,) = cand
    return ssd_mod.ssd_smem_bytes(c, dk, _torch_dtype(dtype))


def _ssd_probe_fn(q, k, v, lf, li, *, chunk: int, normalize: bool):
    """Module-level probe target for the ssd chunk sweep."""
    return ssd_mod.ssd_scan(q, k, v, lf, li, chunk=chunk,
                            normalize=normalize)


def _ssd_plain(q, k, v, lf, li, *, chunk: int, normalize: bool):
    return _chunked_linear_attention(q, k, v, lf, li, chunk_size=chunk,
                                     normalize=normalize)


def _ssd_probe(cand, *, b, s, h, dk, dv, dtype, normalize=False,
               backend=None, **facts):
    (c,) = cand
    gen = _seeded(_probe_device(backend), 4)
    q = _randn(gen, (b, s, h, dk), dtype, dk ** -0.25)
    k = _randn(gen, (b, s, h, dk), dtype, dk ** -0.25)
    if normalize:
        q, k = q.abs(), k.abs()
    v = _randn(gen, (b, s, h, dv), dtype)
    lf = -torch.nn.functional.softplus(_randn(gen, (b, s, h), torch.float32))
    li = -torch.nn.functional.softplus(_randn(gen, (b, s, h), torch.float32))
    return (functools.partial(_ssd_probe_fn, chunk=c, normalize=normalize),
            (q, k, v, lf, li))


def _ssd_neighbors(*, b: int, s: int, **_facts) -> List[Dict[str, Any]]:
    """Nearby tuned buckets for the chunk sweep: batch first (chunk is a
    per-row property), then sequence length by pow2 steps."""
    out: List[Dict[str, Any]] = []
    for f in (2, 4):
        if b // f >= 1:
            out.append({"b": b // f})
        out.append({"b": b * f})
    for f in (2, 4):
        if s // f >= 1:
            out.append({"s": s // f})
        out.append({"s": s * f})
    return out


_SSD_TUNE = TuneSpace(
    key=ssd_tune_key,
    candidates=_ssd_candidates,
    smem=_ssd_smem,
    probe=_ssd_probe,
    plain=lambda cand, *, normalize=False, **f: functools.partial(
        _ssd_plain, chunk=cand[0], normalize=normalize),
    default=(DEFAULT_SSD_CHUNK,),
    neighbors=_ssd_neighbors,
)

_SSD_LAYOUT = ("q,k [B,S,H,dk]; v [B,S,H,dv]; log_f/log_i [B,S,H] (<=0); "
               "initial_state (C, n) or None -> (y [B,S,H,dv], "
               "(C [B,H,dk,dv], n [B,H,dk]))")


def _ssd_heuristic(*, backend: Optional[str] = None,
                   differentiable: bool = False, **_facts) -> str:
    if differentiable:
        return "torch_scan"         # the kernel has no gradient
    return "cuda_ssd" if _backend(backend) == "cuda" else "torch_scan"


def _ssd_facts(q, k, v, log_f, log_i, *, initial_state=None,
               differentiable: bool = False, **_kw) -> Dict[str, Any]:
    return dict(backend=q.device.type,
                differentiable=differentiable or needs_grad(
                    q, k, v, log_f, log_i, *(initial_state or ())))


register_family("ssd_scan", heuristic=_ssd_heuristic, facts=_ssd_facts,
                layout=_SSD_LAYOUT)


def _ssd_chunk(q, v, chunk: Optional[int], normalize: bool) -> int:
    if chunk is not None:
        return chunk
    b, s, h, dk = q.shape
    return best_at("ssd_scan", None,
                   (q.shape, v.shape[-1], normalize, q.dtype,
                    q.device.type),
                   lambda: dict(b=b, s=s, h=h, dk=dk, dv=v.shape[-1],
                                normalize=normalize, dtype=q.dtype,
                                backend=q.device.type))[0]


@register_impl("ssd_scan", "cuda_ssd", tune=_SSD_TUNE, layout=_SSD_LAYOUT,
               oracle="repro_torch.kernels.ssd_scan.ssd_scan_ref",
               supports=lambda differentiable=False, **f: not differentiable)
def _run_cuda_ssd(q, k, v, log_f, log_i, *, chunk: Optional[int] = None,
                  normalize: bool = False, eps: float = 1e-6,
                  initial_state=None, differentiable: bool = False):
    """ssd_scan — kernel #5, chunk-parallel with a carried state."""
    if differentiable or needs_grad(q, k, v, log_f, log_i,
                                    *(initial_state or ())):
        _refuse_grad("ssd_scan", "cuda_ssd")
    return ssd_mod.ssd_scan(q, k, v, log_f, log_i,
                            chunk=_ssd_chunk(q, v, chunk, normalize),
                            normalize=normalize, eps=eps,
                            initial_state=initial_state)


@register_impl("ssd_scan", "torch_scan", layout=_SSD_LAYOUT,
               oracle="repro_torch.kernels.ssd_scan.ssd_scan_ref")
def _run_torch_scan(q, k, v, log_f, log_i, *,
                    chunk: Optional[int] = None, normalize: bool = False,
                    eps: float = 1e-6, initial_state=None,
                    differentiable: bool = False):
    """chunk-parallel plain twin (the CPU's choice)."""
    chunk = _ssd_chunk(q, v, chunk, normalize)
    y, state = _chunked_linear_attention(
        q, k, v, log_f, log_i, chunk_size=chunk, normalize=normalize,
        eps=eps, initial_state=initial_state)
    ssd_mod.declare_ssd(q, k, v, log_f, log_i, y, chunk,
                        initial_state is not None,
                        f32=q.device.type == "cpu" or v.dtype == torch.float32,
                        launch=False)
    return y, state


# ===========================================================================
# family: sampling (greedy / top-k / top-p over argmax #4)
# ===========================================================================

#: argmax CTAs a row: one up to the portable cluster size
_SAMPLING_SPLITS: Tuple[int, ...] = (1, 2, 4, 8)
_SAMPLING_SUFFIX = {"greedy": "greedy", "top_k": "topk", "top_p": "topp"}


def sampling_tune_key(*, b: int, v: int, method: str, dtype,
                      backend: Optional[str] = None, **_ignored) -> str:
    return (f"sampling-b{_pow2_up(b)}v{_pow2_up(v)}-{method}-"
            f"{_dtype_name(dtype)}-{_backend(backend)}")


def _sampling_candidates(*, v: int, **_facts) -> Tuple[Tuple[int], ...]:
    """The splits whose 8-element chunks fill a row of ``v`` exactly."""
    return tuple((sp,) for sp in _SAMPLING_SPLITS
                 if sampling_mod.argmax_chunk(v, sp)[0] == sp) or ((1,),)


def _sampling_generator(logits, method: str):
    return (None if method == "greedy"
            else _seeded(logits.device, 0))


def _sampling_probe_fn(logits, *, method: str, split: int):
    """Module-level probe target for the split sweep: one step of
    ``method`` (top-k 8, top-p 0.9, a generator seeded with 0)."""
    runner = get_spec("sampling", "cuda_" + _SAMPLING_SUFFIX[method]).fn
    return runner(logits, _sampling_generator(logits, method),
                  method=method, temperature=1.0,
                  k=min(8, logits.shape[-1]), p=0.9, split=split)


def _sampling_plain(logits, *, method: str):
    return sampling_mod.sample_ref(
        logits, _sampling_generator(logits, method), method=method,
        temperature=1.0, k=min(8, logits.shape[-1]), p=0.9)


def _sampling_probe(cand, *, b, v, method, dtype, backend=None, **_facts):
    gen = _seeded(_probe_device(backend), 5)
    return (functools.partial(_sampling_probe_fn, method=method,
                              split=cand[0]),
            (_randn(gen, (b, v), dtype),))


_SAMPLING_TUNE = TuneSpace(
    key=sampling_tune_key,
    candidates=_sampling_candidates,
    smem=lambda cand, itemsize, **f: sampling_mod.ARGMAX_SMEM_BYTES,
    probe=_sampling_probe,
    plain=lambda cand, *, method, **f: functools.partial(
        _sampling_plain, method=method),
    default=lambda *, b, v, **f: (sampling_mod.argmax_plan(b, v)[0],),
)

_SAMPLING_LAYOUT = ("logits [B,V] fp32 or bf16; generator (a "
                    "torch.Generator on the logits' device; None for "
                    "greedy) -> tokens [B] int32")
_SAMPLING_ORACLE = "repro_torch.kernels.sampling.sample_ref"


def _sampling_heuristic(*, method: str = "greedy",
                        backend: Optional[str] = None, **_facts) -> str:
    if method not in _SAMPLING_SUFFIX:
        raise ValueError(f"unknown sampling method {method!r}; choose from "
                         f"{sampling_mod.METHODS}")
    return (("cuda_" if _backend(backend) == "cuda" else "torch_")
            + _SAMPLING_SUFFIX[method])


def _sampling_facts(logits, generator=None, *, method: str = "greedy",
                    **_kw) -> Dict[str, Any]:
    b, v = logits.shape
    return dict(b=b, v=v, method=method, dtype=logits.dtype,
                backend=logits.device.type)


register_family("sampling", heuristic=_sampling_heuristic,
                facts=_sampling_facts, layout=_SAMPLING_LAYOUT)


def _plain_argmax(x):
    out = sampling_mod.argmax_plain(x)
    sampling_mod._declare(x, launch=False)
    return out


def _kernel_argmax(x, method: str, split: Optional[int]):
    if split is None:
        b, v = x.shape
        split = best_at("sampling", "cuda_" + _SAMPLING_SUFFIX[method],
                        (x.shape, method, x.dtype, x.device.type),
                        lambda: dict(b=b, v=v, method=method, dtype=x.dtype,
                                     backend=x.device.type))[0]
    return sampling_mod.block_argmax(x, split=split)


@register_impl("sampling", "torch_greedy", layout=_SAMPLING_LAYOUT,
               oracle=_SAMPLING_ORACLE,
               supports=lambda method="greedy", **f: method == "greedy")
def _run_torch_greedy(logits, generator=None, *, method: str = "greedy",
                      temperature: float = 0.0, k: int = 0, p: float = 1.0,
                      split=None):
    """argmax_plain — the generator is unused by contract."""
    return _plain_argmax(logits)


@register_impl("sampling", "torch_topk", layout=_SAMPLING_LAYOUT,
               oracle=_SAMPLING_ORACLE,
               supports=lambda method="greedy", **f: method == "top_k")
def _run_torch_topk(logits, generator=None, *, method: str = "top_k",
                    temperature: float = 1.0, k: int = 0, p: float = 1.0,
                    split=None):
    """top-k threshold filter, Gumbel shift, argmax_plain."""
    return _plain_argmax(sampling_mod._shifted(logits, generator, "top_k",
                                               temperature, k, p))


@register_impl("sampling", "torch_topp", layout=_SAMPLING_LAYOUT,
               oracle=_SAMPLING_ORACLE,
               supports=lambda method="greedy", **f: method == "top_p")
def _run_torch_topp(logits, generator=None, *, method: str = "top_p",
                    temperature: float = 1.0, k: int = 0, p: float = 1.0,
                    split=None):
    """nucleus filter, Gumbel shift, argmax_plain."""
    return _plain_argmax(sampling_mod._shifted(logits, generator, "top_p",
                                               temperature, k, p))


@register_impl("sampling", "cuda_greedy", tune=_SAMPLING_TUNE,
               layout=_SAMPLING_LAYOUT, oracle=_SAMPLING_ORACLE,
               supports=lambda method="greedy", **f: method == "greedy")
def _run_cuda_greedy(logits, generator=None, *, method: str = "greedy",
                     temperature: float = 0.0, k: int = 0, p: float = 1.0,
                     split: Optional[int] = None):
    """block_argmax — kernel #4, a cluster of CTAs a row."""
    return _kernel_argmax(logits, "greedy", split)


@register_impl("sampling", "cuda_topk", tune=_SAMPLING_TUNE,
               layout=_SAMPLING_LAYOUT, oracle=_SAMPLING_ORACLE,
               supports=lambda method="greedy", **f: method == "top_k")
def _run_cuda_topk(logits, generator=None, *, method: str = "top_k",
                   temperature: float = 1.0, k: int = 0, p: float = 1.0,
                   split: Optional[int] = None):
    """top-k filter + Gumbel shift as tensor ops, kernel #4's argmax."""
    return _kernel_argmax(sampling_mod._shifted(
        logits, generator, "top_k", temperature, k, p), "top_k", split)


@register_impl("sampling", "cuda_topp", tune=_SAMPLING_TUNE,
               layout=_SAMPLING_LAYOUT, oracle=_SAMPLING_ORACLE,
               supports=lambda method="greedy", **f: method == "top_p")
def _run_cuda_topp(logits, generator=None, *, method: str = "top_p",
                   temperature: float = 1.0, k: int = 0, p: float = 1.0,
                   split: Optional[int] = None):
    """nucleus filter + Gumbel shift as tensor ops, kernel #4's argmax."""
    return _kernel_argmax(sampling_mod._shifted(
        logits, generator, "top_p", temperature, k, p), "top_p", split)
