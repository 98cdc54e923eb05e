"""One kernel registry: named impls and one override ladder.

Port of the selection half of ``repro/kernels/registry.py`` (LIKWID's API
bet, the paper's §II: a small, stable, named surface you can force from
the environment).  Every implementation is a :class:`KernelSpec`
registered with :func:`register_impl`; each family has a heuristic and a
fact extractor (:func:`register_family`).  :func:`select` resolves one
override ladder per family: the :func:`use_impl` thread-local context,
then ``REPRO_IMPL`` (``"attention=cuda_flash,paged_decode=torch_paged"``),
then the legacy ``REPRO_ATTN_IMPL`` name (mapped onto the attention and
paged_decode families, :data:`LEGACY_ATTN_MAP`), then the heuristic.
``ServeConfig.impls`` / ``attn_impl`` and the launcher's ``--impl`` pin
through the same context.

Impl names name the port's routes, one to one with the reference's
(:data:`REFERENCE_NAMES`):

=============  ===================  ====================================
family         reference            port
=============  ===================  ====================================
attention      pallas_flash         cuda_flash   (kernel #1)
               jnp_flash            torch_flash  (its plain version)
               full                 full         (masked softmax over
                                                 materialized scores)
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
=============  ===================  ====================================

Both packages read the same ``REPRO_IMPL``, so :func:`parse_impl_spec`,
:func:`use_impl` and :func:`get_spec` also take the reference's names and
return the port's.  Argmax (#4) stays outside, called directly in both
packages; the reference's ``sampling`` family has no registration here.

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
  lookups.

Not ported yet: ``TuneSpace``, ``autotune``, ``best``, ``record``, the
tune table and its persistence, and the mesh facts (``ROADMAP.md``,
queue 1 items 11 and 14); :func:`describe` shows no tunable impl.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import jacobi7 as jacobi_mod
from repro_torch.kernels import paged_decode as paged_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels import stream_triad as triad_mod
from repro_torch.models.linear_scan import _chunked_linear_attention

__all__ = [
    "KernelSpec", "register_impl", "register_family", "families", "impls",
    "get_spec", "describe", "use_impl", "parse_impl_spec", "override_for",
    "select", "run", "LEGACY_ATTN_MAP", "REFERENCE_NAMES",
    "legacy_mapping", "env_snapshot",
]


def _backend(backend: Optional[str]) -> str:
    return backend or "cuda"


# ---------------------------------------------------------------------------
# the data model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered implementation, declared in one place."""

    family: str
    name: str
    fn: Callable                               # runner, model layout
    supports: Optional[Callable[..., bool]] = None   # static capability
    layout: str = ""                           # calling-convention contract
    oracle: str = ""                           # dotted path of the oracle
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
}


def register_impl(family: str, name: str, *,
                  supports: Optional[Callable[..., bool]] = None,
                  layout: str = "", oracle: str = "") -> Callable:
    """Decorator: register the wrapped callable as impl ``name`` of
    ``family``.  The callable is the runner (model layout in, model
    layout out); registration is declarative — no ladder code."""
    def deco(fn: Callable) -> Callable:
        fam = _FAMILIES.setdefault(family, _Family(name=family))
        fam.impls[name] = KernelSpec(
            family=family, name=name, fn=fn, supports=supports,
            layout=layout, oracle=oracle,
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
    """Human-readable registry table (families, impls)."""
    lines = []
    for fname in families():
        for spec in _FAMILIES[fname].impls.values():
            lines.append(f"{fname:>13}  {spec.name:<15} {spec.doc}")
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


def select(family: str, **facts) -> str:
    """Pick an implementation name from static facts.

    An override (context / env) beats the heuristic; unforced, the
    family's heuristic decides."""
    fam = _family(family)
    forced = override_for(family)
    if forced is not None:
        return forced
    return fam.heuristic(**facts)


def run(family: str, *args, impl: Optional[str] = None, **kwargs):
    """Run ``family`` on model-layout args; ``impl=None`` self-selects
    via the family's fact extractor + :func:`select`."""
    fam = _family(family)
    if impl is None:
        facts = fam.facts(*args, **kwargs) if fam.facts is not None else {}
        impl = select(family, **facts)
    return get_spec(family, impl).fn(*args, **kwargs)


# ===========================================================================
# family: attention (prefill; the model layout [B,S,H,Dh])
# ===========================================================================

_ATTENTION_LAYOUT = ("q [B,Sq,H,Dh]; k/v [B,Sk,KVH,Dh] -> [B,Sq,H,Dh]; "
                     "q_offset host int, kv_len [B] int32 or None")


def _attention_facts(q, k, v, *, causal: bool = True,
                     chunk_threshold: int = 2048, **_kw) -> Dict[str, Any]:
    return dict(sq=q.shape[1], sk=k.shape[1], dh=q.shape[-1], causal=causal,
                flash_min_seq=chunk_threshold, backend=q.device.type)


def _attention_heuristic(*, sq: int, sk: int, dh: int, causal: bool = True,
                         backend: Optional[str] = None,
                         flash_min_seq: Optional[int] = None) -> str:
    del sk, dh, causal              # part of the contract, unused for now
    if _backend(backend) == "cuda":
        return "cuda_flash"         # raises for a head dim it lacks
    if flash_min_seq is not None and sq > flash_min_seq:
        return "torch_flash"
    return "full"


register_family("attention", heuristic=_attention_heuristic,
                facts=_attention_facts, layout=_ATTENTION_LAYOUT)


def _bhsd(*ts):
    return tuple(t.transpose(1, 2) for t in ts)


@register_impl("attention", "cuda_flash", layout=_ATTENTION_LAYOUT,
               oracle="repro_torch.kernels.flash_attention."
                      "flash_attention_plain")
def _run_cuda_flash(q, k, v, *, q_offset: int = 0, causal: bool = True,
                    kv_len=None, chunk_size: int = 512,
                    chunk_threshold: int = 2048):
    """flash_attention_bhsd — kernel #1, blockwise online-softmax GQA."""
    out = flash_mod.flash_attention_bhsd(*_bhsd(q, k, v), causal=causal,
                                         q_offset=q_offset, kv_valid=kv_len)
    return out.transpose(1, 2)


@register_impl("attention", "torch_flash", layout=_ATTENTION_LAYOUT,
               oracle="repro_torch.kernels.flash_attention."
                      "flash_attention_plain")
def _run_torch_flash(q, k, v, *, q_offset: int = 0, causal: bool = True,
                     kv_len=None, chunk_size: int = 512,
                     chunk_threshold: int = 2048):
    """flash_attention_plain — kernel #1's plain version, any device."""
    qb, kb, vb = _bhsd(q, k, v)
    out = flash_mod.flash_attention_plain(qb, kb, vb, causal=causal,
                                          q_offset=q_offset, kv_valid=kv_len)
    flash_mod.declare_flash(qb, kb, kv_len, causal=causal,
                            q_offset=q_offset, launch=False)
    return out.transpose(1, 2)


@register_impl("attention", "full", layout=_ATTENTION_LAYOUT,
               oracle="repro_torch.kernels.flash_attention."
                      "flash_attention_plain")
def _run_full(q, k, v, *, q_offset: int = 0, causal: bool = True,
              kv_len=None, chunk_size: int = 512,
              chunk_threshold: int = 2048):
    """scores-materialized masked softmax (paper-faithful baseline)."""
    from repro_torch.models.attention import full_attention
    out = full_attention(q, k, v, q_offset=q_offset, causal=causal,
                         kv_len=kv_len, chunk_size=chunk_size,
                         chunk_threshold=chunk_threshold)
    qb, kb = _bhsd(q, k)
    flash_mod.declare_flash(qb, kb, kv_len, causal=causal,
                            q_offset=q_offset, launch=False)
    return out


# ===========================================================================
# family: paged_decode (decode attention over the serve/kv_pool pages)
# ===========================================================================

_PAGED_LAYOUT = ("q4 [B,KVH,G,Dh]; k/v_pages [P,ps,KVH,Dh]; page_table "
                 "[B,NP] i32; lengths [B] i32; k/v_new [B,KVH,Dh] "
                 "-> [B,KVH,G,Dh]")
_PAGED_Q8_LAYOUT = (_PAGED_LAYOUT +
                    "; int8 pages + k/v_scale [P,ps] f32 per-token scales")


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


@register_impl("paged_decode", "cuda_paged", layout=_PAGED_LAYOUT,
               oracle="repro_torch.kernels.paged_decode.paged_decode_plain",
               supports=lambda quantized=False, **f: not quantized)
def _run_cuda_paged(q4, k_pages, v_pages, page_table, lengths, k_new, v_new):
    """paged_decode_attention_grouped — kernel #2, a cluster per row."""
    return paged_mod.paged_decode_attention_grouped(
        q4, k_pages, v_pages, page_table, lengths, k_new, v_new)


@register_impl("paged_decode", "torch_paged", layout=_PAGED_LAYOUT,
               oracle="repro_torch.kernels.paged_decode.paged_decode_plain",
               supports=lambda quantized=False, **f: not quantized)
def _run_torch_paged(q4, k_pages, v_pages, page_table, lengths, k_new,
                     v_new):
    """paged_decode_plain — gather the live pages, two-part softmax."""
    out = paged_mod.paged_decode_plain(q4, k_pages, v_pages, page_table,
                                       lengths, k_new, v_new)
    paged_mod.declare_paged(q4, k_pages, lengths, scales=False,
                            launch=False)
    return out


@register_impl("paged_decode", "cuda_paged_q8", layout=_PAGED_Q8_LAYOUT,
               oracle="repro_torch.kernels.paged_decode."
                      "paged_decode_q8_plain",
               supports=lambda quantized=False, **f: quantized)
def _run_cuda_paged_q8(q4, k_pages, v_pages, page_table, lengths, k_new,
                       v_new, *, k_scale, v_scale):
    """paged_decode_attention_q8_grouped — kernel #3 over int8 pages."""
    return paged_mod.paged_decode_attention_q8_grouped(
        q4, k_pages, v_pages, k_scale, v_scale, page_table, lengths, k_new,
        v_new)


@register_impl("paged_decode", "torch_paged_q8", layout=_PAGED_Q8_LAYOUT,
               oracle="repro_torch.kernels.paged_decode."
                      "paged_decode_q8_plain",
               supports=lambda quantized=False, **f: quantized)
def _run_torch_paged_q8(q4, k_pages, v_pages, page_table, lengths, k_new,
                        v_new, *, k_scale, v_scale):
    """paged_decode_q8_plain — gather and dequantize, two-part softmax."""
    out = paged_mod.paged_decode_q8_plain(q4, k_pages, v_pages, k_scale,
                                          v_scale, page_table, lengths,
                                          k_new, v_new)
    paged_mod.declare_paged(q4, k_pages, lengths, scales=True, launch=False)
    return out


# ===========================================================================
# family: stream_triad (paper case study 1, §III)
# ===========================================================================

_TRIAD_LAYOUT = "b, c: flat [N] (N % 128 == 0) -> a = b + s*c"


def _triad_heuristic(*, backend: Optional[str] = None, **_facts) -> str:
    return "cuda_triad" if _backend(backend) == "cuda" else "torch_triad"


register_family("stream_triad", heuristic=_triad_heuristic,
                facts=lambda b, *a, **k: dict(backend=b.device.type),
                layout=_TRIAD_LAYOUT)


@register_impl("stream_triad", "cuda_triad", layout=_TRIAD_LAYOUT,
               oracle="repro_torch.kernels.stream_triad.stream_triad_plain")
def _run_cuda_triad(b, c, *, s: float = 2.5,
                    block_rows: Optional[int] = None,
                    pipelined: bool = True):
    """stream_triad — kernel #6, the HBM-stream case study."""
    return triad_mod.stream_triad(b, c, s=s, block_rows=block_rows,
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

_JACOBI_LAYOUT = ("x [X,Y,Z] fp32 -> [X-2T,Y-2T,Z-2T] after T = sweeps "
                  "valid-mode 7-point sweeps")


def _jacobi_heuristic(**_facts) -> str:
    # the wavefront variant IS the paper's point (T sweeps per residency);
    # naive is the per-sweep-round-trip baseline
    return "wavefront"


register_family("jacobi7", heuristic=_jacobi_heuristic,
                layout=_JACOBI_LAYOUT)


@register_impl("jacobi7", "wavefront", layout=_JACOBI_LAYOUT,
               oracle="repro_torch.kernels.jacobi7.jacobi7_valid_plain")
def _run_jacobi_wavefront(x, *, sweeps: int = 1, omega: float = 1.0 / 6.0,
                          block_x: Optional[int] = None):
    """T sweeps a launch of kernel #7 (~1 HBM round-trip in all)."""
    return jacobi_mod.jacobi7_wavefront(
        x, sweeps=sweeps, omega=omega, block_x=block_x or jacobi_mod.BLOCK_X)


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

_SSD_LAYOUT = ("q,k [B,S,H,dk]; v [B,S,H,dv]; log_f/log_i [B,S,H] (<=0); "
               "initial_state (C, n) or None -> (y [B,S,H,dv], "
               "(C [B,H,dk,dv], n [B,H,dk]))")


def _ssd_heuristic(*, backend: Optional[str] = None, **_facts) -> str:
    return "cuda_ssd" if _backend(backend) == "cuda" else "torch_scan"


register_family("ssd_scan", heuristic=_ssd_heuristic,
                facts=lambda q, *a, **k: dict(backend=q.device.type),
                layout=_SSD_LAYOUT)


@register_impl("ssd_scan", "cuda_ssd", layout=_SSD_LAYOUT,
               oracle="repro_torch.kernels.ssd_scan.ssd_scan_ref")
def _run_cuda_ssd(q, k, v, log_f, log_i, *, chunk: int = DEFAULT_SSD_CHUNK,
                  normalize: bool = False, eps: float = 1e-6,
                  initial_state=None):
    """ssd_scan — kernel #5, chunk-parallel with a carried state."""
    return ssd_mod.ssd_scan(q, k, v, log_f, log_i, chunk=chunk,
                            normalize=normalize, eps=eps,
                            initial_state=initial_state)


@register_impl("ssd_scan", "torch_scan", layout=_SSD_LAYOUT,
               oracle="repro_torch.kernels.ssd_scan.ssd_scan_ref")
def _run_torch_scan(q, k, v, log_f, log_i, *,
                    chunk: int = DEFAULT_SSD_CHUNK, normalize: bool = False,
                    eps: float = 1e-6, initial_state=None):
    """chunk-parallel plain twin (the CPU's choice)."""
    y, state = _chunked_linear_attention(
        q, k, v, log_f, log_i, chunk_size=chunk, normalize=normalize,
        eps=eps, initial_state=initial_state)
    ssd_mod.declare_ssd(q, k, v, log_f, log_i, y, chunk,
                        initial_state is not None,
                        f32=q.device.type == "cpu" or v.dtype == torch.float32,
                        launch=False)
    return y, state
