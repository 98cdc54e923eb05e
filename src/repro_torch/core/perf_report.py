"""Performance report: tune tables and bench artifacts -> per-family
roofline summary + gate.

Port of ``repro/core/perf_report.py``.  The report layer closes the loop
the paper's ``likwid-perfctr`` draws between *measured* numbers and the
machine model: it ingests whatever perf artifacts a run produced — every
``BENCH_*.json``, the ``TUNE_TABLE.json`` dump of either package — and
renders, per kernel family x shape bucket,

* the tuned winner and its provenance (swept / disk-warm / interpolated
  from a neighbor bucket / pinned),
* arithmetic intensity (``FLOPS_TOTAL / BYTES_ACCESSED`` of the winner:
  in the port, the kernel's declared model) against the card's bandwidth
  and FLOP ceilings (:mod:`repro_torch.core.hwinfo`),
* the record's ``score_s`` against a measured wall-clock of the
  production path (a real ``registry.run`` call on the suite cell), and
  their ratio ``achieved_frac``.  On the card a port record's score is
  the winner's measured device seconds, so the ratio reads device time
  over wall time; a reference record's (or a CPU record's) score is its
  roofline floor, as in the JAX package.

``compare`` turns a baseline report into a gate: a family regressing
beyond ``threshold`` in achieved fraction fails, and a tune-winner flip
fails **unless** the toolchain fingerprint (:data:`FINGERPRINT_KEYS`, the
fields that key persisted tune entries) changed.

Everything but :func:`seed_tune_table`, :func:`suite_inputs` and
:func:`measure_walls` is pure functions over plain dicts, copied from the
reference with the port's toolchain fields, so the report and the gate
run from fixture JSON.  The suites: :data:`FAMILY_SUITE` keeps the
reference's cells byte for byte (tune keys derive from them);
:data:`CARD_SUITE` holds the serving paths' shapes on the card, where the
sweeps run for real.  The CLI is ``repro_torch.launch.perf_report``.
"""

from __future__ import annotations

import glob
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# canonical suite cells
# ---------------------------------------------------------------------------

#: suite cell -> shape facts of the canonical autotune/measure cell: the
#: reference's, byte for byte (persisted-record identity).  A cell is
#: usually a registry family; the reserved ``family``/``impl`` keys let a
#: cell tune a NAMED impl's own space inside another family (the q8 cell
#: sweeps the int8 paged impl) — split them off with :func:`suite_family`.
#: The impl names are the reference's; the port's registry maps them.
FAMILY_SUITE: Dict[str, Dict[str, Any]] = {
    "attention": dict(b=2, h=4, kvh=2, sq=128, sk=192, dh=32),
    "paged_decode": dict(b=4, kvh=2, g=2, dh=32, ctx=128),
    "paged_decode_q8": dict(family="paged_decode", impl="pallas_paged_q8",
                            b=4, kvh=2, g=2, dh=32, ctx=128,
                            quantized=True),
    "stream_triad": dict(n=128 * 512),
    "jacobi7": dict(shape=(24, 16, 16), sweeps=2),
    "ssd_scan": dict(b=2, s=128, h=2, dk=16, dv=16, normalize=False),
    "sampling_topk": dict(family="sampling", impl="pallas_topk",
                          b=8, v=2048, method="top_k"),
    "sampling_topp": dict(family="sampling", impl="pallas_topp",
                          b=8, v=2048, method="top_p"),
}

#: smoke candidate subsets of :data:`FAMILY_SUITE`, in the port's tiles —
#: part of the persisted record identity too (cold and warm runs must
#: agree on them)
_SMOKE_CANDIDATES: Dict[str, Tuple[Tuple[int, ...], ...]] = {
    "attention": ((64, 32), (32, 32), (64, 16)),
    "paged_decode": ((16, 1), (16, 2), (32, 1)),
    "paged_decode_q8": ((16, 1), (16, 2), (32, 1)),
    "stream_triad": ((8,), (16,)),
    "jacobi7": ((4,), (8,)),
    "ssd_scan": ((32,), (64,)),
    "sampling_topk": ((1,), (2,)),
    "sampling_topp": ((1,), (2,)),
}

#: the serving paths' shapes on the card (``chip_smoke.py`` phases 3 and
#: 11): qwen2-0.5b's bf16 prefill (8 prompts of up to 512 tokens, 14 heads
#: over 2 of 64) and decode over pages of 16 at the scheduler's table
#: width (64 pages a row), fp and int8; zamba2-1.2b's SSD call; the
#: triad at 2^27 and Jacobi 512^3 at T = 4 in fp32; argmax over qwen2's
#: vocabulary.  Dtypes are names, so a cell is plain data.
CARD_SUITE: Dict[str, Dict[str, Any]] = {
    "attention": dict(b=8, h=14, kvh=2, sq=512, sk=512, dh=64,
                      dtype="bfloat16"),
    "paged_decode": dict(b=8, kvh=2, g=7, dh=64, ctx=1024,
                         dtype="bfloat16"),
    "paged_decode_q8": dict(family="paged_decode", impl="cuda_paged_q8",
                            b=8, kvh=2, g=7, dh=64, ctx=1024,
                            quantized=True, dtype="bfloat16"),
    "sampling": dict(family="sampling", impl="cuda_greedy", b=8, v=151936,
                     method="greedy", dtype="bfloat16"),
    "ssd_scan": dict(b=8, s=512, h=64, dk=64, dv=64, normalize=False,
                     dtype="bfloat16"),
    "stream_triad": dict(n=1 << 27, dtype="float32"),
    "jacobi7": dict(shape=(512, 512, 512), sweeps=4, dtype="float32"),
}

#: the candidates :data:`CARD_SUITE` sweeps (each holds the cell's
#: default tile, so a winner always stands beside it)
CARD_CANDIDATES: Dict[str, Tuple[Tuple[int, ...], ...]] = {
    "attention": ((64, 64), (64, 32), (64, 128), (128, 32), (128, 64),
                  (128, 128)),
    "paged_decode": ((16, 1), (16, 2), (16, 4), (16, 8)),
    "paged_decode_q8": ((16, 1), (16, 2), (16, 4), (16, 8)),
    "sampling": ((1,), (2,), (4,), (8,)),
    "ssd_scan": ((64,), (128,), (256,), (512,)),
    "stream_triad": ((4,), (8,), (16,), (32,)),
    "jacobi7": ((32,), (64,), (128,), (256,)),
}


def suite_family(cell: str, suite: Optional[Dict[str, Dict[str, Any]]]
                 = None) -> Tuple[str, Optional[str], Dict[str, Any]]:
    """``(registry_family, pinned_impl_or_None, shape_facts)`` for a
    suite cell (of :data:`FAMILY_SUITE` unless ``suite`` is given) — the
    reserved ``family``/``impl`` keys split off the facts that feed
    ``registry.autotune``."""
    facts = dict((suite or FAMILY_SUITE)[cell])
    return facts.pop("family", cell), facts.pop("impl", None), facts


def suite_candidates(smoke: bool, suite: Optional[Dict[str, Dict[str, Any]]]
                     = None) -> Dict[str, Any]:
    """Candidate sets per cell: for :data:`FAMILY_SUITE`, the smoke
    subsets or ``None`` per cell (= each family's full declared space);
    for :data:`CARD_SUITE`, :data:`CARD_CANDIDATES` either way."""
    if suite is CARD_SUITE:
        return dict(CARD_CANDIDATES)
    if smoke:
        return dict(_SMOKE_CANDIDATES)
    return {k: None for k in (suite or FAMILY_SUITE)}


# ---------------------------------------------------------------------------
# artifact ingest (tolerant: missing/corrupt files are skipped, not fatal)
# ---------------------------------------------------------------------------

def load_artifacts(art_dir: str) -> Dict[str, Any]:
    """Every readable ``BENCH_*.json`` / ``bench-smoke.json`` /
    ``TUNE_TABLE.json`` under ``art_dir``, keyed by stem.  Unreadable or
    half-written files are silently skipped — a partial CI run still
    gets a (partial) report."""
    arts: Dict[str, Any] = {}
    patterns = ("BENCH_*.json", "bench-smoke.json", "TUNE_TABLE.json",
                "bench_smoke.json")
    for pat in patterns:
        for path in sorted(glob.glob(os.path.join(art_dir, pat))):
            stem = os.path.splitext(os.path.basename(path))[0]
            try:
                with open(path) as fh:
                    arts[stem] = json.load(fh)
            except (OSError, ValueError):
                continue
    return arts


def tune_records(arts: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Tune records from the artifacts, in ``dump_tune_table`` row
    format: prefer the dedicated ``TUNE_TABLE.json`` dump, fall back to
    the table embedded in ``BENCH_autotune.json``."""
    for src in ("TUNE_TABLE", "BENCH_autotune"):
        doc = arts.get(src)
        if not isinstance(doc, dict):
            continue
        table = doc if src == "TUNE_TABLE" else doc.get("table")
        if isinstance(table, dict) and isinstance(table.get("records"), list):
            return [r for r in table["records"] if isinstance(r, dict)]
    return []


def summarize_benches(arts: Dict[str, Any]) -> Dict[str, Any]:
    """Headline scalars from the bench artifacts (tolerant of absent
    keys — whatever a partial run produced)."""
    out: Dict[str, Any] = {}

    def pick(doc: Any, keys: Sequence[str]) -> Dict[str, Any]:
        if not isinstance(doc, dict):
            return {}
        return {k: doc[k] for k in keys if k in doc}

    serve = pick(arts.get("BENCH_serve"),
                 ("fused_tok_s", "reference_tok_s", "continuous_tok_s",
                  "speedup", "decode_bytes_per_token"))
    if serve:
        out["serve"] = serve
    flash = pick(arts.get("BENCH_flash"), ("impl_us", "parity_max_err"))
    if flash:
        out["flash"] = flash
    auto = arts.get("BENCH_autotune")
    if isinstance(auto, dict):
        out["autotune"] = pick(auto, ("sweeps", "lowerings"))
    return out


# ---------------------------------------------------------------------------
# report builder (pure)
# ---------------------------------------------------------------------------

def _chip_doc(chip) -> Dict[str, Any]:
    return {"name": chip.name, "peak_bf16_flops": chip.peak_bf16_flops,
            "hbm_bw": chip.hbm_bw,
            "ridge_ai": chip.peak_bf16_flops / chip.hbm_bw}


def _finite(x: Any) -> Optional[float]:
    try:
        f = float(x)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


def build_report(records: Sequence[Dict[str, Any]], *,
                 walls: Optional[Dict[str, Dict[str, Any]]] = None,
                 benches: Optional[Dict[str, Any]] = None,
                 chip=None,
                 toolchain: Optional[Dict[str, str]] = None
                 ) -> Dict[str, Any]:
    """The report document: one row per (family, tune key) record, with
    roofline placement from the persisted winner events and — where a
    measured wall matches the row's key — ``achieved_frac``."""
    if chip is None:
        from repro_torch.core import hwinfo
        chip = hwinfo.H100_SXM
    if toolchain is None:
        from repro_torch.core.session import _toolchain
        toolchain = _toolchain()
    walls = walls or {}
    ridge = chip.peak_bf16_flops / chip.hbm_bw
    rows: List[Dict[str, Any]] = []
    for r in records:
        family, key = r.get("family"), r.get("key")
        if not family or not key:
            continue
        ev = r.get("winner_events") or {}
        flops = _finite(ev.get("FLOPS_TOTAL"))
        nbytes = _finite(ev.get("BYTES_ACCESSED"))
        ai = flops / nbytes if flops and nbytes else None
        row: Dict[str, Any] = {
            "family": family, "key": key,
            "choice": list(r.get("choice") or ()),
            "score_s": _finite(r.get("score_s")),
            "ai": ai,
            "bound": (None if ai is None else
                      ("compute" if ai >= ridge else "memory")),
            "attainable_flops": (None if ai is None else
                                 min(chip.peak_bf16_flops,
                                     ai * chip.hbm_bw)),
            "provenance": ("interpolated" if r.get("interpolated")
                           else "swept" if r.get("swept")
                           else "warm"),
        }
        # walls are keyed by suite CELL, records by registry family;
        # the tune key is the real join (a pinned-impl cell like the q8
        # one measures under the parent family's name)
        w = walls.get(family)
        if not (w and w.get("key") == key):
            w = next((x for x in (walls or {}).values()
                      if x.get("key") == key), None)
        if w:
            row["impl"] = w.get("impl")
            row["wall_s"] = _finite(w.get("wall_s"))
            if row["score_s"] and row["wall_s"]:
                row["achieved_frac"] = row["score_s"] / row["wall_s"]
        rows.append(row)
    rows.sort(key=lambda r: (r["family"], r["key"]))
    return {"version": 1, "chip": _chip_doc(chip), "toolchain": toolchain,
            "rows": rows, "benches": benches or {}}


# ---------------------------------------------------------------------------
# baseline compare / CI gate (pure)
# ---------------------------------------------------------------------------

#: toolchain fields forming the fingerprint (same fields that key
#: persisted tune entries — see registry._tune_digest and
#: session._toolchain)
FINGERPRINT_KEYS: Tuple[str, ...] = ("repro_src", "torch", "cuda", "device",
                                     "nvcc", "backend")

#: default allowed relative drop in achieved_frac before the gate trips
DEFAULT_THRESHOLD = 0.25

#: walls under this are dispatch/scheduler overhead, not kernel time —
#: fraction regressions on such rows are demoted from failures to notes
WALL_FLOOR_S = 5e-5


def toolchain_changed(report: Dict[str, Any],
                      baseline: Dict[str, Any]) -> bool:
    cur = report.get("toolchain") or {}
    base = baseline.get("toolchain") or {}
    return any(cur.get(k) != base.get(k) for k in FINGERPRINT_KEYS)


def compare(report: Dict[str, Any], baseline: Dict[str, Any], *,
            threshold: float = DEFAULT_THRESHOLD,
            wall_floor_s: float = WALL_FLOOR_S
            ) -> Tuple[List[str], List[str]]:
    """``(failures, notes)`` between a report and its baseline.

    Failures (gate-tripping): a row's achieved roofline fraction dropped
    more than ``threshold`` relative to baseline, or a tune winner
    flipped while the toolchain fingerprint is unchanged.  Winner flips
    under a changed fingerprint are notes (expected: a code/toolchain
    change re-keys every persisted tune entry).  New/disappeared rows
    are notes, never failures — shapes come and go with the suite.

    Fraction regressions where either wall is under ``wall_floor_s`` are
    demoted to notes: at that scale the wall measures host dispatch and
    scheduler jitter, not the kernel, and no threshold is stable."""
    failures: List[str] = []
    notes: List[str] = []
    exempt = toolchain_changed(report, baseline)
    base_rows = {(r.get("family"), r.get("key")): r
                 for r in baseline.get("rows", [])}
    seen = set()
    for row in report.get("rows", []):
        ident = (row.get("family"), row.get("key"))
        seen.add(ident)
        tag = f"{ident[0]}[{ident[1]}]"
        b = base_rows.get(ident)
        if b is None:
            notes.append(f"{tag}: new row (no baseline)")
            continue
        if list(row.get("choice") or ()) != list(b.get("choice") or ()):
            flip = (f"{tag}: tune winner flipped "
                    f"{tuple(b.get('choice') or ())} -> "
                    f"{tuple(row.get('choice') or ())}")
            if exempt:
                notes.append(flip + " (exempt: toolchain fingerprint "
                                    "changed)")
            else:
                failures.append(flip + " with unchanged toolchain "
                                       "fingerprint")
        frac, bfrac = row.get("achieved_frac"), b.get("achieved_frac")
        if frac is not None and bfrac and frac < bfrac * (1 - threshold):
            walls = [w for w in (row.get("wall_s"), b.get("wall_s"))
                     if w is not None]
            if walls and min(walls) < wall_floor_s:
                notes.append(
                    f"{tag}: fraction {bfrac:.4g} -> {frac:.4g} below "
                    f"gate floor (wall < {wall_floor_s * 1e6:.0f}us is "
                    f"dispatch noise, not kernel)")
            else:
                failures.append(
                    f"{tag}: achieved roofline fraction regressed "
                    f"{bfrac:.4g} -> {frac:.4g} "
                    f"(> {threshold:.0%} drop)")
    for ident in sorted(set(base_rows) - seen):
        notes.append(f"{ident[0]}[{ident[1]}]: baseline row missing "
                     f"from report")
    return failures, notes


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

_COLS = ("family", "key", "impl", "choice", "prov", "AI f/B", "bound",
         "roofline_us", "wall_us", "frac")


def _row_cells(row: Dict[str, Any]) -> Tuple[str, ...]:
    def num(x, scale=1.0, fmt="{:.3g}"):
        return "-" if x is None else fmt.format(x * scale)
    return (row["family"], row["key"],
            row.get("impl") or "-",
            "x".join(str(c) for c in row["choice"]) or "-",
            row["provenance"],
            num(row.get("ai")),
            row.get("bound") or "-",
            num(row.get("score_s"), 1e6),
            num(row.get("wall_s"), 1e6),
            num(row.get("achieved_frac"), fmt="{:.2%}"))


def render_table(report: Dict[str, Any]) -> str:
    """Fixed-width terminal table over the report rows."""
    chip = report.get("chip", {})
    head = (f"== perf report: {len(report.get('rows', []))} rows vs "
            f"{chip.get('name', '?')} ceilings "
            f"(ridge {chip.get('ridge_ai', 0):.0f} FLOP/byte) ==")
    grid = [_COLS] + [_row_cells(r) for r in report.get("rows", [])]
    widths = [max(len(str(row[i])) for row in grid)
              for i in range(len(_COLS))]
    lines = [head]
    for i, row in enumerate(grid):
        lines.append("  ".join(str(c).ljust(w)
                               for c, w in zip(row, widths)).rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def render_markdown(report: Dict[str, Any],
                    failures: Optional[Sequence[str]] = None,
                    notes: Optional[Sequence[str]] = None) -> str:
    """``PERF_REPORT.md``: the same rows as a GitHub table, plus the
    gate verdict when a baseline comparison ran."""
    chip = report.get("chip", {})
    tc = report.get("toolchain", {})
    out = [f"# Perf report ({chip.get('name', '?')} model)", ""]
    out.append(f"Toolchain: torch {tc.get('torch', '?')} / CUDA "
               f"{tc.get('cuda', '?')} / {tc.get('device', '?')} / "
               f"{tc.get('backend', '?')} / src "
               f"`{str(tc.get('repro_src', '?'))[:12]}`")
    out += ["", "| " + " | ".join(_COLS) + " |",
            "|" + "---|" * len(_COLS)]
    for r in report.get("rows", []):
        out.append("| " + " | ".join(_row_cells(r)) + " |")
    benches = report.get("benches") or {}
    if benches:
        out += ["", "## Bench headlines", "",
                "```json", json.dumps(benches, indent=2, sort_keys=True),
                "```"]
    if failures is not None or notes is not None:
        out += ["", "## Gate", ""]
        for f in failures or ():
            out.append(f"- **FAIL** {f}")
        for n in notes or ():
            out.append(f"- note: {n}")
        if not failures:
            out.append("- no regressions vs baseline")
    out.append("")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# measurement path (the only torch-touching code in this module)
# ---------------------------------------------------------------------------

def seed_tune_table(records: Sequence[Dict[str, Any]]) -> int:
    """Pin artifact tune records into the in-process table so the
    measured path reproduces a run's winners even when the local cache is
    cold.  Returns the number of rows pinned."""
    from repro_torch.kernels import registry
    n = 0
    for r in records:
        if r.get("family") and r.get("key") and r.get("choice"):
            registry.record(r["family"], r["key"], tuple(r["choice"]),
                            score_s=_finite(r.get("score_s"))
                            or float("nan"))
            n += 1
    return n


def suite_inputs(cell: str, records: Sequence[Dict[str, Any]] = (), *,
                 suite: Optional[Dict[str, Dict[str, Any]]] = None,
                 device="cuda") -> Tuple[tuple, Dict[str, Any], str]:
    """``(args, kwargs, lookup_key)`` for a suite cell: tensors on
    ``device`` made from seed 0, shaped per the cell (the cell's dtype,
    fp32 when it names none), in the model layout ``registry.run`` takes,
    and the tune key the measured wall joins against in the report."""
    import torch

    from repro_torch.kernels import registry
    suite = suite or FAMILY_SUITE
    family, _pinned, facts = suite_family(cell, suite)
    dev = torch.device(device)
    backend = dev.type
    dtype = getattr(torch, facts.get("dtype", "float32"))
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    if family == "attention":
        b, h, kvh = facts["b"], facts["h"], facts["kvh"]
        sq, sk, dh = facts["sq"], facts["sk"], facts["dh"]
        q, k, v = rnd(b, sq, h, dh), rnd(b, sk, kvh, dh), rnd(b, sk, kvh, dh)
        key = registry.attention_tune_key(**dict(facts, dtype=dtype,
                                                 backend=backend))
        return (q, k, v), {"causal": True}, key
    if family == "paged_decode":
        quantized = bool(facts.get("quantized"))
        b, kvh, g, dh, ctx = (facts["b"], facts["kvh"], facts["g"],
                              facts["dh"], facts["ctx"])
        ps = _suite_page_size(records, cell, suite, quantized=quantized)
        np_w = -(-ctx // ps)
        p_total = b * np_w + 1
        q4 = rnd(b, kvh, g, dh)
        kwargs: Dict[str, Any] = {}
        if quantized:
            def codes():
                return torch.randint(-127, 128, (p_total, ps, kvh, dh),
                                     generator=gen, device=dev
                                     ).to(torch.int8)
            k_pages, v_pages = codes(), codes()
            kwargs = {"k_scale": 0.005 + 0.045 * torch.rand(
                          (p_total, ps), generator=gen, device=dev),
                      "v_scale": 0.005 + 0.045 * torch.rand(
                          (p_total, ps), generator=gen, device=dev)}
        else:
            k_pages = rnd(p_total, ps, kvh, dh)
            v_pages = rnd(p_total, ps, kvh, dh)
        table = torch.arange(1, p_total, dtype=torch.int32,
                             device=dev).reshape(b, np_w)
        length = torch.full((b,), ctx - 1, dtype=torch.int32, device=dev)
        k_new, v_new = rnd(b, kvh, dh), rnd(b, kvh, dh)
        # the key the runner computes: ctx = table width x page size
        key = registry.paged_lookup_key(b=b, kvh=kvh, g=g, dh=dh,
                                        page_size=ps, ctx=np_w * ps,
                                        dtype=dtype, backend=backend,
                                        quantized=quantized)
        return ((q4, k_pages, v_pages, table, length, k_new, v_new),
                kwargs, key)
    if family == "stream_triad":
        n = facts["n"]
        key = registry.triad_tune_key(n=n, dtype=dtype, backend=backend)
        return (rnd(n), rnd(n)), {}, key
    if family == "jacobi7":
        shape, sweeps = tuple(facts["shape"]), facts["sweeps"]
        key = registry.jacobi_tune_key(shape=shape, sweeps=sweeps,
                                       dtype=dtype, backend=backend)
        return (rnd(*shape),), {"sweeps": sweeps}, key
    if family == "sampling":
        b, v, method = facts["b"], facts["v"], facts["method"]
        kwargs = dict(method=method, temperature=1.0)
        if method == "top_k":
            kwargs["k"] = 8                 # matches the tune probe's k
        elif method == "top_p":
            kwargs["p"] = 0.9               # matches the tune probe's p
        sample_gen = (None if method == "greedy" else
                      torch.Generator(device=dev).manual_seed(1))
        key = registry.sampling_tune_key(b=b, v=v, method=method,
                                         dtype=dtype, backend=backend)
        return (rnd(b, v), sample_gen), kwargs, key
    if family == "ssd_scan":
        b, s, h = facts["b"], facts["s"], facts["h"]
        dk, dv = facts["dk"], facts["dv"]
        q, k, v = rnd(b, s, h, dk), rnd(b, s, h, dk), rnd(b, s, h, dv)
        log_f = -rnd(b, s, h, dt=torch.float32).abs()
        log_i = -rnd(b, s, h, dt=torch.float32).abs()
        key = registry.ssd_tune_key(**dict(facts, dtype=dtype,
                                           backend=backend))
        return ((q, k, v, log_f, log_i),
                {"normalize": facts["normalize"]}, key)
    raise KeyError(f"unknown suite cell {cell!r}")


def _suite_page_size(records: Sequence[Dict[str, Any]], cell: str,
                     suite: Dict[str, Dict[str, Any]], *,
                     quantized: bool = False) -> int:
    """The winning page size among the family's tuned records (best
    score), else the cell's first candidate's.  fp and q8 records share
    family ``paged_decode``; the key prefix tells them apart."""
    prefix = "pagedq8-" if quantized else "paged-"
    best_ps, best_score = None, math.inf
    for r in records:
        if r.get("family") != "paged_decode" or not r.get("choice"):
            continue
        if not str(r.get("key", "")).startswith(prefix):
            continue
        score = _finite(r.get("score_s")) or math.inf
        if best_ps is None or score < best_score:
            best_ps, best_score = int(r["choice"][0]), score
    cands = (CARD_CANDIDATES if suite is CARD_SUITE
             else _SMOKE_CANDIDATES)[cell]
    return best_ps or cands[0][0]


def measure_walls(records: Sequence[Dict[str, Any]] = (), *,
                  families: Optional[Sequence[str]] = None,
                  suite: Optional[Dict[str, Dict[str, Any]]] = None,
                  device="cuda", repeats: int = 5,
                  calls_per_round: int = 20) -> Dict[str, Dict[str, Any]]:
    """Wall-clock the production path — a real ``registry.run`` — per
    suite cell.  The wall is the MIN over ``repeats`` rounds of
    ``calls_per_round`` calls with one device sync per round: small cells
    run microseconds, where per-call timing is dispatch noise, and the
    min rejects scheduler outliers."""
    import functools

    import torch

    from repro_torch.kernels import registry
    suite = suite or FAMILY_SUITE
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    walls: Dict[str, Dict[str, Any]] = {}
    for cell in families or suite:
        args, kwargs, key = suite_inputs(cell, records, suite=suite,
                                         device=dev)
        family, pinned, cell_facts = suite_family(cell, suite)
        if family == "attention":
            facts = {k: cell_facts[k] for k in ("sq", "sk", "dh")}
        else:
            facts = {k: v for k, v in cell_facts.items() if k != "dtype"}
        impl = registry.select(family, backend=dev.type, **facts)
        fn = functools.partial(registry.run, family, impl=impl, **kwargs)
        fn(*args)                               # builds, warms up
        sync()
        best = math.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(calls_per_round):
                fn(*args)
            sync()
            best = min(best, (time.perf_counter() - t0) / calls_per_round)
        walls[cell] = {"key": key, "impl": impl, "wall_s": best}
    return walls
