"""Shared CLI flags for the port's launchers.

Copied from ``repro/launch/cli.py`` for what the launchers use: the
serving and training launchers (``launch/serve.py``, ``launch/train.py``),
the perf report (``launch/perf_report.py``) and the dry run's three
(``launch/dryrun.py``, ``launch/roofline_report.py``,
``launch/perfctr.py``: ``--impl``/``--tune``, ``--cache-dir``/
``--no-cache``, ``--json``):

* :func:`add_kv_args` — ``--kv-dtype {fp32,bf16,int8}`` and
  ``--no-prefix-cache`` over the paged KV cache (consume with
  :func:`kv_config_kwargs`, which validates eagerly);
* :func:`add_robustness_args` — per-request deadlines, bounded
  admission, serving snapshots and seeded chaos injection (consume with
  :func:`robustness_kwargs`, which validates eagerly);
* :func:`add_ft_args` — the heartbeat governor's ``--ft-timeout-steps``
  and ``--ft-confirm`` (mesh serving) and the straggler detector's
  ``--straggler-threshold`` and ``--straggler-min-ratio`` (consume with
  :func:`ft_kwargs`: the scheduler's kwargs, as in the reference);
* :func:`add_spec_args` — ``--draft``, ``--spec-tokens`` and
  ``--accept-policy`` (consume with :func:`spec_kwargs`, which validates
  the pairing eagerly);
* :func:`add_json_args` — ``--json PATH`` machine-readable summary;
* :func:`add_impl_args` — ``--impl FAM=NAME[,...]`` kernel pins per
  registry family, ``--tune`` (autotune first; a warm cache makes it
  free) and the deprecated ``--attn-impl``, whose shared warning is
  :func:`warn_legacy_attn_impl`; the serving launcher hands the pins to
  ``ServeConfig``;
* :func:`add_cache_args` — ``--cache-dir`` / ``--no-cache`` over the
  artifact cache (consume with :func:`session_from_args`, a
  ``ProfileSession`` honouring them); :func:`run_tune_suite` is the
  ``--tune`` body over a suite of ``repro_torch.core.perf_report``;
* :func:`resolve_impls` / :func:`impl_context` — the pins of ``--impl``
  over the legacy ``--attn-impl`` expansion, as a ``registry.use_impl``
  context, for the tools that run kernels outside an engine (the perf
  report; the serving launcher hands its pins to ``ServeConfig``).
"""

from __future__ import annotations

import argparse
import contextlib
import warnings
from typing import Dict, Optional

__all__ = ["add_kv_args", "kv_config_kwargs", "add_robustness_args",
           "robustness_kwargs", "add_ft_args", "ft_kwargs", "add_spec_args",
           "spec_kwargs", "add_json_args", "add_impl_args",
           "warn_legacy_attn_impl", "resolve_impls", "impl_context",
           "add_cache_args", "session_from_args", "run_tune_suite"]

#: ``--attn-impl`` names: the port's legacy single names and the JAX
#: package's spellings of the same two
LEGACY_ATTN_CHOICES = ("cuda_flash", "torch_flash", "full", "paged_decode",
                       "pallas_flash", "jnp_flash")


def add_impl_args(ap: argparse.ArgumentParser, *, tune: bool = True,
                  legacy_attn: bool = False) -> None:
    """``--impl`` (+ ``--tune``, + deprecated ``--attn-impl``)."""
    ap.add_argument("--impl", default=None, metavar="FAM=NAME[,...]",
                    help="pin kernel impls per registry family, e.g. "
                         "attention=torch_flash,paged_decode=torch_paged "
                         "(the JAX package's names map one to one; "
                         "default: kernels/registry.py picks by device "
                         "and shape)")
    if tune:
        ap.add_argument("--tune", action="store_true",
                        help="autotune the kernels this run serves through "
                             "a ProfileSession first (measured device time "
                             "on the card); winners persist in the "
                             "artifact cache, so a warm cache makes this "
                             "free (zero sweeps, zero timed probes)")
    if legacy_attn:
        ap.add_argument("--attn-impl", default=None,
                        choices=list(LEGACY_ATTN_CHOICES),
                        help="DEPRECATED single-name spelling of --impl "
                             "(pins the attention impl and the decode "
                             "side; paged_decode pins the CUDA paged "
                             "kernel on the decode side only)")


def warn_legacy_attn_impl(name: Optional[str]) -> None:
    """The ONE shared deprecation warning for ``--attn-impl``."""
    if name is None:
        return
    warnings.warn(
        f"--attn-impl {name} is deprecated; spell it through --impl "
        f"(e.g. --impl attention={name}) — the single name expands via "
        f"registry.LEGACY_ATTN_MAP onto the attention AND paged_decode "
        f"families", DeprecationWarning, stacklevel=2)
    print(f"[cli] --attn-impl {name} is deprecated; prefer --impl "
          f"(registry grammar)")


def resolve_impls(args: argparse.Namespace) -> Dict[str, str]:
    """The per-family pin mapping from ``--impl`` merged over the legacy
    ``--attn-impl`` expansion (``--impl`` wins per family)."""
    from repro_torch.kernels import registry
    out: Dict[str, str] = {}
    legacy = getattr(args, "attn_impl", None)
    if legacy is not None:
        warn_legacy_attn_impl(legacy)
        out.update(registry.legacy_mapping(legacy))
    if getattr(args, "impl", None):
        out.update(registry.parse_impl_spec(args.impl))
    return out


def impl_context(args: argparse.Namespace):
    """A context manager pinning the requested impls for everything run
    inside (no-op when neither flag was passed)."""
    from repro_torch.kernels import registry
    impls = resolve_impls(args)
    return registry.use_impl(**impls) if impls else contextlib.nullcontext()


def add_kv_args(ap: argparse.ArgumentParser) -> None:
    """``--kv-dtype`` / ``--no-prefix-cache`` (paged KV cache storage)."""
    ap.add_argument("--kv-dtype", default=None,
                    choices=["fp32", "bf16", "int8"],
                    help="paged KV page storage dtype (default: the model "
                         "dtype); int8 stores quantized codes with "
                         "per-token f32 scales and decodes through the "
                         "q8 paged kernel (needs --page-size)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the shared-prefix radix cache (paged "
                         "engines dedupe shared prompt prefixes by "
                         "default: prefill once, map the pages read-only, "
                         "copy-on-write at the fork page)")


def kv_config_kwargs(args: argparse.Namespace,
                     ap: Optional[argparse.ArgumentParser] = None
                     ) -> Dict[str, object]:
    """ServeConfig kwargs from the KV flags, validated eagerly.

    ``--kv-dtype`` without ``--page-size`` is a usage error (dense caches
    keep the model dtype; silently ignoring the flag would misreport
    bytes/token)."""
    kv_dtype = getattr(args, "kv_dtype", None)
    if kv_dtype and not getattr(args, "page_size", 0):
        msg = ("--kv-dtype needs a paged KV cache: pass --page-size too "
               "(dense caches keep the model dtype)")
        if ap is not None:
            ap.error(msg)
        raise ValueError(msg)
    return {"kv_dtype": kv_dtype,
            "prefix_cache": not getattr(args, "no_prefix_cache", False)}


def add_robustness_args(ap: argparse.ArgumentParser) -> None:
    """Request-plane robustness flags (consume with
    :func:`robustness_kwargs`): deadlines, bounded admission, snapshots,
    seeded chaos injection."""
    g = ap.add_argument_group("request-plane robustness")
    g.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request total wall deadline; expired rows "
                        "retire at the next segment boundary")
    g.add_argument("--ttft-deadline-ms", type=float, default=None,
                   help="per-request first-token deadline")
    g.add_argument("--max-queue", type=int, default=None,
                   help="bound the admission queue; overload is refused "
                        "in O(1) with a structured retryable rejection "
                        "(default: unbounded)")
    g.add_argument("--shed-policy", default="reject-new",
                   choices=["reject-new", "shed-lowest"],
                   help="at --max-queue capacity: refuse the arrival, or "
                        "evict the newest request of the strictly worst "
                        "priority class (default reject-new)")
    g.add_argument("--snapshot-dir", default=None,
                   help="write crash-safe serving snapshots here (queue, "
                        "per-request progress, KV prefix index) and on "
                        "drain/exit")
    g.add_argument("--snapshot-every", type=int, default=0,
                   help="snapshot interval in decode segments (0 = only "
                        "at exit; needs --snapshot-dir)")
    g.add_argument("--chaos", type=int, default=None, metavar="SEED",
                   help="drive a seeded ChaosSchedule through the run "
                        "(fault injection with invariant checks after "
                        "every event; same seed = same faults)")


def robustness_kwargs(args: argparse.Namespace,
                      ap: Optional[argparse.ArgumentParser] = None
                      ) -> Dict[str, object]:
    """BatchScheduler kwargs from :func:`add_robustness_args` (the
    per-request deadline flags are applied at submit time by the caller,
    not here).  Validates eagerly: ``--snapshot-every`` without
    ``--snapshot-dir`` is a usage error."""
    if getattr(args, "snapshot_every", 0) and \
            not getattr(args, "snapshot_dir", None):
        msg = "--snapshot-every needs --snapshot-dir"
        if ap is not None:
            ap.error(msg)
        raise ValueError(msg)
    out: Dict[str, object] = {
        "max_queue": getattr(args, "max_queue", None),
        "shed_policy": getattr(args, "shed_policy", "reject-new"),
        "snapshot_dir": getattr(args, "snapshot_dir", None),
        "snapshot_every": getattr(args, "snapshot_every", 0),
    }
    if getattr(args, "chaos", None) is not None:
        from repro_torch.ft.chaos import ChaosSchedule
        out["chaos"] = ChaosSchedule(seed=args.chaos)
    return out


def add_ft_args(ap: argparse.ArgumentParser) -> None:
    """Fault-tolerance tunables (consume with :func:`ft_kwargs`)."""
    g = ap.add_argument_group("fault tolerance")
    g.add_argument("--ft-timeout-steps", type=int, default=3,
                   help="segments a device may miss heartbeats before it "
                        "counts as missing (default 3)")
    g.add_argument("--ft-confirm", type=int, default=2,
                   help="consecutive missing observations before the "
                        "re-mesh governor confirms a death — absorbs "
                        "single-heartbeat flaps (default 2)")
    g.add_argument("--straggler-threshold", type=float, default=4.0,
                   help="EMA deviations a segment wall must exceed to be "
                        "flagged a straggler (default 4.0)")
    g.add_argument("--straggler-min-ratio", type=float, default=1.5,
                   help="minimum wall/EMA ratio for a straggler flag — "
                        "suppresses noise on fast segments (default 1.5)")


def ft_kwargs(args: argparse.Namespace,
              ap: Optional[argparse.ArgumentParser] = None
              ) -> Dict[str, object]:
    """BatchScheduler kwargs from the :func:`add_ft_args` flags (the
    heartbeat governor's arm only on a ``ServeMesh`` engine).  ``ap``
    reports a threshold below 1 as a usage error."""
    for flag in ("ft_timeout_steps", "ft_confirm"):
        if getattr(args, flag, 1) < 1:
            msg = f"--{flag.replace('_', '-')} must be at least 1"
            if ap is not None:
                ap.error(msg)
            raise ValueError(msg)
    return {
        "ft_timeout_steps": getattr(args, "ft_timeout_steps", 3),
        "ft_confirm": getattr(args, "ft_confirm", 2),
        "straggler_threshold": getattr(args, "straggler_threshold", 4.0),
        "straggler_min_ratio": getattr(args, "straggler_min_ratio", 1.5),
    }


def add_spec_args(ap: argparse.ArgumentParser) -> None:
    """Speculative-decoding flags (consume with :func:`spec_kwargs`)."""
    g = ap.add_argument_group("speculative decoding")
    g.add_argument("--draft", default=None, metavar="CONFIG",
                   help="pair this arch as the draft model (e.g. --arch "
                        "qwen2-0.5b --draft qwen2-0.5b): the engine drafts "
                        "K tokens per round and verifies them with the "
                        "target in one multi-token prefill (needs "
                        "--page-size; greedy fp32 tokens equal target-only "
                        "decode)")
    g.add_argument("--spec-tokens", type=int, default=4, metavar="K",
                   help="draft lookahead per speculative round "
                        "(default 4)")
    g.add_argument("--accept-policy", default="auto",
                   choices=["auto", "greedy", "rejection"],
                   help="draft acceptance rule: greedy exact-prefix match "
                        "(temperature 0), rejection-sampling correction "
                        "(temperature > 0), or auto by temperature "
                        "(default auto)")


def spec_kwargs(args: argparse.Namespace, target_cfg,
                serve_cfg=None,
                ap: Optional[argparse.ArgumentParser] = None
                ) -> Dict[str, object]:
    """``{"spec": SpecConfig}`` from the :func:`add_spec_args` flags,
    validated EAGERLY (vocab mismatch, a non-decoder family, a missing
    paged cache) before any weights are built;
    ``{}`` when ``--draft`` was not passed.  ``--draft`` resolves through
    :func:`repro_torch.configs.get_arch`, smoke dims when the target's
    are."""
    def fail(msg: str):
        if ap is not None:
            ap.error(msg)
        raise ValueError(msg)

    draft = getattr(args, "draft", None)
    if not draft:
        if getattr(args, "spec_tokens", 4) != 4 \
                or getattr(args, "accept_policy", "auto") != "auto":
            fail("--spec-tokens/--accept-policy need --draft (no draft "
                 "model, no speculative decoding)")
        return {}
    from repro_torch.configs import get_arch
    from repro_torch.serve.spec import SpecConfig
    arch = get_arch(draft)
    dcfg = (arch.smoke if getattr(args, "smoke_dims", False)
            else arch.config)
    spec = SpecConfig(draft_config=dcfg,
                      num_draft_tokens=getattr(args, "spec_tokens", 4),
                      accept_policy=getattr(args, "accept_policy", "auto"))
    try:
        spec.validate(target_cfg, serve_cfg)
    except ValueError as e:
        fail(str(e))
    return {"spec": spec}


def add_json_args(ap: argparse.ArgumentParser,
                  what: str = "summary") -> None:
    """``--json PATH`` (machine-readable artifact)."""
    ap.add_argument("--json", default=None, metavar="PATH",
                    help=f"write a machine-readable {what} here")


def add_cache_args(ap: argparse.ArgumentParser) -> None:
    """``--cache-dir`` / ``--no-cache`` (the artifact cache)."""
    ap.add_argument("--cache-dir", default=None,
                    help="artifact cache root (default $REPRO_CACHE_DIR or "
                         "~/.cache/repro-perfctr)")
    ap.add_argument("--no-cache", action="store_true",
                    help="always run and time every probe, never read or "
                         "write the cache")


def session_from_args(args: argparse.Namespace):
    """A ProfileSession honouring ``--cache-dir`` / ``--no-cache``."""
    from repro_torch.core.session import ProfileSession
    return ProfileSession(cache_dir=getattr(args, "cache_dir", None),
                          enabled=not getattr(args, "no_cache", False))


def run_tune_suite(session=None, *, smoke: bool = True, suite=None,
                   backend: Optional[str] = None,
                   verbose: bool = True) -> Dict[str, Dict]:
    """The ``--tune`` body: autotune every cell of a suite
    (``repro_torch.core.perf_report.FAMILY_SUITE`` unless ``suite`` is
    given, e.g. ``CARD_SUITE``) through one session on ``backend``
    (default ``cuda``).  Warm caches resolve everything from the
    persisted tune table — zero sweeps, zero timed probes."""
    from repro_torch.core.perf_report import (FAMILY_SUITE,
                                              suite_candidates, suite_family)
    from repro_torch.kernels import registry
    if session is None:
        from repro_torch.core.session import ProfileSession
        session = ProfileSession()
    suite = suite if suite is not None else FAMILY_SUITE
    out: Dict[str, Dict] = {}
    cands = suite_candidates(smoke, suite)
    for cell in suite:
        family, impl, facts = suite_family(cell, suite)
        rec = registry.autotune(family, session, impl=impl,
                                candidates=cands[cell], backend=backend,
                                **facts)
        out[cell] = {"family": family, "impl": impl, "facts": facts,
                     "key": rec.key, "choice": list(rec.choice),
                     "score_us": rec.score_s * 1e6, "swept": rec.swept,
                     "lowerings": rec.lowerings, "timer": rec.timer,
                     "scores_us": {str(list(c)): s * 1e6
                                   for c, s in rec.scores.items()}}
        if verbose:
            src = "swept" if rec.swept else "tune table (warm)"
            print(f"[tune] {cell:>15}: choice={tuple(rec.choice)} "
                  f"[{src}, {rec.lowerings} timed probes]")
    return out
