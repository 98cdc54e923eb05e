"""Shared CLI flags for the port's launchers.

Copied from ``repro/launch/cli.py`` for what ``launch/serve.py`` uses:

* :func:`add_kv_args` — ``--kv-dtype {fp32,bf16,int8}`` and
  ``--no-prefix-cache`` over the paged KV cache (consume with
  :func:`kv_config_kwargs`, which validates eagerly);
* :func:`add_robustness_args` — per-request deadlines, bounded
  admission, serving snapshots and seeded chaos injection (consume with
  :func:`robustness_kwargs`, which validates eagerly);
* :func:`add_spec_args` — ``--draft``, ``--spec-tokens`` and
  ``--accept-policy`` (consume with :func:`spec_kwargs`, which validates
  the pairing eagerly);
* :func:`add_json_args` — ``--json PATH`` machine-readable summary.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

__all__ = ["add_kv_args", "kv_config_kwargs", "add_robustness_args",
           "robustness_kwargs", "add_spec_args", "spec_kwargs",
           "add_json_args"]


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
