"""Serving launcher: build a model and serve batched requests on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --requests 32 --slots 8 --page-size 16 --kv-dtype int8 \\
        --shared-prefix 256 --json serve.json

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --requests 16 --slots 8 --prompt-len 256 --max-seq 1024

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --page-size 16 --temperature 0.7 --draft qwen2-0.5b \\
        --spec-tokens 4 --instrument --json spec.json

Runs the continuous-batching ``BatchScheduler`` over synthetic prompts
(deterministic, numpy seed 0) and prints tokens/s, time-to-first-token,
segments, admissions and the engine's audited host-sync count.  The
hybrid zamba2-1.2b serves with dense KV only: ``--page-size`` (with or
without ``--kv-dtype``) gives the engine's error for it.  There is
no checkpoint in the repository: the weights are random, from a
``torch.Generator`` seeded with 0 (the ``--draft`` model's with 1).
``--device cpu`` runs the kernels' plain PyTorch versions on the host
(use ``--smoke-dims``, which applies to the draft too).

``--temperature > 0`` samples (top-p with p = 1: plain categorical).
``--draft`` pairs a draft model for speculative decoding (every request
opts in; needs ``--page-size``), and the summary gains a ``spec`` block.
``--instrument`` probes the ``serve.prefill`` / ``serve.decode`` regions
through ``PerfCtr``, prints its report and writes the regions' calls and
seconds into the summary.  ``--snapshot-dir`` (with ``--snapshot-every
N``) writes crash-safe serving snapshots, which ``Engine.restore``
reads back (either package's); ``--chaos SEED`` drives a seeded
``ChaosSchedule`` through the run.  The summary counts ``snapshots``,
``restores`` and the chaos schedule's events.

Not ported yet (``ROADMAP.md``): the JAX launcher's ``--mesh``,
``--tune``, ``--impl`` and ``--ckpt-dir`` flags (absent: argparse
refuses them).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.launch import cli


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke-dims", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 (default) decodes greedily; > 0 samples")
    ap.add_argument("--admission-chunk", type=int, default=8,
                    help="decode steps between admission points")
    cli.add_json_args(ap, what="serve summary")
    cli.add_robustness_args(ap)
    cli.add_spec_args(ap)
    ap.add_argument("--priority-mix", default=None, metavar="P[,P...]",
                    help="cycle synthetic requests through these priority "
                         "classes (lower = more urgent; e.g. 0,1,1,2)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache: tokens per page (0 = dense "
                         "caches)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="KV pool capacity in pages (default: dense "
                         "worst case + segment headroom)")
    cli.add_kv_args(ap)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens "
                         "to every synthetic request (exercises the "
                         "prefix cache: the prefix prefills once)")
    ap.add_argument("--instrument", action="store_true",
                    help="probe serve regions through PerfCtr and report")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.serve.admission import AdmissionRejected
    from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                          ServeConfig)

    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke_dims else spec.config
    serve_cfg = ServeConfig(
        max_seq=args.max_seq, batch_slots=args.slots,
        temperature=args.temperature,
        admission_chunk=args.admission_chunk,
        page_size=args.page_size, pool_pages=args.pool_pages,
        **cli.kv_config_kwargs(args, ap))
    # --draft validates the pairing eagerly (vocab, family, page size)
    # before any weights are built
    spec_kw = cli.spec_kwargs(args, cfg, serve_cfg, ap)
    lm = LM(cfg, torch.bfloat16, args.device)
    gen = torch.Generator(device=lm.device).manual_seed(0)
    lm.init(gen)
    draft_lm = None
    if spec_kw:
        sc = spec_kw["spec"]
        draft_lm = LM(sc.draft_config, torch.bfloat16, lm.device).init(
            torch.Generator(device=lm.device).manual_seed(1))
        print(f"[serve] speculative decoding: draft={args.draft} "
              f"K={sc.num_draft_tokens} "
              f"policy={sc.resolve_policy(args.temperature)}")
    eng = Engine(lm, serve_cfg, device=lm.device, draft_lm=draft_lm,
                 **spec_kw)
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, bf16, "
          f"random weights (seed 0) on {lm.device}")
    if eng.paged:
        print(f"[serve] paged KV cache: page_size={args.page_size} "
              f"pool_pages={eng.pool_pages} table_width={eng.table_width} "
              f"kv_dtype={args.kv_dtype or 'model'} "
              f"prefix_cache={'on' if not args.no_prefix_cache else 'off'}")

    ctr = None
    if args.instrument:
        from repro_torch.core.perfctr import PerfCtr
        ctr = PerfCtr(device=lm.device)
        eng.instrument(ctr, prompt_len=args.prompt_len)
        print("[serve] instrumented serve.prefill/serve.decode regions")

    sched = BatchScheduler(eng, **cli.robustness_kwargs(args, ap))
    if sched.chaos is not None:
        print(f"[serve] chaos schedule armed: seed={args.chaos}, "
              f"{len(sched.chaos.events)} events")
    prios = ([int(p) for p in args.priority_mix.split(",")]
             if args.priority_mix else [1])
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab, size=args.shared_prefix).tolist()
    for rid in range(args.requests):
        prompt = shared + rng.integers(1, cfg.vocab,
                                       size=args.prompt_len).tolist()
        try:
            sched.submit(Request(
                rid=rid, prompt=prompt, max_new_tokens=args.max_new,
                priority=prios[rid % len(prios)],
                deadline_ms=args.deadline_ms,
                ttft_deadline_ms=args.ttft_deadline_ms,
                spec=bool(spec_kw)))
        except AdmissionRejected as e:
            r = e.rejection
            print(f"[serve] req {rid} rejected ({r.reason}, "
                  f"depth={r.queue_depth}, "
                  f"retry_after={r.retry_after_s:.2f}s)")
    t0 = time.perf_counter()
    done = sched.run()
    if lm.device.type == "cuda":
        torch.cuda.synchronize(lm.device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.generated) for r in done.values())
    ttfts = [r.ttft for r in done.values() if r.ttft is not None]
    m = sched.metrics
    print(f"[serve] {len(done)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s incl. kernel builds)")
    ttft_s = f" mean_ttft={np.mean(ttfts) * 1e3:.1f}ms" if ttfts else ""
    print(f"[serve] segments={m['segments']:.0f} "
          f"admissions={m['admissions']:.0f} "
          f"host_syncs={eng.host_syncs}{ttft_s}")
    if any(m[k] for k in ("expired", "cancelled", "sheds", "rejections",
                          "snapshots", "restores")):
        print(f"[serve] robustness: rejections={m['rejections']:.0f} "
              f"sheds={m['sheds']:.0f} expired={m['expired']:.0f} "
              f"cancelled={m['cancelled']:.0f} "
              f"snapshots={m['snapshots']:.0f} "
              f"restores={m['restores']:.0f}")
    if sched.chaos is not None:
        print(f"[serve] chaos: {sched.chaos.summary()}")
    spec_summary = None
    if spec_kw:
        rate = m["draft_accepted"] / max(m["draft_proposed"], 1)
        print(f"[serve] speculative: rounds={m['spec_rounds']:.0f} "
              f"proposed={m['draft_proposed']:.0f} "
              f"accepted={m['draft_accepted']:.0f} "
              f"accept_rate={rate:.2f}")
        spec_summary = {"draft": args.draft,
                        "k": spec_kw["spec"].num_draft_tokens,
                        "rounds": m["spec_rounds"], "accept_rate": rate}
    hit = None
    if sched.pool is not None:
        hit = ((m["prompt_tokens"] - m["prefilled_tokens"])
               / max(m["prompt_tokens"], 1))
        print(f"[serve] prefix cache: hit_rate={hit:.2f} "
              f"pages_shared={m['pages_shared']:.0f} "
              f"cow_copies={m['cow_copies']:.0f} "
              f"occupancy={sched.pool.occupancy():.2f}")
    for rid in sorted(done)[:4]:
        print(f"  req {rid}: {done[rid].generated[:12]}")
    if ctr is not None:
        print()
        print(ctr.report())
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({
                "device": str(lm.device),
                "requests": len(done), "new_tokens": total_new,
                "tok_s": total_new / dt, "host_syncs": eng.host_syncs,
                "mean_ttft_ms": (float(np.mean(ttfts)) * 1e3
                                 if ttfts else None),
                "segments": m["segments"],
                "admissions": m["admissions"],
                "kv_dtype": args.kv_dtype,
                "prefix_cache": not args.no_prefix_cache,
                "prefix_hit_rate": hit,
                "pages_shared": m["pages_shared"],
                "cow_copies": m["cow_copies"],
                "pool_occupancy": (sched.pool.occupancy()
                                   if sched.pool is not None else None),
                "ft_events": sched.ft_events,
                "rejections": m["rejections"],
                "sheds": m["sheds"],
                "expired": m["expired"],
                "cancelled": m["cancelled"],
                "snapshots": m["snapshots"],
                "restores": m["restores"],
                "chaos": (sched.chaos.summary()
                          if sched.chaos is not None else None),
                "spec": spec_summary,
                "regions": ({name: {"calls": r.calls, "time_s": r.time_s}
                             for name, r in ctr.regions.items()}
                            if ctr is not None else None),
            }, fh, indent=2, sort_keys=True)
        print(f"[serve] wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
