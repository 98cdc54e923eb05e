"""Serving launcher: build a model and serve batched requests on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --requests 32 --slots 8 --page-size 16 --kv-dtype int8 \\
        --shared-prefix 256 --json serve.json

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --requests 16 --slots 8 --prompt-len 256 --max-seq 1024

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
        --requests 16 --slots 8 --prompt-len 256 --max-seq 1024

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
        --requests 16 --slots 8 --page-size 16 --max-seq 1024

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen2-moe-a2.7b --requests 16 --slots 8 --page-size 16 \\
        --kv-dtype int8 --shared-prefix 256 --max-seq 1024

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-235b-a22b --layers 2 --page-size 16 --max-seq 1024

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \\
        --requests 16 --slots 8 --page-size 16 --kv-dtype int8 \\
        --shared-prefix 256 --max-seq 1024

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --page-size 16 --temperature 0.7 --draft qwen2-0.5b \\
        --spec-tokens 4 --instrument --json spec.json

    PYTHONPATH=src torchrun --nproc-per-node 3 -m \\
        repro_torch.launch.serve --arch qwen2-0.5b --page-size 16 \\
        --mesh 1x2 --json mesh.json      # 2-way tensor parallel + 1 spare

Runs the continuous-batching ``BatchScheduler`` over synthetic prompts
(deterministic, numpy seed 0) and prints tokens/s, time-to-first-token,
segments, admissions and the engine's audited host-sync count.  The
archs: qwen2-0.5b, qwen1.5-0.5b, stablelm-3b and mistral-large-123b
(dense), qwen2-moe-a2.7b and qwen3-moe-235b-a22b (moe), qwen2-vl-7b
(vlm; text-only requests, as the JAX scheduler admits them: the first
``n_patches`` prompt tokens still take patch-grid positions), zamba2-1.2b
(hybrid) and xlstm-350m (xlstm).  seamless-m4t-medium (encdec) is
refused with a ``ValueError`` before any weights are built: an encdec
prefill needs ``src_embeds``, which no scheduler admission carries (the
JAX launcher fails at its first admission); serve it through
``Engine.generate(prompts, extra_batch={"src_embeds": ...})``.
mistral-large-123b and qwen3-moe-235b-a22b do not fit one 80 GB card at full depth:
``--layers N`` serves the first N layers' worth of a model at full
width.  The recurrent zamba2-1.2b and
xlstm-350m serve with dense state only: ``--page-size`` (with or
without ``--kv-dtype``) gives the engine's error for them.  There is
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
``restores`` and the chaos schedule's events.  ``--straggler-threshold``
and ``--straggler-min-ratio`` tune the scheduler's straggler detector
(flags land in the summary's ``ft_events``).

``--impl FAM=NAME[,...]`` pins kernel impls per registry family (the
port's names, e.g. ``attention=torch_flash,paged_decode=torch_paged``, or
the JAX package's, which map one to one); a bad spec exits non-zero.
The deprecated ``--attn-impl NAME`` expands onto the attention and
paged_decode families and prints the shared deprecation line.  The
engine validates both and the summary lists the pins.  ``--dtype fp32``
serves the model in fp32 (default bf16), and the summary's ``tokens``
holds every request's generated tokens.

``--tune`` autotunes, before serving, the kernels this run serves
through, at its shapes and dtype: the flash kernel's ``(bq, bk)`` at
``--prompt-len`` and, with ``--page-size``, the split of the paged impl
that will run (int8 pages: ``cuda_paged_q8``) at the pool's page size.
Each candidate is timed on the card (device time, L2 flushed) through a
``ProfileSession`` whose cache (``--cache-dir``, ``--no-cache``) persists
the winners, so a second launch sweeps nothing.  It prints the choices
and the session's stats, serves, then prints where each served call's
tile came from (``swept``, ``disk``, ``neighbour`` or ``default``); the
summary's ``tune`` block holds the same.

``--ckpt-dir DIR`` serves trained weights: the latest training
checkpoint under DIR (``repro_torch.launch.train --ckpt-dir``, or the
JAX package's trainer) is restored into the model's parameters, as the
reference restores ``TrainState.params`` under ``AdamWConfig()``; the
optimizer state is checked against the checkpoint and not loaded.  The
summary's ``launches`` counts the kernel wrappers' launches (#1 flash,
#2 and #3 paged decode, #4 argmax) over the run.

``--mesh AxB`` serves sharded over a ``(data, model)`` mesh of ranks
(``Engine(mesh=ServeMesh)``; every family the scheduler serves, so
not encdec, whose scheduler refusal is the reference's own): run it
under ``torchrun
--nproc-per-node N``, one rank a card over NCCL (``--device cpu``:
gloo); with no torchrun environment and ``--mesh 1x1`` the process is a
world of one.  Each rank builds (or restores
with ``--ckpt-dir``) the full model on the CPU as its host copy and puts
only its blocks on its card; random weights then come from a CPU
generator, so on the card they differ from an unsharded launch's.
``--pin`` orders the ranks over
the modelled topology and ``--skip`` holds ranks out as hot spares; the
ranks the mesh leaves out are spares too.  Every rank serves the same
requests; rank 0 prints and writes ``--json``.  ``--ft-timeout-steps``
and ``--ft-confirm`` tune the heartbeat governor that re-meshes onto a
spare when a rank dies (the summary's ``mesh`` and ``ft_events``);
``--tune`` then tunes per sharding (the mesh facts join the tune keys,
at the rank's head counts).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
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
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="serve N layers (default: the config's depth)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                    help="the model's dtype (default bf16)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 (default) decodes greedily; > 0 samples")
    ap.add_argument("--admission-chunk", type=int, default=8,
                    help="decode steps between admission points")
    ap.add_argument("--mesh", default=None, metavar="AxB",
                    help="serve sharded: a (data, model) mesh of ranks — "
                         "weights and the KV cache split their heads over "
                         "'model' (e.g. 1x2 under torchrun "
                         "--nproc-per-node 3: 2-way tensor parallel plus "
                         "a hot spare)")
    ap.add_argument("--pin", default="compact",
                    help="pin strategy ordering the mesh's ranks over the "
                         "topology (compact | scatter | ring | pinlist)")
    ap.add_argument("--skip", default="",
                    help="ranks held out of the mesh as hot spares for "
                         "the ft/ degradation path, e.g. 2")
    cli.add_impl_args(ap, legacy_attn=True)
    cli.add_cache_args(ap)
    cli.add_json_args(ap, what="serve summary")
    cli.add_robustness_args(ap)
    cli.add_ft_args(ap)
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
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the latest training "
                         "checkpoint under this directory")
    args = ap.parse_args(argv)
    ft_kw = cli.ft_kwargs(args, ap)
    serve_mesh, device = None, args.device
    if args.mesh:
        serve_mesh, device = _serve_mesh(args, ap)
        if torch.distributed.get_rank() != 0:
            # every rank serves; rank 0 speaks for the run
            with contextlib.redirect_stdout(io.StringIO()):
                return _serve(args, ap, ft_kw, serve_mesh, device, False)
    return _serve(args, ap, ft_kw, serve_mesh, device, True)


def _serve_mesh(args, ap):
    """Join the process group and build the ServeMesh of ``--mesh``,
    ``--pin`` and ``--skip``; returns (mesh, this rank's device)."""
    from repro_torch.core.pin import parse_pinlist
    from repro_torch.launch import mesh as mesh_mod
    try:
        shape = tuple(int(p) for p in args.mesh.lower().split("x"))
        if len(shape) != 2 or min(shape) < 1:
            raise ValueError
    except ValueError:
        ap.error(f"--mesh wants AxB (data x model), got {args.mesh!r}")
    device = mesh_mod.init_process(args.device)
    skip = tuple(parse_pinlist(args.skip)) if args.skip else ()
    try:
        sm = mesh_mod.make_serve_mesh(shape, pin_strategy=args.pin,
                                      skip=skip)
    except ValueError as e:
        ap.error(f"{e} (world of {torch.distributed.get_world_size()} "
                 f"ranks)")
    return sm, device


def _serve(args, ap, ft_kw, serve_mesh, device, speak: bool) -> int:
    """Build the model and engine and serve the synthetic requests (the
    body of :func:`main`; ``speak`` False on the ranks other than 0)."""
    if serve_mesh is not None:
        from repro_torch.launch.mesh import axis_ici_map
        sm = serve_mesh
        print(f"[serve] mesh {args.mesh} (data, model) over ranks "
              f"{list(sm.device_ids)}, pin={sm.pin.strategy}, "
              f"spares={list(sm.spares)}")
        for row in axis_ici_map(sm.topo, sm.device_ids, sm.axis_sizes,
                                sm.axis_names):
            lay = ("ring" if row["ring"]
                   else f"mean {row['mean_hops']:.1f} hops")
            print(f"[serve]   axis {row['axis']:<6} size {row['size']:>3}  "
                  f"{lay}")

    from repro_torch.configs import get_arch
    from repro_torch.kernels import registry
    from repro_torch.models.lm import LM
    from repro_torch.serve.admission import AdmissionRejected
    from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                          ServeConfig, check_schedulable)

    try:
        impls = registry.parse_impl_spec(args.impl) if args.impl else None
    except ValueError as e:
        ap.error(str(e))
    # --attn-impl stays the ServeConfig spelling (the engine validates and
    # expands it itself); the warning path is the shared one
    cli.warn_legacy_attn_impl(args.attn_impl)
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[args.dtype]
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke_dims else spec.config
    check_schedulable(cfg)
    if args.layers is not None:
        if args.layers < 1:
            ap.error(f"--layers must be at least 1, not {args.layers}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    serve_cfg = ServeConfig(
        max_seq=args.max_seq, batch_slots=args.slots,
        temperature=args.temperature,
        admission_chunk=args.admission_chunk,
        attn_impl=args.attn_impl, impls=impls,
        page_size=args.page_size, pool_pages=args.pool_pages,
        **cli.kv_config_kwargs(args, ap))
    # --draft validates the pairing eagerly (vocab, family, page size)
    # before any weights are built
    spec_kw = cli.spec_kwargs(args, cfg, serve_cfg, ap)
    # a sharded engine takes the full model as its host copy: build and
    # restore it on the CPU, so the card holds this rank's blocks only
    lm = LM(cfg, dtype, "cpu" if serve_mesh is not None else device)
    if args.ckpt_dir:
        restore_params(args.ckpt_dir, lm)
        print("[serve] restored params from checkpoint")
    else:
        lm.init(torch.Generator(device=lm.device).manual_seed(0))
    draft_lm = None
    if spec_kw:
        sc = spec_kw["spec"]
        draft_lm = LM(sc.draft_config, dtype, lm.device).init(
            torch.Generator(device=lm.device).manual_seed(1))
        print(f"[serve] speculative decoding: draft={args.draft} "
              f"K={sc.num_draft_tokens} "
              f"policy={sc.resolve_policy(args.temperature)}")
    eng = Engine(lm, serve_cfg,
                 device=device if serve_mesh is not None else lm.device,
                 mesh=serve_mesh,
                 draft_lm=draft_lm, **spec_kw)
    if impls:
        print(f"[serve] kernel impls pinned: {impls}")
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, {args.dtype}, "
          f"{'checkpoint' if args.ckpt_dir else 'random (seed 0)'} weights "
          f"on {eng.device}"
          + (f", sharded {eng.mesh_facts}" if serve_mesh else ""))
    launches0 = kernel_launches()
    tune = tune_engine(args, cfg, lm, eng) if args.tune else None
    if eng.paged:
        print(f"[serve] paged KV cache: page_size={args.page_size} "
              f"pool_pages={eng.pool_pages} table_width={eng.table_width} "
              f"kv_dtype={args.kv_dtype or 'model'} "
              f"prefix_cache={'on' if not args.no_prefix_cache else 'off'}")

    ctr = None
    if args.instrument:
        from repro_torch.core.perfctr import PerfCtr
        ctr = PerfCtr(device=eng.device)
        eng.instrument(ctr, prompt_len=args.prompt_len)
        print("[serve] instrumented serve.prefill/serve.decode regions")

    sched = BatchScheduler(eng, **ft_kw, **cli.robustness_kwargs(args, ap))
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
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
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
    if sched.heartbeats is not None:
        print(f"[serve] ft: remeshes={m['remeshes']:.0f} "
              f"mesh={list(eng.serve_mesh.device_ids)} "
              f"events={[e['type'] for e in sched.ft_events]}")
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
    if tune is not None:
        tune["served"] = served_tiles()
        for row in tune["served"]:
            print(f"[serve] served {row['family']}/{row['impl']} "
                  f"{row['key']}: {tuple(row['choice'])} from "
                  f"{row['source']}")
    if ctr is not None:
        print()
        print(ctr.report())
    if args.json and speak:
        with open(args.json, "w") as fh:
            json.dump({
                "device": str(eng.device),
                "dtype": args.dtype,
                "impls": eng.impl_pins,
                "tokens": {str(rid): list(r.generated)
                           for rid, r in sorted(done.items())},
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
                "mesh": ({"facts": {k: list(v) if isinstance(v, tuple)
                                    else v
                                    for k, v in eng.mesh_facts.items()},
                          "device_ids": list(eng.serve_mesh.device_ids),
                          "world": torch.distributed.get_world_size(),
                          "remeshes": m["remeshes"]}
                         if serve_mesh is not None else None),
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
                "tune": tune,
                "launches": {k: n - launches0[k]
                             for k, n in kernel_launches().items()},
            }, fh, indent=2, sort_keys=True)
        print(f"[serve] wrote {args.json}")
    return 0


def restore_params(ckpt_dir: str, lm) -> None:
    """Load the params of the latest training checkpoint under
    ``ckpt_dir`` into ``lm`` (cast to its dtype), the reference's
    ``TrainState.params`` under ``AdamWConfig()``: the optimizer leaves
    are matched by path and shape on the ``meta`` device, not read."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainState
    params = dict(lm.named_parameters())
    meta = {k: torch.empty_like(p, device="meta") for k, p in params.items()}
    restore_checkpoint(ckpt_dir, target=TrainState(
        params, init_opt_state(meta, AdamWConfig()),
        torch.zeros((), dtype=torch.int32, device="meta")))


def kernel_launches() -> dict:
    """The serving kernels' launch counters (kernel #1 flash, #2 and #3
    paged decode, #4 argmax)."""
    from repro_torch.kernels import flash_attention, paged_decode, sampling
    return {
        "flash_attention_bhsd": flash_attention.flash_attention_bhsd.launches,
        "paged_decode_attention_grouped":
            paged_decode.paged_decode_attention_grouped.launches,
        "paged_decode_attention_q8_grouped":
            paged_decode.paged_decode_attention_q8_grouped.launches,
        "block_argmax": sampling.block_argmax.launches,
    }


def tune_engine(args, cfg, lm, eng) -> dict:
    """``--tune``: sweep the attention family at the engine's dtype and,
    on a paged engine, the paged impl that will run, at the pool's page
    size.  Returns the choices and the session's stats."""
    from repro_torch.kernels import registry
    sess = cli.session_from_args(args)
    backend = eng.device.type
    dh = cfg.resolved_head_dim
    out = {"choices": {}}
    # a sharded engine tunes PER SHARDING, at the head counts each rank's
    # kernels see: the mesh facts join the tune keys, so each (mesh shape,
    # per-device heads) sweeps once and warm-starts after
    mesh_facts = eng.mesh_facts
    m = mesh_facts["mesh_shape"][-1] if mesh_facts else 1
    h, kvh = cfg.num_heads // m, cfg.num_kv_heads // m
    # tune under the ENGINE's dtype: best() keys on q.dtype at the call,
    # so an fp32 sweep would never serve a bf16 model
    facts = dict(b=1, h=h, kvh=kvh, sq=args.prompt_len, sk=args.prompt_len,
                 dh=dh, dtype=lm.dtype, backend=backend, **mesh_facts)
    rec = registry.autotune("attention", sess, **facts)
    out["choices"]["attention"] = _tuned(rec, None, facts)
    print(f"[serve] attention tuned: (bq, bk)={rec.choice} "
          f"({'swept' if rec.swept else 'warm from tune table'}, "
          f"{rec.lowerings} timed probes)")
    if eng.paged:
        # int8 engines decode through the q8 impl, which has its own tune
        # space: sweep the impl that will actually run, at the pool's page
        # size only (the reference sweeps every page size; a pool has one)
        impl = "cuda_paged_q8" if eng.quantized else "cuda_paged"
        facts = dict(b=args.slots, kvh=kvh,
                     g=cfg.num_heads // cfg.num_kv_heads, dh=dh,
                     ctx=args.max_seq, dtype=lm.dtype,
                     quantized=eng.quantized, backend=backend,
                     **mesh_facts)
        rec = registry.autotune(
            "paged_decode", sess, impl=impl,
            candidates=[(args.page_size, sp) for sp in (1, 2, 4, 8)],
            **facts)
        out["choices"]["paged_decode"] = _tuned(rec, impl, facts)
        print(f"[serve] paged decode ({impl}) tuned: (page_size, split)="
              f"{rec.choice} ({'swept' if rec.swept else 'warm from tune '
              'table'}, {rec.lowerings} timed probes)")
    out["stats"] = sess.stats()
    out["timed_probes"] = sess.lowerings
    print(f"[serve] {sess.stats()}")
    return out


def _tuned(rec, impl, facts) -> dict:
    """One sweep's summary, with the facts it was swept at (the dtype by
    name) so that a caller can rebuild each candidate's probe."""
    return {"key": rec.key, "choice": list(rec.choice), "swept": rec.swept,
            "timed_probes": rec.lowerings, "timer": rec.timer,
            "impl": impl,
            "facts": dict(facts, dtype=str(facts["dtype"]).replace(
                "torch.", "")),
            "scores_us": {str(list(c)): sc * 1e6
                          for c, sc in rec.scores.items()}}


def served_tiles() -> list:
    """Where the tile of every call site this process served came from,
    as ``registry.resolve`` gives it (swept, disk, neighbour, default)."""
    from repro_torch.kernels import registry
    rows = []
    for family, impl, facts in registry.served_sites():
        ts = registry._tuned_spec(family, impl).tune
        choice, source = registry.resolve(family, impl=impl, **facts)
        full = dict(facts, backend=facts.get("backend") or "cuda")
        rows.append({"family": family, "impl": impl,
                     "key": (ts.lookup_key or ts.key)(**full),
                     "choice": list(choice), "source": source})
    return rows


if __name__ == "__main__":
    raise SystemExit(main())
