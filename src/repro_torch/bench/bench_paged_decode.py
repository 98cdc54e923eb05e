"""Paged KV decode on the card: tok/s AND bytes/token across slot mixes.

Counterpart of ``benchmarks/bench_paged_decode.py`` at its sizes (fp32,
vocab 256, 2 layers, 4 heads over 2 KV heads of 32; ``max_seq`` 512 with
``--smoke``, else 1024; pages of 16, 4 slots).  The dense engine scores
its whole ``[B, max_seq]`` cache buffer every token; the paged engine
(``serve/kv_pool.py`` + kernels #2 and #3) reads each row's live pages.
Claims, carried over (each raises when it fails):

* for each slot mix (short, long, mixed-ragged) the same requests through
  a dense and a paged scheduler give equal fp32 greedy tokens, and the
  pool ends drained and leak-free;
* on the mixed-ragged mix (rows <= max_seq/4) the paged engine's decode
  bytes a token are at most 0.5x the masked dense engine's;
* a shared system prompt through the prefix cache gives the uncached
  run's tokens, with ``n_req - 1`` hits and copy-on-write copies and
  exactly ``full_len + (n_req - 1) * s_len`` prefilled tokens, and the
  prefill FLOPs drop by at least half the token hit rate;
* int8 pages decode at most 0.6x the fp32 paged engine's bytes a token,
  with decode-step logits within 0.05 of the fp32 engine's (and not
  equal to them), and compose with the prefix cache;
* the card's paged engine gives the dense engine's tokens.

The JAX bench reads bytes and FLOPs from compiled artifacts it never
runs.  Here they are the declared events of the work the schedulers ran
(the kernels' and ``LM._declare_ops``' models, ``repro_torch.core.
events``), read from a ``PerfCtr`` attached to the engine for a second,
untimed run of the same requests: decode bytes a token are the
``serve.decode`` region's bytes over decode steps x slots, prefill FLOPs
the ``serve.prefill`` region's.  The paged kernels read live pages only,
where the JAX artifact prices the whole table, so the int8 comparison
runs on the long-context mix (rows near ``max_seq / 2``), the rows the
JAX bench's full table stands for.

The autotune half (``--tune``, or ``run(..., tune=True)``): the paged
kernel's ``(page_size, split)`` — where the JAX bench sweeps
``(page_size, pages_per_block)`` through the deprecated
``kernels/autotune.py`` — at the bench's decode shape through
``registry.autotune`` and a ``ProfileSession``, then the same sweep on a
fresh session over the same cache, which must time nothing.

    PYTHONPATH=src python -m repro_torch.bench.bench_paged_decode
        [--smoke] [--device cpu] [--tune] [--json PATH]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.bench.common import (card_line, claim, finish,
                                      setup_device, sync, tune_session)
from repro_torch.core.perfctr import PerfCtr
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve.engine import (DECODE_REGION, PREFILL_REGION,
                                      BatchScheduler, Engine, Request,
                                      ServeConfig)
from repro_torch.serve.kv_pool import KVPool, pages_for

PS = 16
SLOTS = 4


def bench_config() -> LMConfig:
    """The JAX bench's model (``benchmarks/bench_paged_decode.py:41-50``)."""
    return LMConfig(name="paged-bench", family="dense", vocab=256,
                    d_model=64, n_layers=2, num_heads=4, num_kv_heads=2,
                    d_ff=128, head_dim=32)


def mixes(max_seq: int) -> Dict[str, List[int]]:
    """Per-slot context lengths: the three traffic shapes of the claim."""
    return {
        "short_ctx": [max_seq // 16] * 4,
        "long_ctx": [max_seq // 2, max_seq // 2 - 9,
                     max_seq // 2 - 17, max_seq // 2 - 33],
        "mixed_ragged": [max_seq // 32, max_seq // 8,
                         max_seq // 4, max_seq // 16],
    }


def _serve(eng: Engine, prompts: List[List[int]], max_new: int,
           instrument: bool = False) -> Tuple[BatchScheduler, Dict, float]:
    """One scheduler run of ``prompts``: (scheduler, done, seconds).
    ``instrument`` attaches a fresh ``PerfCtr`` to the engine for the run
    (``eng.perfctr`` afterwards)."""
    eng.perfctr = PerfCtr(device=eng.device) if instrument else None
    sched = BatchScheduler(eng)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    sync(eng.device)
    t0 = time.perf_counter()
    done = sched.run()
    sync(eng.device)
    return sched, done, time.perf_counter() - t0


def _region(eng: Engine, region: str, event: str) -> float:
    return eng.perfctr.regions[region].events[event]


def _bytes_per_token(eng: Engine, prompts, max_new: int, want: Dict
                     ) -> float:
    """Declared decode bytes a row-step over an instrumented rerun, whose
    tokens must be the timed run's."""
    sched, done, _ = _serve(eng, prompts, max_new, instrument=True)
    claim(_tokens(done) == _tokens(want),
          "the instrumented rerun changed the tokens")
    steps = sched.metrics["decode_steps"] * eng.cfg.batch_slots
    return _region(eng, DECODE_REGION, "BYTES_ACCESSED") / steps


def _tokens(done: Dict) -> Dict[int, List[int]]:
    return {rid: list(r.generated) for rid, r in done.items()}


def autotune_half(csv: list, smoke: bool, device, max_seq: int,
                  session=None) -> Dict:
    """The (page_size, split) sweep at the bench's decode shape in fp32,
    cold and then on a fresh session over the same cache; without a
    ``session``, one from :func:`tune_session`."""
    from repro_torch.core.artifact_cache import ArtifactCache
    from repro_torch.core.session import ProfileSession
    from repro_torch.kernels import registry
    if session is None:
        with tune_session() as session:
            return autotune_half(csv, smoke, device, max_seq, session)
    cands = (((16, 1), (16, 2), (32, 1), (32, 2)) if smoke
             else registry.DEFAULT_PAGED_CANDIDATES)
    kw = dict(b=SLOTS, kvh=2, g=2, dh=32, ctx=max_seq // 4,
              dtype=torch.float32, backend=device.type, candidates=cands)
    t0 = time.perf_counter()
    rec = registry.autotune("paged_decode", session, **kw)
    t_cold = time.perf_counter() - t0
    warm = ProfileSession(cache=ArtifactCache(
        session.cache.root, enabled=session.cache.enabled))
    t0 = time.perf_counter()
    registry.autotune("paged_decode", warm, **kw)
    t_warm = time.perf_counter() - t0
    print("== (page_size, split) autotune over ProfileSession ==")
    for (ps, sp), score in sorted(rec.scores.items(), key=lambda kv: kv[1]):
        mark = " <- chosen" if (ps, sp) == tuple(rec.choice) else ""
        print(f"  ps={ps:<4d} split={sp}: {score * 1e6:9.3f} us{mark}")
    print(f"cold sweep: {rec.lowerings} timed probes, {t_cold:.2f}s; "
          f"warm rerun: {warm.lowerings} timed probes, {t_warm:.2f}s")
    if session.cache.enabled:
        claim(warm.lowerings == 0,
              f"warm paged autotune re-timed {warm.lowerings}")
    csv.append(("paged_autotune_warm_s", t_warm * 1e6,
                f"lowerings_warm={warm.lowerings},"
                f"lowerings_cold={rec.lowerings}"))
    return {"page_size": rec.choice[0], "split": rec.choice[1],
            "score_us": rec.score_s * 1e6,
            "lowerings_cold": rec.lowerings,
            "lowerings_warm": warm.lowerings}


def run(csv: list, smoke: bool = False, device="cuda",
        tune: bool = False) -> Dict:
    device = torch.device(device)
    lm = LM(bench_config(), torch.float32, device).init(
        torch.Generator(device=device).manual_seed(0))
    vocab = lm.cfg.vocab
    max_seq = 512 if smoke else 1024
    max_new = 6 if smoke else 16
    rng = np.random.default_rng(0)
    dense_eng = Engine(lm, ServeConfig(max_seq=max_seq, batch_slots=SLOTS),
                       device=device)
    summary: Dict = {"page_size": PS, "max_seq": max_seq, "mixes": {}}
    print("== paged vs dense decode: tok/s + bytes/token per slot mix ==")
    for mix_name, ctxs in mixes(max_seq).items():
        prompts = [rng.integers(1, vocab, size=n).tolist() for n in ctxs]
        _, ddone, t_dense = _serve(dense_eng, prompts, max_new)
        pool_pages = sum(pages_for(n + max_new + 8, PS) for n in ctxs) + 1
        eng = Engine(lm, ServeConfig(max_seq=max_seq, batch_slots=SLOTS,
                                     page_size=PS, pool_pages=pool_pages),
                     device=device)
        sched, done, t_paged = _serve(eng, prompts, max_new)
        sched.pool.check()
        # drained: every page is free, or index-only in the prefix trie
        claim(sched.pool.reclaimable() == sched.pool.num_pages - 1,
              f"{mix_name}: pool not drained: {sched.pool!r}")
        claim(sched.pool.allocs == sched.pool.releases,
              f"{mix_name}: pool leaked: {sched.pool!r}")
        claim(_tokens(done) == _tokens(ddone),
              f"{mix_name}: paged tokens diverged from dense")
        bt_dense = _bytes_per_token(dense_eng, prompts, max_new, ddone)
        bt_paged = _bytes_per_token(eng, prompts, max_new, done)
        ratio = bt_paged / bt_dense
        ntok = sum(len(r.generated) for r in done.values())
        print(f"{mix_name:>13}: ctx={ctxs}  bytes/token "
              f"dense {bt_dense / 1e6:7.3f} MB  paged {bt_paged / 1e6:7.3f} "
              f"MB (ratio {ratio:.3f})   tok/s paged {ntok / t_paged:8.1f} "
              f"dense {ntok / t_dense:8.1f}")
        summary["mixes"][mix_name] = {
            "contexts": ctxs,
            "bytes_per_token_dense": bt_dense,
            "bytes_per_token_paged": bt_paged,
            "ratio": ratio,
            "paged_tok_s": ntok / t_paged,
            "dense_tok_s": ntok / t_dense,
            "pool_pages": pool_pages,
        }
        csv.append((f"paged_decode_{mix_name}", 1e6 * t_paged / max(ntok, 1),
                    f"bytes_ratio={ratio:.3f},"
                    f"bt_paged_mb={bt_paged / 1e6:.3f},"
                    f"bt_dense_mb={bt_dense / 1e6:.3f}"))
    mixed = summary["mixes"]["mixed_ragged"]
    claim(mixed["ratio"] <= 0.5,
          f"paged bytes/token {mixed['ratio']:.3f}x dense on mixed_ragged")

    # ---- shared-prefix radix cache: 1 full prefill + N-1 suffixes -----
    # the shared prompt ends MID-page, so every later admission forks
    # inside an indexed page (copy-on-write); distinct first suffix
    # tokens make the match length exact
    n_req, s_len = 6, 24
    p_shared = PS * 2 + PS // 2
    full_len = p_shared + s_len
    sp_rng = np.random.default_rng(7)
    shared_sys = sp_rng.integers(1, vocab, size=p_shared).tolist()
    sp_prompts = [shared_sys + [10 + i]
                  + sp_rng.integers(1, vocab, size=s_len - 1).tolist()
                  for i in range(n_req)]
    sp_seq = 128      # the suffix attends the whole table: keep it small

    def sp_engine(prefix_cache: bool) -> Engine:
        return Engine(lm, ServeConfig(
            max_seq=sp_seq, batch_slots=SLOTS, page_size=PS,
            pool_pages=SLOTS * pages_for(full_len + max_new + 8, PS)
            + 4 * pages_for(full_len, PS) + 1,
            prefix_cache=prefix_cache), device=device)

    eng_nc, eng_pc = sp_engine(False), sp_engine(True)
    sched_nc, done_nc, _ = _serve(eng_nc, sp_prompts, max_new,
                                  instrument=True)
    sched_pc, done_pc, _ = _serve(eng_pc, sp_prompts, max_new,
                                  instrument=True)
    sched_nc.pool.check()
    sched_pc.pool.check()
    claim(_tokens(done_pc) == _tokens(done_nc),
          "prefix-cached tokens diverged from the uncached run (fp32 "
          "greedy)")
    m = sched_pc.metrics
    claim(m["prefix_hits"] == n_req - 1, f"prefix hits: {m}")
    claim(m["cow_copies"] == n_req - 1,
          f"in-page forks should COW once per hit: {m}")
    claim(m["prefilled_tokens"] == full_len + (n_req - 1) * s_len,
          f"prefilled tokens: {m}")
    hit_rate = (m["prompt_tokens"] - m["prefilled_tokens"]) \
        / m["prompt_tokens"]
    # declared FLOPs of every prefill the two runs executed
    flops_uncached = _region(eng_nc, PREFILL_REGION, "FLOPS_TOTAL")
    flops_cached = _region(eng_pc, PREFILL_REGION, "FLOPS_TOTAL")
    flop_drop = 1.0 - flops_cached / flops_uncached
    print(f"shared prefix: hit_rate={hit_rate:.3f} "
          f"pages_shared={m['pages_shared']:.0f} "
          f"cow_copies={m['cow_copies']:.0f}  prefill FLOPs "
          f"{flops_uncached / 1e6:.2f}M -> {flops_cached / 1e6:.2f}M "
          f"(drop {flop_drop:.3f})")
    # the suffix prefill still attends the whole table-width context, so
    # the drop trails the token hit rate by a bounded margin
    claim(flop_drop >= 0.5 * hit_rate,
          f"prefill FLOP drop {flop_drop:.3f} vs hit rate {hit_rate:.3f}")
    summary["prefix_cache"] = {
        "requests": n_req, "shared_tokens": p_shared, "suffix_tokens": s_len,
        "prefix_hit_rate": hit_rate,
        "pages_shared": m["pages_shared"],
        "cow_copies": m["cow_copies"],
        "pool_occupancy": sched_pc.pool.occupancy(),
        "index_pages": sched_pc.pool.index_pages(),
        "prefill_flops_cached": flops_cached,
        "prefill_flops_uncached": flops_uncached,
        "prefill_flop_drop": flop_drop,
    }
    csv.append(("paged_prefix_cache", flops_cached / 1e6,
                f"hit_rate={hit_rate:.3f},flop_drop={flop_drop:.3f},"
                f"cow={m['cow_copies']:.0f}"))

    # ---- int8 KV pages: fewer bytes a token, bounded logit error ------
    q8_atol = 0.05   # pinned: decode-logit |err| bound vs the fp32 engine
    long_ctx = summary["mixes"]["long_ctx"]["contexts"]
    long_prompts = [np.random.default_rng(1).integers(1, vocab, size=n)
                    .tolist() for n in long_ctx]

    def long_bytes(kv_dtype):
        eng = Engine(lm, ServeConfig(max_seq=max_seq, batch_slots=SLOTS,
                                     page_size=PS, kv_dtype=kv_dtype),
                     device=device)
        _, done, _ = _serve(eng, long_prompts, max_new)
        return _bytes_per_token(eng, long_prompts, max_new, done)

    bt_fp, bt_q8 = long_bytes(None), long_bytes("int8")
    q8_ratio = bt_q8 / bt_fp
    claim(q8_ratio <= 0.6,
          f"int8 decode bytes/token {q8_ratio:.3f}x fp32 (want <= 0.6)")

    def one_slot_logits(kv_dtype) -> np.ndarray:
        """Prefill a slot, then DECODE one token: prefill attends over the
        in-flight fp values (it stores codes), so only a decode step, which
        reads the quantized pages back, sees the error."""
        e = Engine(lm, ServeConfig(max_seq=128, batch_slots=1, page_size=PS,
                                   kv_dtype=kv_dtype), device=device)
        pool = KVPool(e.pool_pages, PS, 1, e.table_width)
        pool.ensure(0, full_len + 1)
        st, lg = e.init_state()
        st = e.set_page_table(st, pool.table())
        st, _ = e.prefill_slot(st, lg, sp_prompts[0], 0,
                               table_row=pool.tables[0])
        with torch.inference_mode():
            step_lg, _ = lm.decode_step(
                torch.full((1, 1), 5, dtype=torch.int32, device=device), st)
        return step_lg[0].float().cpu().numpy()

    q8_err = float(np.max(np.abs(one_slot_logits("int8")
                                 - one_slot_logits(None))))
    claim(0.0 < q8_err <= q8_atol,
          f"int8 decode logits off by {q8_err:.4f} (pinned atol {q8_atol})")

    # the int8 engine composes with the prefix cache: the same trie
    # behaviour (token-keyed, dtype-blind), full generation lengths
    q8_eng = Engine(lm, ServeConfig(max_seq=max_seq, batch_slots=SLOTS,
                                    page_size=PS, kv_dtype="int8"),
                    device=device)
    q8_sched, q8_done, _ = _serve(q8_eng, sp_prompts, max_new)
    q8_sched.pool.check()
    mq = q8_sched.metrics
    claim(mq["prefilled_tokens"] == m["prefilled_tokens"],
          "int8 engine saw a different prefix-hit pattern than fp32")
    claim(all(len(r.generated) == max_new for r in q8_done.values()),
          "an int8 request ended short of its budget")
    agree = float(np.mean([t == u for r in q8_done
                           for t, u in zip(q8_done[r].generated,
                                           done_pc[r].generated)]))
    print(f"int8 KV (long_ctx): bytes/token {bt_q8 / 1e6:.3f} MB vs fp32 "
          f"{bt_fp / 1e6:.3f} MB (ratio {q8_ratio:.3f})  decode |logit "
          f"err| {q8_err:.4f} <= {q8_atol}  greedy agreement {agree:.2f}")
    summary["int8"] = {
        "bytes_per_token_fp32": bt_fp, "bytes_per_token_int8": bt_q8,
        "ratio": q8_ratio, "logit_max_err": q8_err, "logit_atol": q8_atol,
        "greedy_agreement": agree,
        "prefix_hit_rate": (mq["prompt_tokens"] - mq["prefilled_tokens"])
        / mq["prompt_tokens"],
    }
    csv.append(("paged_int8_bytes_ratio", q8_ratio * 100,
                f"bt_q8_mb={bt_q8 / 1e6:.3f},bt_fp_mb={bt_fp / 1e6:.3f},"
                f"logit_err={q8_err:.4f}"))

    # ---- the paged engine (kernel #2 on the card) equals dense --------
    short = [[3, 1, 4, 1, 5], [9, 2, 6]]
    want = dense_eng.generate(short, max_new_tokens=4)
    keng = Engine(lm, ServeConfig(max_seq=64, batch_slots=2, page_size=8),
                  device=device)
    got = keng.generate(short, max_new_tokens=4)
    claim(got == want, "the paged engine diverged from dense")
    print(f"paged engine on {device.type}: token-identical to dense (fp32 "
          f"greedy)")
    summary["paged_engine_parity"] = True
    if tune:
        summary["autotune"] = autotune_half(csv, smoke, device, max_seq)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI scale: max_seq 512, short generations")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the summary here")
    ap.add_argument("--tune", action="store_true",
                    help="also run the (page_size, split) autotune half")
    args = ap.parse_args(argv)
    device = setup_device(args.device)
    print(f"[bench_paged_decode] device {device}: {card_line(device)}")
    csv: list = []
    summary = run(csv, smoke=args.smoke, device=device, tune=args.tune)
    return finish("bench_paged_decode", csv, summary, args, device)


if __name__ == "__main__":
    raise SystemExit(main())
