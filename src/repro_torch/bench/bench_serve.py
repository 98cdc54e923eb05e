"""Serving hot path on the card: fused decode loop vs per-token host loop.

Counterpart of ``benchmarks/bench_serve.py``, with its model, prompts,
reps, warm-ups and summary keys.  The per-token loop
(``Engine.generate_reference``) pays one host sync a generated token;
the fused loop (``Engine.generate``) one a call.  Reports tokens/s of
both, the speed-up, the audited host syncs, continuous-batching
throughput and time to first token, and the paged engine's shared-prefix
cache.  Claims, carried over unchanged (each raises when it fails):

* fused tokens equal the per-token loop's (the two loops run the same
  kernels on the same rows, so at full width too);
* at most 2 host syncs a fused call;
* the paged scheduler's prefix cache hits ``n_req - 1`` times.

Decode bytes a token come from the ``serve.decode`` region of an
instrumented engine (``Engine.instrument``), read after its probe: one
decode step of ``batch_slots`` rows, divided by them.  The JAX bench
reads that region's artifact; here the bytes are the declared models of
the step's kernels and plain ops (``repro_torch.core.events``,
``LM._declare_ops``), not a compiled-artifact count.

The speed bar, the fused loop at least 3x the per-token loop (2x with
``--smoke``), is recorded under ``bars``; ``main`` exits 1 when it is
missed.  ``--arch qwen2-0.5b`` (or ``qwen2-moe-a2.7b``) serves that
ported config at full width and depth instead (bf16, random weights from
seed 0, pages of 16, 8 prompts, 8 slots) with the same claims and bar.

    PYTHONPATH=src python -m repro_torch.bench.bench_serve [--smoke]
        [--arch qwen2-0.5b|qwen2-moe-a2.7b] [--device cpu] [--json PATH]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bench.common import (bar, card_line, claim, finish,
                                      setup_device, timed)
from repro_torch.core.perfctr import PerfCtr
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve.engine import (DECODE_REGION, BatchScheduler, Engine,
                                      Request, ServeConfig)

#: the JAX bench's ServeConfig; ``--arch`` adds pages and 8 slots
SERVE = dict(max_seq=256, batch_slots=4, temperature=0.0, admission_chunk=8)
#: the ported configs ``--arch`` serves at full width and depth on one card
ARCHS = ("qwen2-0.5b", "qwen2-moe-a2.7b")


def bench_config(smoke: bool) -> LMConfig:
    """The JAX bench's model (``benchmarks/bench_serve.py:28-35``)."""
    if smoke:
        return LMConfig(name="serve-bench", family="dense", vocab=256,
                        d_model=64, n_layers=2, num_heads=4, num_kv_heads=2,
                        d_ff=128)
    return LMConfig(name="serve-bench", family="dense", vocab=1024,
                    d_model=128, n_layers=4, num_heads=8, num_kv_heads=4,
                    d_ff=256)


def prompts(vocab: int, n: int, plen: int, seed: int = 0) -> List[List[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=plen).tolist() for _ in range(n)]


def build(smoke: bool, device: torch.device, arch: Optional[str] = None
          ) -> Engine:
    """The bench's engine: bf16 (the JAX LM's default dtype), random
    weights from seed 0."""
    serve = dict(SERVE)
    if arch is None:
        cfg = bench_config(smoke)
    else:
        from repro_torch.configs import get_arch
        cfg = get_arch(arch).config
        serve.update(batch_slots=8, page_size=16)
    lm = LM(cfg, torch.bfloat16, device).init(
        torch.Generator(device=device).manual_seed(0))
    return Engine(lm, ServeConfig(**serve), device=device)


def run(csv: list, smoke: bool = False, device="cuda",
        arch: Optional[str] = None) -> Dict:
    device = torch.device(device)
    eng = build(smoke, device, arch)
    vocab = eng.lm.cfg.vocab
    batch, plen = eng.cfg.batch_slots, 8
    max_new = 32 if smoke else 64
    reps = 2 if smoke else 5
    ps = prompts(vocab, batch, plen)

    # instrument: the probe's one decode step gives the declared bytes
    # of the serve.decode region (later calls accumulate into it too)
    ctr = PerfCtr(device=device)
    eng.instrument(ctr, prompt_len=plen)
    bytes_per_token = (ctr.regions[DECODE_REGION].events["BYTES_ACCESSED"]
                       / eng.cfg.batch_slots)

    # ---- static batch: fused loop vs per-token host loop ----------------
    eng.generate(ps, max_new_tokens=max_new)              # warm-up
    eng.generate_reference(ps, max_new_tokens=max_new)    # warm-up
    s0 = eng.host_syncs
    out_f, t_fused = timed(device, lambda: eng.generate(
        ps, max_new_tokens=max_new), reps)
    syncs_fused = (eng.host_syncs - s0) // reps
    s0 = eng.host_syncs
    out_r, t_ref = timed(device, lambda: eng.generate_reference(
        ps, max_new_tokens=max_new), reps)
    syncs_ref = (eng.host_syncs - s0) // reps

    claim(out_f == out_r, "fused loop diverged from the reference loop")
    ntok = sum(len(o) for o in out_f)
    tps_fused, tps_ref = ntok / t_fused, ntok / t_ref
    speedup = tps_fused / tps_ref
    print(f"== serving decode loop ({eng.lm.cfg.name}, equal-length wave, "
          f"greedy) ==")
    print(f"reference (per-token sync): {tps_ref:10.1f} tok/s   "
          f"{syncs_ref:4d} host syncs/call")
    print(f"fused (on-device loop):     {tps_fused:10.1f} tok/s   "
          f"{syncs_fused:4d} host syncs/call")
    print(f"speedup: {speedup:.2f}x")
    claim(syncs_fused <= 2, f"fused loop made {syncs_fused} host syncs")

    # ---- continuous batching: ragged budgets, mid-flight admission ------
    n_req = 8 if smoke else 16
    chunk = eng.cfg.admission_chunk
    warm = BatchScheduler(eng)
    for rid in range(2):
        warm.submit(Request(rid=rid, prompt=prompts(vocab, 1, plen)[0],
                            max_new_tokens=2 * chunk - 1))
    warm.run()
    sched = BatchScheduler(eng)
    rng = np.random.default_rng(1)
    for rid in range(n_req):
        sched.submit(Request(
            rid=rid, prompt=prompts(vocab, 1, plen, seed=rid)[0],
            max_new_tokens=int(rng.integers(max_new // 2, max_new + 1))))
    done, t_sched = timed(device, sched.run)
    total = sum(len(r.generated) for r in done.values())
    ttfts = [r.ttft for r in done.values() if r.ttft is not None]
    ttft_ms = float(np.mean(ttfts)) * 1e3 if ttfts else float("nan")
    tps_sched = total / t_sched
    print("== continuous batching (ragged budgets, slot reuse) ==")
    print(f"{len(done)} requests, {total} tokens: {tps_sched:10.1f} tok/s  "
          f"mean TTFT {ttft_ms:.1f} ms  "
          f"segments={sched.metrics['segments']:.0f} "
          f"admissions={sched.metrics['admissions']:.0f}")
    print()
    print(ctr.report())

    # ---- paged engine + prefix cache: serving telemetry -----------------
    peng = Engine(eng.lm, ServeConfig(**dict(
        SERVE, batch_slots=eng.cfg.batch_slots, page_size=16)),
        device=device)
    psched = BatchScheduler(peng)
    shared_sys = prompts(vocab, 1, 24, seed=42)[0]
    for rid in range(n_req):
        psched.submit(Request(
            rid=rid,
            prompt=shared_sys + prompts(vocab, 1, plen, seed=100 + rid)[0],
            max_new_tokens=max_new // 2))
    pdone, t_prefix = timed(device, psched.run)
    pm = psched.metrics
    prefix_hit_rate = ((pm["prompt_tokens"] - pm["prefilled_tokens"])
                       / max(pm["prompt_tokens"], 1))
    pool_occupancy = psched.pool.occupancy()
    ptok = sum(len(r.generated) for r in pdone.values())
    print("== paged engine + shared-prefix radix cache ==")
    print(f"{len(pdone)} requests, {ptok} tokens: {ptok / t_prefix:10.1f} "
          f"tok/s  prefix_hit_rate={prefix_hit_rate:.2f} "
          f"pages_shared={pm['pages_shared']:.0f} "
          f"cow_copies={pm['cow_copies']:.0f} "
          f"occupancy={pool_occupancy:.2f}")
    claim(pm["prefix_hits"] == n_req - 1,
          f"prefix hits {pm['prefix_hits']}, expected {n_req - 1}: {pm}")
    print(f"decode traffic: {bytes_per_token / 1e6:.3f} MB/token "
          f"(declared events, {eng.cfg.batch_slots} slots)")

    floor = 2.0 if smoke else 3.0
    csv.append(("serve_fused_tok_s", 1e6 / tps_fused,
                f"tok_s={tps_fused:.1f},speedup_vs_host_loop={speedup:.2f},"
                f"host_syncs={syncs_fused}"))
    csv.append(("serve_reference_tok_s", 1e6 / tps_ref,
                f"tok_s={tps_ref:.1f},host_syncs={syncs_ref}"))
    csv.append(("serve_continuous_tok_s", 1e6 / tps_sched,
                f"tok_s={tps_sched:.1f},ttft_ms={ttft_ms:.2f}"))
    csv.append(("serve_decode_bytes_per_token", bytes_per_token,
                f"mb_per_token={bytes_per_token / 1e6:.3f}"))
    csv.append(("serve_prefix_tok_s", 1e6 * t_prefix / max(ptok, 1),
                f"hit_rate={prefix_hit_rate:.3f},"
                f"pages_shared={pm['pages_shared']:.0f}"))
    return {
        "model": eng.lm.cfg.name,
        "fused_tok_s": tps_fused,
        "reference_tok_s": tps_ref,
        "speedup": speedup,
        "host_syncs_fused": int(syncs_fused),
        "host_syncs_reference": int(syncs_ref),
        "continuous_tok_s": tps_sched,
        "ttft_ms": ttft_ms,
        "tokens": int(ntok),
        "decode_bytes_per_token": bytes_per_token,
        "paged_prefix_tok_s": ptok / t_prefix,
        "prefix_hit_rate": prefix_hit_rate,
        "pages_shared": pm["pages_shared"],
        "cow_copies": pm["cow_copies"],
        "pool_occupancy": pool_occupancy,
        "bars": {"fused_speedup": bar(speedup, floor)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI scale: tiny model, few reps, the 2x bar")
    ap.add_argument("--arch", default=None, choices=ARCHS,
                    help="serve this ported config at full width instead")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the serving summary here")
    args = ap.parse_args(argv)
    device = setup_device(args.device)
    print(f"[bench_serve] device {device}: {card_line(device)}")
    csv: list = []
    summary = run(csv, smoke=args.smoke, device=device, arch=args.arch)
    return finish("bench_serve", csv, summary, args, device)


if __name__ == "__main__":
    raise SystemExit(main())
