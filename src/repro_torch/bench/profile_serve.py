"""Where the time of one ``BatchScheduler.run`` goes, on one CUDA card.

    python -m repro_torch.bench.profile_serve [--kv-dtype int8]
        [--no-prefix-cache] [--json out.json]

Builds qwen2-0.5b at full width and depth (bf16, random weights from seed
0) and serves the scheduler path of ``chip_smoke.py``: 32 requests that
share a 256-token prefix, with random suffixes of 16-256 tokens, budgets
of 16-48 tokens and priorities cycling 0,1,1,2, through 8 slots over
pages of 16 tokens (``--kv-dtype``: none, fp32, bf16 or int8).  After a
warm-up run it:

* times two runs on the host clock, ending in ``torch.cuda.synchronize``:
  tokens/s, mean time to first token, segments, host syncs;
* splits one run's wall time between admission (``prefill_slot`` and
  ``copy_pages``) and decode (``decode_segment``), synchronizing after
  each call — this run pays those extra waits, so only its split is kept;
* runs once more under ``torch.profiler`` and sums the device time of
  every CUDA kernel: the device's busy share of the run's wall time, and
  the kernels that take most of it.

Prints one JSON object (also written to ``--json`` when given).  Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bench.profile_generate import _device_time_us

REQUESTS = 32
PREFIX = 256
SUFFIX_LENS = tuple(range(16, 257))
BUDGETS = tuple(range(16, 49))
SLOTS = 8
PAGE_SIZE = 16


def shared_prefix_workload(vocab: int, n: int, prefix: int,
                           suffix_lens, budgets, seed: int
                           ) -> List[Tuple[List[int], int, int]]:
    """(prompt, budget, priority) per request: one shared prefix of
    ``prefix`` tokens, then random suffixes and budgets drawn from
    ``suffix_lens``/``budgets``; priorities cycle 0,1,1,2."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, prefix).tolist()
    work = []
    for i in range(n):
        suffix = rng.integers(1, vocab, int(rng.choice(suffix_lens))).tolist()
        work.append((shared + suffix, int(rng.choice(budgets)),
                     (0, 1, 1, 2)[i % 4]))
    return work


def run_scheduler(eng, work):
    """Submit ``work`` to a fresh scheduler over ``eng`` and run it."""
    from repro_torch.serve.engine import BatchScheduler, Request
    sched = BatchScheduler(eng)
    for rid, (prompt, budget, prio) in enumerate(work):
        sched.submit(Request(rid=rid, prompt=prompt, max_new_tokens=budget,
                             priority=prio))
    done = sched.run()
    return sched, {rid: r.generated for rid, r in done.items()}


def _synced(fn, acc: list):
    """``fn`` followed by a synchronize, its wall time added to acc[0]."""
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[0] += time.perf_counter() - t0
        return out
    return wrapped


def profile(kv_dtype: Optional[str], prefix_cache: bool) -> dict:
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    _build.build_all()
    lm = LM(CONFIG, torch.bfloat16).init(
        torch.Generator(device="cuda").manual_seed(0))
    cfg = ServeConfig(page_size=PAGE_SIZE, max_seq=1024, batch_slots=SLOTS,
                      admission_chunk=8, kv_dtype=kv_dtype,
                      prefix_cache=prefix_cache)
    eng = Engine(lm, cfg)
    work = shared_prefix_workload(CONFIG.vocab, REQUESTS, PREFIX,
                                  SUFFIX_LENS, BUDGETS, seed=0)
    run_scheduler(eng, shared_prefix_workload(
        CONFIG.vocab, SLOTS, PREFIX, SUFFIX_LENS, BUDGETS, seed=1))

    def timed():
        torch.cuda.synchronize()
        syncs0 = eng.host_syncs
        t0 = time.perf_counter()
        sched, out = run_scheduler(eng, work)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ttfts = [r.ttft for r in sched.completed.values()]
        return dict(wall_ms=wall * 1e3,
                    tokens_per_s=sum(map(len, out.values())) / wall,
                    mean_ttft_ms=float(np.mean(ttfts)) * 1e3,
                    segments=sched.metrics["segments"],
                    decode_steps=sched.metrics["decode_steps"],
                    host_syncs=eng.host_syncs - syncs0,
                    prefix_hits=sched.metrics["prefix_hits"],
                    prefilled_tokens=sched.metrics["prefilled_tokens"],
                    prompt_tokens=sched.metrics["prompt_tokens"],
                    new_tokens=sum(map(len, out.values())))

    runs = [timed() for _ in range(2)]

    admit, decode = [0.0], [0.0]
    for name, acc in (("prefill_slot", admit), ("copy_pages", admit),
                      ("decode_segment", decode)):
        setattr(eng, name, _synced(getattr(eng, name), acc))
    split = timed()
    for name in ("prefill_slot", "copy_pages", "decode_segment"):
        delattr(eng, name)
    split.update(admission_ms=admit[0] * 1e3, decode_ms=decode[0] * 1e3,
                 other_host_ms=split["wall_ms"]
                 - (admit[0] + decode[0]) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_scheduler(eng, work)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an op's own entry repeats the device time of the
    # kernels it launched
    avgs = [a for a in prof.key_averages()
            if a.device_type == torch.autograd.DeviceType.CUDA
            and _device_time_us(a) > 0]
    busy_ms = sum(_device_time_us(a) for a in avgs) / 1e3
    top = sorted(avgs, key=_device_time_us, reverse=True)[:12]
    return {
        "kv_dtype": kv_dtype, "prefix_cache": prefix_cache,
        "requests": REQUESTS, "prefix": PREFIX, "slots": SLOTS,
        "page_size": PAGE_SIZE, "runs": runs, "synced_split": split,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels": [{"name": a.key[:90], "calls": a.count,
                         "device_ms": _device_time_us(a) / 1e3}
                        for a in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kv-dtype", default="int8",
                    choices=["none", "fp32", "bf16", "int8"])
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    res = profile(None if args.kv_dtype == "none" else args.kv_dtype,
                  not args.no_prefix_cache)
    res.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               torch=torch.__version__, cuda=torch.version.cuda)
    text = json.dumps(res)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
