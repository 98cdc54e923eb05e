#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the repository root, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is allowed to carry on past a
failure):

1. probe     - torch / CUDA versions, the card, its power limit;
2. build     - every kernel of ``src/repro_torch/csrc`` with nvcc, in
               parallel;
3. kernels   - each kernel against its plain PyTorch version on the card,
               at the main paths' shapes and at edge cases (fp32
               rtol=atol=1e-5, bf16 3e-2, argmax exact; flash in fp32 and
               bf16 at ragged kv_valid with a 0 row (exactly 0), causal
               and not, q_offset with Sq < Sk, every head dim, many kv
               tiles, BSHD views at qwen2's and zamba2's shapes, and beside
               SDPA's flash backend on full-length rows; argmax with ties
               and NaN either side of its split boundaries, views from
               column 1, V = 32000, B = 1 and 64; both paged kernels
               across their cluster split (a row of 38 pages, rows
               shorter than the cluster, G = 32 at Dh 128, pages of 8 and
               32, the scheduler's 64-page table; a row of no past token
               exactly v_new), the fp kernel in fp32, bf16 and with fp32
               pages under a bf16 query; the SSD
               scan, a reordered sum, at fp32 rtol=2e-4, atol=2e-5 (C and
               n at that tolerance for bf16 inputs too): ragged S, S <
               chunk, dv over two tiles, normalize, a carried state, log_f
               = -30, mLSTM's dk = dv = 512, the bf16 route's edges (4-byte
               rows, chunk 1024), the flat [512,512,64] layout, the
               scheduler's one-row admissions (B = 1, S = 64, 300, 512,
               timed) and zamba2's generate call, with the device time of
               the bf16 route's three passes; a bf16 call must run those
               three ``__global__`` functions and an fp32 call the CUDA-core
               one, by name under ``torch.profiler``); median
               times of the kernel, the plain version and, where one
               PyTorch call computes the same function, that call
               (``library_ms``; the port never calls it); the host's
               microseconds a call for flash and argmax beside their
               library calls, and for both paged wrappers with their
               split;
4. generate  - qwen2-0.5b at full width (24 layers, bf16, random weights
               from seed 0) serving 8 ragged prompts through
               ``Engine.generate`` with a paged KV cache, greedy, 32 new
               tokens;
5. scheduler - the same model behind ``BatchScheduler`` (8 slots, int8
               pages of 16 tokens, the prefix cache on): 32 requests
               sharing a 256-token prefix, ragged suffixes and budgets,
               priorities 0,1,1,2; every request completes, one host sync
               per segment, ``KVPool.check()`` and ``scheduler.check()``
               pass, tokens/s, mean TTFT and segments are printed;
6. tokens    - fp32, full width, 2 layers: the paged engine on the card
               (kernels), the dense engine on the card and the paged engine
               on the CPU (plain versions) must emit the same greedy tokens,
               and the card's prefill logits must match the CPU's within
               max|d| / max|logit| <= 1e-4;
7. sched fp32 - the same 2-layer model: the card's scheduler (paged, model-
               dtype pages, a fork inside a shared page) must give the
               card's ``Engine.generate`` tokens and the CPU scheduler's;
               int8 decode-step logits, card against CPU, within
               max|d| / max|logit| <= 1e-2 (a code can flip by one where
               the two devices round K differently);
8. zamba2 generate - zamba2-1.2b at full width and depth (38 Mamba2
               layers, the shared block at 7 points, bf16, random weights
               from seed 0): 8 prompts of 512 tokens through
               ``Engine.generate`` with dense KV, 32 greedy tokens; the SSD
               kernel launches 38 times, flash 7;
9. zamba2 scheduler - the same model behind ``BatchScheduler`` (8 slots,
               dense KV, max_seq 1024): 16 requests of 64-512-token
               prompts, budgets 16-48; every request completes, one host
               sync per segment, ``scheduler.check()`` passes, tokens/s and
               mean TTFT are printed;
10. zamba2 tokens - fp32, full width, 7 layers (two groups, the second
               partial): greedy tokens on the card (kernels) equal the
               CPU's (plain versions) on 300-token prompts, and prefill
               logits agree within max|d| / max|logit| <= 1e-4;
11. case kernels - the tool layer's case-study kernels against their plain
               versions (fp32 rtol=atol=1e-5, bf16 3e-2): STREAM triad at
               N = 128, 4096, 128*513 and 2^27, fp32 and bf16, one CTA at
               the small N, unaligned views, bit-equal across block_rows
               and one CTA; Jacobi-7 at T = 1..4 on (10,18,130),
               (16,26,130), (37,45,99) (ragged edge columns, bit-equal
               across tiles and streamed x extents; also T = 6 and 8, and
               T = 9 refused) and 512^3 (bit-equal
               across 16- and 4-byte copies and tiles); times as in phase
               3 (``library_ms``: ``torch.add(b, c, alpha=s, out=a)`` for
               the triad, also printed in bf16; a ``conv3d`` with the
               6-neighbour filter, cuDNN's TF32 off, is timed beside one
               naive sweep; the T = 4 wavefront against 4 naive sweeps in
               ms, MLUPS and declared GB/s);
12. perfctr  - the case studies at full size (triad 2^27 fp32, 100
               samples; Jacobi 512^3, 4 naive sweeps against one T=4
               wavefront) through ``PerfCtr`` marker regions with the HBM
               and ROOFLINE groups, then the bandwidth map (16 KiB .. 2
               GiB); fails if a region records no launch, if its
               ``LAUNCHES`` differ from the wrapper counters, or if a
               working set over 4x L2 reads above 105% of the data-sheet
               HBM bandwidth;
13. sampled  - qwen2-0.5b at full width and depth (bf16, the embedding
               scaled by 0.1 as in phase 6, pages of 16, the 8 ragged
               prompts of phase 4, 32 new tokens) through
               ``Engine.generate`` at temperature 0.7 with top_k 50, then
               top_p 0.9: the same seed twice gives the same tokens, one
               host sync a call (the draws must move a first step whose
               mean top-1 probability is under 0.5), and #4 launches 32
               times a call, #1 24 and #2 744; one step's #4 launch equals
               its plain twin over the same Gumbel-shifted logits (a
               top_k row is -inf outside its 50 tokens, and one row has a
               single finite entry); tokens/s;
14. speculative - K = 4 with a 2-layer draft sharing the target's
               embedding, final norm, head and first two blocks: in fp32
               (the embedding scaled by 0.1, as in phase 6) spec greedy
               tokens equal target-only greedy tokens, fused and streamed;
               in bf16 (phase 13's model) the accept rate, rounds, host
               syncs and tokens/s
               beside target-only's; then a ``BatchScheduler`` (8 slots,
               bf16 pages of 16, 16 requests, half with ``spec=True``):
               every request completes, one host sync a segment,
               ``KVPool.check()`` and ``scheduler.check()`` pass.  Each run
               must launch #1 once a layer of each prefill, #2 (K+1) x 2
               times a round and #4 K+3 times a round (``y``, the K+1 draft
               samples, the verify's argmax);
15. snapshots and chaos - (a) fp32, full width, 2 layers (phase 7's
               model, the embedding scaled by 0.1), fp32 pages of 16, the
               prefix cache on: a ``BatchScheduler`` with a snapshot every
               segment is stopped after 2 segments, a FRESH ``Engine``
               restores the newest snapshot and runs to the end; every
               request's tokens must equal an uninterrupted card run's and
               the restore must use the page index (#1, #2, #4 launch).
               (b) phase 5's model and traffic at full width and depth
               (bf16, the embedding scaled by 0.1 as in phases 13-14, int8
               pages): tokens/s with snapshots every 0 and every 1
               segment in turns (0, 1, 1, 0; the tokens must not move),
               then ``ChaosSchedule.smoke()`` with a snapshot every 2
               segments, killed after 8 and restored on a fresh engine:
               every event applied (flap and death skipped on one card),
               ``KVPool.check()`` and ``scheduler.check()`` after every
               event, the corrupted snapshot refused by the loader and by
               ``Engine.restore``, every request terminal, #1, #3 and #4
               launched.  Host syncs = segments + snapshots that carry an
               index on every snapshot run.  Snapshot bytes and write ms,
               index pages, restore ms, tokens/s and the share of
               restored tokens equal to the uninterrupted run are printed
               beside the card's name and power limit.

Phases 4, 5, 8, 9, 12, 13, 14 and 15 are the main paths: each is run with its
kernels' launch counters set to 0 just before it and read just after, and
fails if one of its kernels never launched (or, on the serving paths,
launched another number of times than the path implies).  The last two
lines of stdout are the kernel table as JSON (``launches`` from the path
that carries each kernel, ``launches_by_path`` from every path that runs
it) and the result line ``{"ok": true, "device": {...}}``.  It never
imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense tensor-core bf16 peak
F32_FLOPS = 67e12                # fp32 on CUDA cores (triad, stencil)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
PROMPT_LENS = [512, 384, 301, 256, 129, 64, 17, 1]
MAX_NEW = 32
PAGE_SIZE = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def gpu_name_and_limit() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


class Timer:
    """Median per-launch device time with CUDA events; the 50 MB L2 cache
    is flushed before every launch."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, reps: int = 25) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work (the
    device runs behind): what a call costs a host-bound decode step."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    tol = TOL[want.dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol,
                               msg=lambda m: f"{name}: {m}")
    err = (got.float() - want.float()).abs().max().item()
    log(f"  ok {name}: max|err| {err:.3g} (rtol=atol={tol['rtol']})")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def check_flash(dev, timer):
    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_plain)
    rng = np.random.default_rng(0)

    def case(b, h, kvh, sq, sk, dh, dtype, causal, q_offset, kv_valid,
             bshd=False):
        def rnd(n, s):              # BSHD transposed to BHSD, as the model
            if bshd:
                return torch.from_numpy(rng.standard_normal(
                    (b, s, n, dh), np.float32)).to(dev, dtype).transpose(1, 2)
            return torch.from_numpy(rng.standard_normal(
                (b, n, s, dh), np.float32)).to(dev, dtype)

        q, k, v = rnd(h, sq), rnd(kvh, sk), rnd(kvh, sk)
        kvv = torch.tensor(kv_valid, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, q_offset=q_offset, kv_valid=kvv)
        got = flash_attention_bhsd(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        name = (f"flash b{b} h{h}/{kvh} sq{sq} sk{sk} dh{dh} "
                f"{str(dtype)[6:]} causal={causal} q_offset={q_offset} "
                f"kv_valid={kv_valid}{' bshd views' if bshd else ''}")
        for i, n in enumerate(kv_valid):
            if n == 0 and got[i].any():
                fail(f"{name}: row {i} has no live key but is not 0")
        return close(name, got, want), (q, k, v, kw)

    # edge cases, in fp32 (CUDA cores) and bf16 (tensor cores): ragged
    # kv_valid including 0, S not a multiple of 64, causal and not,
    # q_offset > 0 with Sq < Sk, every head dim, many kv tiles through the
    # two-stage ring
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            case(3, 4, 2, 100, 100, 64, dtype, causal, 0, [100, 0, 37])
        case(3, 4, 2, 45, 130, 64, dtype, True, 85, [130, 90, 120])
        case(2, 4, 2, 70, 70, 16, dtype, True, 0, [70, 0])
        case(2, 6, 2, 70, 70, 32, dtype, True, 0, [70, 5])
        case(2, 4, 1, 33, 33, 128, dtype, False, 0, [33, 20])
    case(1, 4, 2, 1000, 1000, 64, torch.bfloat16, True, 0, [1000])
    case(2, 2, 1, 200, 1500, 128, torch.bfloat16, False, 0, [1500, 1399])
    # the main paths' prefill shapes: qwen2-0.5b (14 q heads over 2 kv
    # heads) and zamba2-1.2b's shared block (32 heads, G = 1), as the
    # model passes them (BSHD views)
    s = max(PROMPT_LENS)
    case(8, 14, 2, s, s, 64, torch.bfloat16, True, 0, PROMPT_LENS, bshd=True)
    case(ZAMBA_PROMPTS, 32, 32, ZAMBA_PROMPT_LEN, ZAMBA_PROMPT_LEN, 64,
         torch.bfloat16, True, 0, [ZAMBA_PROMPT_LEN] * ZAMBA_PROMPTS,
         bshd=True)
    case(8, 14, 2, s, s, 64, torch.float32, True, 0, PROMPT_LENS)
    err, (q, k, v, kw) = case(8, 14, 2, s, s, 64, torch.bfloat16, True, 0,
                              PROMPT_LENS)

    ms = timer.ms(lambda: flash_attention_bhsd(q, k, v, **kw))
    plain_ms = timer.ms(lambda: flash_attention_plain(q, k, v, **kw))
    g = q.shape[1] // k.shape[1]
    ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    kpos = torch.arange(s, device=dev)
    kvv = kw["kv_valid"]
    mask = ((kpos[None, :] <= kpos[:, None])[None, None]
            & (kpos[None, None, None, :] < kvv[:, None, None, None]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = timer.ms(lambda: sdpa(q, ke, ve, attn_mask=mask))
    # the yardstick above takes SDPA off its flash backend (a boolean
    # mask); beside it, SDPA's flash backend on full-length causal rows
    from torch.nn.attention import SDPBackend, sdpa_kernel
    full = dict(causal=True, kv_valid=torch.full_like(kvv, s))
    full_ms = timer.ms(lambda: flash_attention_bhsd(q, k, v, **full))
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            t = timer.ms(lambda: sdpa(q, ke, ve, is_causal=True))
        sdpa_flash_ms = f"{t:.4f} ms"
    except RuntimeError as e:       # a yardstick only: say why it is missing
        sdpa_flash_ms = f"not available ({str(e).splitlines()[0]})"
    log(f"  flash bf16 [8,14,512,64] full-length causal rows: kernel "
        f"{full_ms:.4f} ms, SDPA flash backend (is_causal) {sdpa_flash_ms}")
    log(f"  flash host us a call: wrapper "
        f"{host_us(lambda: flash_attention_bhsd(q, k, v, **kw)):.2f}, SDPA "
        f"with the mask {host_us(lambda: sdpa(q, ke, ve, attn_mask=mask)):.2f}")
    b, h, sq, dh = q.shape
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * b
    pairs = sum(min(i + 1, L) for L in PROMPT_LENS for i in range(sq))
    bms, by = bound_ms(nbytes, 4.0 * dh * h * pairs)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:46",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


def plan_table(lens, extra, ps, rng=None, width=None):
    """Row-major page table as Engine._page_plan lays it out (optionally
    with shuffled physical ids and garbage past the live pages, and
    widened to ``width`` pages a row, as the scheduler's pool tables)."""
    per_row = [-(-(n + extra) // ps) for n in lens]
    width = max(max(per_row), width or 0)
    num_pages = -(-(1 + sum(per_row)) // 16) * 16
    table = np.zeros((len(lens), width), np.int32)
    ids = np.arange(1, 1 + sum(per_row))
    if rng is not None:
        ids = rng.permutation(ids)
    nxt = 0
    for i, npg in enumerate(per_row):
        table[i, :npg] = ids[nxt:nxt + npg]
        nxt += npg
        if rng is not None:          # dead entries: in-range garbage
            table[i, npg:] = rng.integers(0, num_pages, width - npg)
    return table, num_pages


def check_paged(dev, timer):
    from repro_torch.kernels.paged_decode import (
        paged_decode_attention_grouped, paged_decode_plain, split_plan)
    rng = np.random.default_rng(1)

    def case(lens, kvh, g, dh, ps, dtype, extra, shuffle, width=None,
             page_dtype=None):
        b = len(lens)
        table, num_pages = plan_table(lens, extra, ps,
                                      rng if shuffle else None, width)

        def rnd(*shape, dt=dtype):
            return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                    ).to(dev, dt)

        pdt = page_dtype or dtype
        args = (rnd(b, kvh, g, dh), rnd(num_pages, ps, kvh, dh, dt=pdt),
                rnd(num_pages, ps, kvh, dh, dt=pdt),
                torch.from_numpy(table).to(dev),
                torch.tensor(lens, dtype=torch.int32, device=dev),
                rnd(b, kvh, dh), rnd(b, kvh, dh))
        got = paged_decode_attention_grouped(*args)
        want = paged_decode_plain(*args)
        torch.cuda.synchronize()
        np_w = table.shape[1]
        name = (f"paged lens={lens} kvh{kvh} g{g} dh{dh} ps{ps} "
                f"{str(dtype)[6:]} pages {str(pdt)[6:]} shuffled={shuffle} "
                f"NP={np_w} split={split_plan(b, kvh, np_w)}")
        err = close(name, got, want)
        for i, n in enumerate(lens):  # an empty row outputs exactly v_new
            if n == 0 and not torch.equal(
                    got[i], args[6][i][:, None, :].expand_as(got[i])):
                fail(f"{name}: row {i} has no past token but is not v_new")
        return err, args

    # length 0, 1, a partial page and multi-page lengths; shuffled
    # (non-contiguous) tables with garbage past the live pages
    case([0, 1, 10, 40], 2, 7, 64, 16, torch.float32, 4, True)
    case([0, 1, 5, 33, 64], 2, 4, 32, 8, torch.float32, 3, True)
    case([3, 17], 1, 7, 128, 16, torch.float32, 2, True)
    case([9, 0, 30], 2, 7, 16, 16, torch.bfloat16, 5, True)
    # the cluster split: a row of 38 pages (past 8 CTAs x 4 ring slots)
    # beside rows shorter than the cluster, a row of 0 pages and a
    # partial one; G = 32 at Dh 128 (fp32 pages take the shared-memory
    # opt-in); pages of 8 and 32 tokens; the scheduler's table width (64
    # pages a row) far past the live pages; fp32, bf16 and fp32 pages
    # under a bf16 query
    for dtype, pdt in ((torch.float32, None), (torch.bfloat16, None),
                       (torch.bfloat16, torch.float32)):
        case([600, 0, 5, 20, 47], 2, 7, 64, 16, dtype, 3, True, None, pdt)
        case([300, 1, 0, 65], 1, 32, 128, 16, dtype, 2, True, None, pdt)
        case([250, 7, 0, 40], 2, 7, 64, 8, dtype, 1, True, None, pdt)
        case([900, 33, 0, 64], 2, 4, 32, 32, dtype, 5, True, None, pdt)
        case([500, 16, 0, 3], 2, 7, 64, 16, dtype, 0, False, 64, pdt)
    # the main path's decode shape, mid-generation (16 tokens decoded)
    main_lens = [n + 16 for n in PROMPT_LENS]
    case(main_lens, 2, 7, 64, PAGE_SIZE, torch.float32, MAX_NEW - 16, False)
    err, args = case(main_lens, 2, 7, 64, PAGE_SIZE, torch.bfloat16,
                     MAX_NEW - 16, False)
    # kv_dtype="fp32" on a bf16 model: fp32 pages under a bf16 query
    q4, kp, vp, pt, ln, kn, vn = args
    mixed = (q4, kp.float(), vp.float(), pt, ln, kn, vn)
    got = paged_decode_attention_grouped(*mixed)
    want = paged_decode_plain(*mixed)
    torch.cuda.synchronize()
    close(f"paged lens={main_lens} fp32 pages under bf16 q", got, want)
    mixed_ms = timer.ms(lambda: paged_decode_attention_grouped(*mixed))
    mixed_plain_ms = timer.ms(lambda: paged_decode_plain(*mixed))
    log(f"  paged_decode fp32 pages / bf16 q: {mixed_ms:.4f} ms "
        f"(plain {mixed_plain_ms:.4f})")

    ms = timer.ms(lambda: paged_decode_attention_grouped(*args))
    plain_ms = timer.ms(lambda: paged_decode_plain(*args))
    log(f"  paged_decode host us a call: wrapper "
        f"{host_us(lambda: paged_decode_attention_grouped(*args)):.2f} "
        f"(kernel timer {ms:.4f} ms, split "
        f"{split_plan(len(main_lens), 2, args[3].shape[1])} CTAs a row)")
    q4, _, _, _, _, kn, _ = args
    b, kvh, g, dh = q4.shape
    live_pages = sum(-(-n // PAGE_SIZE) for n in main_lens)
    nbytes = (2 * (2 * q4.numel() + 2 * kn.numel())       # q, out, k/v_new
              + 2 * 2 * sum(main_lens) * kvh * dh          # live K and V
              + 4 * b + 4 * live_pages)                    # lengths, table
    flops = 4.0 * kvh * g * dh * sum(n + 1 for n in main_lens)
    bms, by = bound_ms(nbytes, flops)
    return dict(name="paged_decode", route="cuda",
                source="src/repro_torch/csrc/paged_decode.cu",
                replaces="src/repro/kernels/paged_decode.py:51",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def check_paged_q8(dev, timer):
    from repro_torch.kernels.paged_decode import (
        paged_decode_attention_q8_grouped, paged_decode_q8_plain, split_plan)
    rng = np.random.default_rng(4)

    def case(lens, kvh, g, dh, ps, dtype, extra, shuffle, width=None):
        b = len(lens)
        table, num_pages = plan_table(lens, extra, ps,
                                      rng if shuffle else None, width)

        def rnd(*shape):
            return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                    ).to(dev, dtype)

        def codes():
            return torch.from_numpy(rng.integers(
                -127, 128, (num_pages, ps, kvh, dh)).astype(np.int8)).to(dev)

        def scales():
            return torch.from_numpy(rng.uniform(
                0.005, 0.05, (num_pages, ps)).astype(np.float32)).to(dev)

        args = (rnd(b, kvh, g, dh), codes(), codes(), scales(), scales(),
                torch.from_numpy(table).to(dev),
                torch.tensor(lens, dtype=torch.int32, device=dev),
                rnd(b, kvh, dh), rnd(b, kvh, dh))
        got = paged_decode_attention_q8_grouped(*args)
        want = paged_decode_q8_plain(*args)
        torch.cuda.synchronize()
        split = split_plan(b, kvh, table.shape[1])
        name = (f"paged q8 lens={lens} kvh{kvh} g{g} dh{dh} ps{ps} "
                f"{str(dtype)[6:]} shuffled={shuffle} NP={table.shape[1]} "
                f"split={split}")
        err = close(name, got, want)
        for i, n in enumerate(lens):  # an empty row outputs exactly v_new
            if n == 0 and not torch.equal(
                    got[i], args[8][i][:, None, :].expand_as(got[i])):
                fail(f"{name}: row {i} has no past token but is not v_new")
        return err, args

    # length 0, 1, a partial page and multi-page lengths; shuffled tables
    # with garbage past the live pages; every supported head dim
    case([0, 1, 10, 40], 2, 7, 64, 16, torch.float32, 4, True)
    case([0, 1, 5, 33, 64], 2, 4, 32, 8, torch.float32, 3, True)
    case([3, 17], 1, 7, 128, 16, torch.float32, 2, True)
    case([9, 0, 30], 2, 7, 16, 16, torch.bfloat16, 5, True)
    # the cluster split: a row of 38 pages (past 8 CTAs x 4 ring slots)
    # beside rows shorter than the cluster, a row of 0 pages and a
    # partial one; G = 32 at Dh 128; pages of 8 and 32 tokens; the
    # scheduler's table width (64 pages a row) far past the live pages
    for dtype in (torch.float32, torch.bfloat16):
        case([600, 0, 5, 20, 47], 2, 7, 64, 16, dtype, 3, True)
        case([300, 1, 0, 65], 1, 32, 128, 16, dtype, 2, True)
        case([250, 7, 0, 40], 2, 7, 64, 8, dtype, 1, True)
        case([900, 33, 0, 64], 2, 4, 32, 32, dtype, 5, True)
        case([500, 16, 0, 3], 2, 7, 64, 16, dtype, 0, False, width=64)
    # the scheduler's decode shape: 8 slots, lengths prompt+16
    main_lens = [n + 16 for n in PROMPT_LENS]
    case(main_lens, 2, 7, 64, PAGE_SIZE, torch.float32, MAX_NEW - 16, False)
    case(main_lens, 2, 7, 64, PAGE_SIZE, torch.bfloat16, MAX_NEW - 16,
         False, width=64)
    err, args = case(main_lens, 2, 7, 64, PAGE_SIZE, torch.bfloat16,
                     MAX_NEW - 16, False)

    ms = timer.ms(lambda: paged_decode_attention_q8_grouped(*args))
    plain_ms = timer.ms(lambda: paged_decode_q8_plain(*args))
    log(f"  paged_decode_q8 host us a call: wrapper "
        f"{host_us(lambda: paged_decode_attention_q8_grouped(*args)):.2f} "
        f"(kernel timer {ms:.4f} ms, split "
        f"{split_plan(len(main_lens), 2, args[5].shape[1])} CTAs a row)")
    q4, _, _, _, _, _, _, kn, _ = args
    b, kvh, g, dh = q4.shape
    live_pages = sum(-(-n // PAGE_SIZE) for n in main_lens)
    # int8 K and V codes of every live token plus its two f32 scales (one
    # per token row, shared by the KV heads): 264 B per token at Dh 64
    nbytes = (2 * (2 * q4.numel() + 2 * kn.numel())       # q, out, k/v_new
              + sum(main_lens) * (2 * kvh * dh + 2 * 4)    # codes + scales
              + 4 * b + 4 * live_pages)                    # lengths, table
    flops = 4.0 * kvh * g * dh * sum(n + 1 for n in main_lens)
    bms, by = bound_ms(nbytes, flops)
    return dict(name="paged_decode_q8", route="cuda",
                source="src/repro_torch/csrc/paged_decode_q8.cu",
                replaces="src/repro/kernels/paged_decode.py:191",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def check_argmax(dev, timer, vocab):
    from repro_torch.kernels.sampling import (argmax_boundary_logits,
                                              argmax_plain, argmax_plan,
                                              block_argmax)
    rng = np.random.default_rng(2)

    def exact(name, xt):
        got = block_argmax(xt)
        want = argmax_plain(xt)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"argmax {name}: kernel {got.tolist()} != plain "
                 f"{want.tolist()}")
        shown = got.tolist() if got.numel() <= 8 else f"{got.numel()} rows"
        log(f"  ok argmax {name} {tuple(xt.shape)} plan "
            f"{argmax_plan(*xt.shape)}: exact, {shown}")

    x = rng.standard_normal((8, vocab), np.float32)
    x[0, [5, 100000]] = 50.0                  # tie: the lower index wins
    x[1, :] = -np.inf                         # all -inf -> index 0
    x[2, [vocab - 2, vocab - 1]] = 60.0       # tie at the row's end
    x[3, :] = -np.inf
    x[3, 77777] = -1.0
    x[4, [0, 1]] = 70.0                       # tie at the row's start
    x[5, ::2] = 3.5                           # many ties: index 0
    x[6, 1::7] = 9.0                          # strided ties: index 1
    last = None
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dev, dtype)
        exact(f"{str(dtype)[6:]} main", xt)
        # ties and NaN at the split boundaries; a view whose rows start one
        # element past a 16-byte boundary (and drift: the row stride is
        # odd); zamba2's vocab; one row and 64 rows
        for b, v in ((8, vocab), (8, 32000), (1, vocab), (64, vocab),
                     (64, 32000), (3, 130)):
            xb = torch.from_numpy(argmax_boundary_logits(rng, b, v)
                                  ).to(dev, dtype)
            exact(f"{str(dtype)[6:]} split boundaries", xb)
            wide = torch.from_numpy(argmax_boundary_logits(rng, b, v + 1)
                                    ).to(dev, dtype)
            exact(f"{str(dtype)[6:]} view from column 1", wide[:, 1:])
        for shift in range(1, 5):           # B = 1 through every row kind
            xb = argmax_boundary_logits(rng, 5, vocab)[shift:shift + 1]
            exact(f"{str(dtype)[6:]} one row, kind {shift}",
                  torch.from_numpy(xb).to(dev, dtype))
        last = xt
    ms = timer.ms(lambda: block_argmax(last))
    plain_ms = timer.ms(lambda: argmax_plain(last))
    library_ms = timer.ms(lambda: torch.argmax(last, dim=-1))
    log(f"  argmax host us a call: wrapper "
        f"{host_us(lambda: block_argmax(last)):.2f}, torch.argmax "
        f"{host_us(lambda: torch.argmax(last, dim=-1)):.2f}")
    bms, by = bound_ms(2 * last.numel() + 4 * last.shape[0],
                       float(last.numel()))
    return dict(name="argmax", route="cuda",
                source="src/repro_torch/csrc/argmax.cu",
                replaces="src/repro/kernels/sampling.py:116",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


ZAMBA_PROMPTS = 8                  # zamba2 generate: 8 prompts x 512 tokens
ZAMBA_PROMPT_LEN = 512
# a reordered scan; in fp32 the atol is relative to the output's largest
# magnitude: every fp32 evaluation rounds the decays exp(Bc_t - Bc_j) with
# a relative error of ~|Bc| eps (|Bc| reaches ~180 over a 256-step chunk),
# so an element that cancels to near 0 keeps an error on the scale of its
# terms, not of itself
SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5),
           torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


def ssd_tol(want: torch.Tensor) -> dict:
    tol = dict(SSD_TOL[want.dtype])
    if want.dtype == torch.float32:
        tol["atol"] *= max(1.0, want.abs().max().item())
    return tol


def ssd_inputs(rng, dev, b, s, h, dk, dv, dtype, *, positive=False,
               lf_value=None, broadcast=False, state=False):
    """Model-layout ssd_scan inputs.  Scores q.k have unit variance; with
    ``positive`` q, k >= 0 keep the normalizer q.n away from 0, where fp32
    cancellation alone would exceed the tolerance.  ``broadcast`` gives q, k
    as views over one head (stride 0), as Mamba2 passes them."""
    def qk():
        x = rng.standard_normal((b, s, 1 if broadcast else h, dk),
                                np.float32) * dk ** -0.25
        t = torch.from_numpy(np.abs(x) if positive else x).to(dev, dtype)
        return t.expand(b, s, h, dk) if broadcast else t

    q, k = qk(), qk()
    v = torch.from_numpy(rng.standard_normal((b, s, h, dv), np.float32)
                         ).to(dev, dtype)
    lf = (np.full((b, s, h), lf_value, np.float32) if lf_value is not None
          else -np.logaddexp(rng.standard_normal((b, s, h)), 0.0))
    li = -np.logaddexp(rng.standard_normal((b, s, h)), 0.0)
    gates = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
             for a in (lf, li)]
    st = None
    if state:
        st = (torch.from_numpy(rng.standard_normal((b, h, dk, dv),
                                                   np.float32)).to(dev),
              torch.from_numpy(np.abs(rng.standard_normal(
                  (b, h, dk), np.float32))).to(dev))
    return (q, k, v, *gates), st


#: the bf16 route's three passes and the fp32 route's kernel, by the names
#: of their ``__global__`` functions
SSD_PASSES = ("ssd_local_states_kernel", "ssd_state_pass_kernel",
              "ssd_outputs_kernel")
SSD_FP32 = "ssd_scan_kernel"


def check_ssd(dev, timer):
    """Kernel #5 against its plain version: the main path's call (zamba2
    generate: 8 x 512 tokens, 64 heads of P = N = 64, q/k broadcast over
    heads, a carried state), the scheduler's one-row admissions (B = 1 at
    S = 64, 300, 512), the flat [512, 512, 64] layout, edge cases and
    mLSTM's dk = dv = 512 state; which ``__global__`` functions each dtype
    runs (bf16: the three tensor-core passes, fp32: the CUDA-core kernel)."""
    from repro_torch.bench.profile_kernels import device_us_by_kernel
    from repro_torch.kernels.ssd_scan import ssd_flops, ssd_scan
    from repro_torch.models.linear_scan import _chunked_linear_attention
    rng = np.random.default_rng(8)

    def plain(args, chunk, normalize, st):
        return _chunked_linear_attention(*args, chunk_size=chunk,
                                         normalize=normalize,
                                         initial_state=st)

    def case(name, shape, dtype, chunk, normalize=False, **kw):
        args, st = ssd_inputs(rng, dev, *shape, dtype, **kw)
        y, (c, n) = ssd_scan(*args, chunk=chunk, normalize=normalize,
                             initial_state=st)
        yp, (cp, np_) = plain(args, chunk, normalize, st)
        torch.cuda.synchronize()
        errs = []
        for what, got, want in (("y", y, yp), ("C", c, cp), ("n", n, np_)):
            tol = ssd_tol(want)
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=lambda m: f"{name} {what}: {m}")
            errs.append((got.float() - want.float()).abs().max().item())
        scaled = " x max|.|" if dtype == torch.float32 else ""
        log(f"  ok ssd_scan {name} {tuple(shape)} {str(dtype)[6:]} chunk "
            f"{chunk} normalize={normalize}: max|err| y {errs[0]:.3g} "
            f"(max|y| {yp.abs().max().item():.3g}), C {errs[1]:.3g}, n "
            f"{errs[2]:.3g} (rtol {SSD_TOL[dtype]['rtol']}, atol "
            f"{SSD_TOL[dtype]['atol']}{scaled})")
        return errs[0], args, st

    case("ragged S", (3, 37, 2, 64, 64), torch.float32, 16)
    case("S < chunk, odd dims", (2, 45, 3, 16, 32), torch.float32, 64,
         state=True)
    case("dv in 2 tiles", (1, 130, 2, 32, 96), torch.float32, 64)
    case("normalize", (2, 300, 2, 64, 64), torch.float32, 128, True,
         positive=True)
    case("initial state", (2, 300, 4, 64, 64), torch.float32, 256,
         state=True, broadcast=True)
    case("log_f = -30", (2, 300, 2, 64, 64), torch.float32, 256,
         lf_value=-30.0, state=True)
    case("mLSTM dk=dv=512", (1, 512, 4, 512, 512), torch.float32, 256, True,
         positive=True)
    case("mLSTM dk=dv=512", (1, 512, 4, 512, 512), torch.bfloat16, 256,
         True, positive=True)
    # the bf16 route's edges: ragged S over key and row tiles, dk and dv
    # padded to 64 (dv over two tiles), 4-byte copies (rows of 40 bytes),
    # normalize, a carried state
    case("ragged S", (3, 37, 2, 64, 64), torch.bfloat16, 16)
    case("S < chunk, dv in 2 tiles", (2, 45, 3, 16, 96), torch.bfloat16, 64,
         state=True)
    case("4-byte rows", (2, 200, 3, 20, 36), torch.bfloat16, 128, True,
         positive=True, state=True)
    case("chunk 1024", (1, 1100, 2, 64, 64), torch.bfloat16, 1024,
         state=True, broadcast=True)
    # the flat layout of the Pallas entry, [BH,S,d] as [BH,S,1,d], at the
    # generate shape
    args, _ = ssd_inputs(rng, dev, 512, 512, 1, 64, 64, torch.bfloat16)
    y, _ = ssd_scan(*args, chunk=256)
    yp, _ = plain(args, 256, False, None)
    torch.cuda.synchronize()
    close("ssd_scan flat [512,512,64] bf16 chunk 256", y, yp)
    flat_ms = timer.ms(lambda: ssd_scan(*args, chunk=256))
    # the scheduler's one-row admissions (zamba2, B = 1, a carried state)
    for s in (64, 300, 512):
        _, a1, st1 = case(f"admission S={s}", (1, s, 64, 64, 64),
                          torch.bfloat16, 256, state=True, broadcast=True)
        adm_ms = timer.ms(lambda: ssd_scan(*a1, chunk=256,
                                           initial_state=st1))
        log(f"  ssd_scan admission B=1 S={s} bf16: {adm_ms:.4f} ms")
    # the main path's call, in bf16 and in fp32
    shape = (ZAMBA_PROMPTS, ZAMBA_PROMPT_LEN, 64, 64, 64)
    _, a32, st32 = case("zamba2 generate", shape, torch.float32, 256,
                        state=True, broadcast=True)
    err, args, st = case("zamba2 generate", shape, torch.bfloat16, 256,
                         state=True, broadcast=True)
    ms = timer.ms(lambda: ssd_scan(*args, chunk=256, initial_state=st))
    plain_ms = timer.ms(lambda: plain(args, 256, False, st))
    # each dtype reaches its own route, and only it
    names = SSD_PASSES + (SSD_FP32,)
    split = device_us_by_kernel(
        lambda: ssd_scan(*args, chunk=256, initial_state=st), names)
    if set(split) != set(SSD_PASSES):
        fail(f"a bf16 ssd_scan call ran {sorted(split)}, not the tensor-core "
             f"passes {list(SSD_PASSES)}")
    f32 = device_us_by_kernel(
        lambda: ssd_scan(*a32, chunk=256, initial_state=st32), names)
    if set(f32) != {SSD_FP32}:
        fail(f"an fp32 ssd_scan call ran {sorted(f32)}, not {SSD_FP32}")
    log(f"  ok ssd_scan routes: bf16 runs {list(SSD_PASSES)}, fp32 runs "
        f"{SSD_FP32} ({f32[SSD_FP32]:.1f} us a call)")
    del a32, st32
    b, s, h, dk = args[0].shape
    dv = args[2].shape[3]

    def distinct(t):
        n = t.element_size()
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        return n

    state_bytes = 4 * (b * h * dk * dv + b * h * dk)
    nbytes = (sum(distinct(t) for t in args) + state_bytes      # in
              + distinct(args[2]) + state_bytes)                 # y, C, n
    flops = float(ssd_flops(b, h, s, dk, dv, 256))
    bms, by = bound_ms(nbytes, flops)
    log(f"  ssd_scan main call: {ms:.4f} ms, {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB; bound {bms:.4f} ms by {by} (989 TFLOP/s "
        f"tensor-core peak); fp32 CUDA cores at peak "
        f"{flops / F32_FLOPS * 1e3:.4f} ms; flat [512,512,64] bf16 "
        f"{flat_ms:.4f} ms; device us a call by pass: "
        + ", ".join(f"{n} {split[n]:.1f}" for n in SSD_PASSES))
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:35",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------

def counters():
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.paged_decode import (
        paged_decode_attention_grouped, paged_decode_attention_q8_grouped)
    from repro_torch.kernels.sampling import block_argmax
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"flash_attention": flash_attention_bhsd,
            "paged_decode": paged_decode_attention_grouped,
            "paged_decode_q8": paged_decode_attention_q8_grouped,
            "argmax": block_argmax, "ssd_scan": ssd_scan}


def reset_counters():
    for f in counters().values():
        f.launches = 0


def read_counters():
    return {k: f.launches for k, f in counters().items()}


def main_path(dev):
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    t0 = time.perf_counter()
    lm = LM(CONFIG, torch.bfloat16, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"  qwen2-0.5b: {n_params} params, bf16, random init (seed 0) in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CONFIG.vocab, n).tolist() for n in PROMPT_LENS]
    eng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024))
    eng.generate(prompts, max_new_tokens=MAX_NEW)          # warm-up
    torch.cuda.synchronize()

    reset_counters()
    syncs0 = eng.host_syncs
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = read_counters()
    syncs = eng.host_syncs - syncs0

    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=1)                # prefill + 1 token
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0

    if syncs != 1:
        fail(f"generate made {syncs} host syncs, expected 1")
    if [len(o) for o in out] != [MAX_NEW] * len(prompts):
        fail(f"unexpected output lengths {[len(o) for o in out]}")
    if not all(0 <= t < CONFIG.vocab for o in out for t in o):
        fail("a generated token is outside the vocabulary")
    n_layers = CONFIG.n_layers
    want = {"flash_attention": n_layers,
            "paged_decode": n_layers * (MAX_NEW - 1), "argmax": MAX_NEW,
            "ssd_scan": 0}
    for k, n in want.items():
        if launches[k] < n:
            fail(f"{k} launched {launches[k]} times on the main path, "
                 f"expected at least {n}")
    dec_tok_s = len(prompts) * (MAX_NEW - 1) / max(t_gen - t_prefill, 1e-9)
    log(f"  generate: {t_gen * 1e3:.2f} ms for {len(prompts)} x {MAX_NEW} "
        f"tokens; prefill (+1 token) {t_prefill * 1e3:.2f} ms; decode "
        f"{dec_tok_s:.1f} tokens/s; host_syncs {syncs}; launches {launches}")
    log(f"  first tokens: {[o[:4] for o in out]}")
    return lm, launches


def scheduler_path(dev, lm):
    """The slice-2 main path: BatchScheduler over int8 pages at full
    width, with the prefix cache (the workload of
    ``repro_torch.bench.profile_serve``)."""
    from repro_torch.bench import profile_serve as ps
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = lm.cfg
    eng = Engine(lm, ServeConfig(page_size=ps.PAGE_SIZE, max_seq=1024,
                                 batch_slots=ps.SLOTS, admission_chunk=8,
                                 kv_dtype="int8"), device=lm.device)
    # warm-up: the same shapes' first launches, cuBLAS handles, allocator
    ps.run_scheduler(eng, ps.shared_prefix_workload(
        cfg.vocab, ps.SLOTS, ps.PREFIX, ps.SUFFIX_LENS, ps.BUDGETS, seed=1))
    torch.cuda.synchronize()
    work = ps.shared_prefix_workload(cfg.vocab, ps.REQUESTS, ps.PREFIX,
                                     ps.SUFFIX_LENS, ps.BUDGETS, seed=0)
    reset_counters()
    syncs0 = eng.host_syncs
    t0 = time.perf_counter()
    sched, out = ps.run_scheduler(eng, work)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    syncs = eng.host_syncs - syncs0
    m = sched.metrics

    if sorted(out) != list(range(len(work))):
        fail(f"scheduler completed {sorted(out)} of {len(work)} requests")
    for rid, (_, budget, _) in enumerate(work):
        if len(out[rid]) != budget:
            fail(f"request {rid}: {len(out[rid])} tokens, budget {budget}")
        if not all(0 <= t < cfg.vocab for t in out[rid]):
            fail(f"request {rid}: a token is outside the vocabulary")
    if syncs != m["segments"]:
        fail(f"scheduler made {syncs} host syncs for {m['segments']} "
             f"segments")
    sched.check()
    sched.pool.check()
    if not sched.pool.allocs == sched.pool.releases > 0:
        fail(f"pool leaked: {sched.pool!r}")
    if m["prefix_hits"] < ps.REQUESTS - 1:
        fail(f"prefix hits {m['prefix_hits']} < {ps.REQUESTS - 1}")
    n_layers = cfg.n_layers
    misses = m["admissions"] - m["prefix_hits"]
    want = {"paged_decode_q8": n_layers * m["decode_steps"],
            "flash_attention": n_layers * misses,
            "argmax": m["decode_steps"], "paged_decode": 0, "ssd_scan": 0}
    for k, n in want.items():
        if launches[k] != n:
            fail(f"{k} launched {launches[k]} times on the scheduler path, "
                 f"expected {n}")
    new_tokens = sum(len(t) for t in out.values())
    ttfts = [r.ttft for r in sched.completed.values()]
    log(f"  scheduler: {len(out)} requests, {new_tokens} tokens in "
        f"{wall * 1e3:.2f} ms = {new_tokens / wall:.1f} tokens/s; mean TTFT "
        f"{np.mean(ttfts) * 1e3:.2f} ms; segments {m['segments']:.0f}; "
        f"decode steps {m['decode_steps']:.0f}; host_syncs {syncs}; "
        f"admissions {m['admissions']:.0f}, prefix hits "
        f"{m['prefix_hits']:.0f}, prefilled {m['prefilled_tokens']:.0f} of "
        f"{m['prompt_tokens']:.0f} prompt tokens; launches {launches}")
    log(f"  first tokens: {[out[r][:4] for r in range(4)]}")
    return launches


def token_check(dev):
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    lm_cpu = LM(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(1))
    # a random model with sigma-1 tied embeddings mostly echoes its input;
    # shrinking the table makes the greedy tokens depend on every layer
    lm_cpu.embed.table.data.mul_(0.1)
    lm_gpu = LM(cfg, torch.float32, dev)
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (37, 20, 5)]
    sc_paged = ServeConfig(page_size=PAGE_SIZE, max_seq=128)
    tok = {
        "card paged": Engine(lm_gpu, sc_paged).generate(prompts, 8),
        "card dense": Engine(lm_gpu, ServeConfig(max_seq=128)).generate(
            prompts, 8),
        "cpu paged": Engine(lm_cpu, sc_paged, device="cpu").generate(
            prompts, 8),
    }
    for k, v in tok.items():
        log(f"  {k}: {v}")
    if not tok["card paged"] == tok["card dense"] == tok["cpu paged"]:
        fail("greedy tokens differ between the card and the CPU")

    logits = {}
    for name, lm in (("cpu", lm_cpu), ("card", lm_gpu)):
        eng = Engine(lm, sc_paged, device=lm.device)
        toks, lens = eng._pad_prompts(prompts)
        table, num_pages = eng._page_plan(prompts, 8)
        state = lm.init_decode_state(len(prompts), 128, page_size=PAGE_SIZE,
                                     num_pages=num_pages,
                                     table_width=table.shape[1])
        state["caches"].page_table.copy_(torch.from_numpy(table))
        with torch.inference_mode():
            lg, _ = lm.prefill({"tokens": torch.from_numpy(toks).to(lm.device),
                                "lengths": torch.from_numpy(lens).to(
                                    lm.device)}, state)
        logits[name] = lg.float().cpu()
    rel = ((logits["card"] - logits["cpu"]).abs().max()
           / logits["cpu"].abs().max()).item()
    log(f"  prefill logits card vs cpu: max|d|/max|logit| = {rel:.3g}")
    if not rel <= 1e-4:
        fail(f"prefill logits differ: {rel} > 1e-4")


def sched_token_check(dev):
    """fp32, 2 layers: the card's scheduler against the card's generate and
    the CPU scheduler; int8 decode-step logits card against CPU."""
    from repro_torch.bench.profile_serve import (run_scheduler,
                                                 shared_prefix_workload)
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    lm_cpu = LM(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(2))
    lm_cpu.embed.table.data.mul_(0.1)
    lm_gpu = LM(cfg, torch.float32, dev)
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    # a 40-token shared prefix: two full pages of 16 and a fork inside the
    # third, so admissions map pages read-only AND copy the fork page
    work = shared_prefix_workload(cfg.vocab, 6, 40, [3, 9, 17, 30],
                                  [3, 5, 8], seed=5)
    sc = ServeConfig(page_size=PAGE_SIZE, max_seq=128, batch_slots=3,
                     admission_chunk=4)
    sched, card = run_scheduler(Engine(lm_gpu, sc, device=dev), work)
    _, cpu = run_scheduler(Engine(lm_cpu, sc, device="cpu"), work)
    gen = Engine(lm_gpu, sc, device=dev).generate([w[0] for w in work],
                                      max(w[1] for w in work))
    gen = {rid: gen[rid][:w[1]] for rid, w in enumerate(work)}
    m = sched.metrics
    log(f"  card scheduler: {card}")
    log(f"  prefix hits {m['prefix_hits']:.0f}, pages shared "
        f"{m['pages_shared']:.0f}, cow copies {m['cow_copies']:.0f}")
    if not card == gen == cpu:
        fail(f"greedy tokens differ: card scheduler {card}, card generate "
             f"{gen}, cpu scheduler {cpu}")
    if m["cow_copies"] < 1 or m["prefix_hits"] < 1:
        fail("the fp32 scheduler phase did not exercise the prefix cache")

    logits = {}
    prompts = [w[0] for w in work[:3]]
    sc8 = ServeConfig(page_size=PAGE_SIZE, max_seq=128, kv_dtype="int8")
    for name, lm in (("cpu", lm_cpu), ("card", lm_gpu)):
        eng = Engine(lm, sc8, device=lm.device)
        toks, lens = eng._pad_prompts(prompts)
        table, num_pages = eng._page_plan(prompts, 4)
        state = lm.init_decode_state(len(prompts), 128, page_size=PAGE_SIZE,
                                     num_pages=num_pages,
                                     table_width=table.shape[1],
                                     kv_dtype=torch.int8)
        state = eng.set_page_table(state, table)
        nxt = torch.tensor([[7], [11], [13]], dtype=torch.int32,
                           device=lm.device)
        with torch.inference_mode():
            lm.prefill({"tokens": torch.from_numpy(toks).to(lm.device),
                        "lengths": torch.from_numpy(lens).to(lm.device)},
                       state)
            out = []
            for _ in range(3):
                lg, state = lm.decode_step(nxt, state)
                out.append(lg.float().cpu())
        logits[name] = torch.stack(out)
    rel = ((logits["card"] - logits["cpu"]).abs().max()
           / logits["cpu"].abs().max()).item()
    log(f"  int8 decode-step logits card vs cpu: max|d|/max|logit| = "
        f"{rel:.3g}")
    if not rel <= 1e-2:
        fail(f"int8 decode logits differ: {rel} > 1e-2")


# ---------------------------------------------------------------------------
# phases 8-10: zamba2-1.2b (hybrid: Mamba2 + a shared block), dense KV
# ---------------------------------------------------------------------------

ZAMBA_REQUESTS = 16


def zamba_generate_path(dev):
    """Main path 3: zamba2-1.2b at full width and depth through
    ``Engine.generate``: 8 prompts of 512 tokens, 32 greedy tokens, dense
    KV; each prefill runs the SSD kernel once per Mamba2 layer and the
    flash kernel once per shared-block application."""
    from repro_torch.configs.zamba2_1_2b import CONFIG
    from repro_torch.models.lm import LM, _hybrid_groups
    from repro_torch.serve.engine import Engine, ServeConfig
    t0 = time.perf_counter()
    lm = LM(CONFIG, torch.bfloat16, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"  zamba2-1.2b: {n_params} params, bf16 (A_log, dt_bias, D fp32), "
        f"random init (seed 0) in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, CONFIG.vocab, ZAMBA_PROMPT_LEN).tolist()
               for _ in range(ZAMBA_PROMPTS)]
    eng = Engine(lm, ServeConfig(max_seq=1024), device=dev)
    eng.generate(prompts, max_new_tokens=MAX_NEW)          # warm-up
    torch.cuda.synchronize()

    reset_counters()
    syncs0 = eng.host_syncs
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = read_counters()
    syncs = eng.host_syncs - syncs0

    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=1)                # prefill + 1 token
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0

    if syncs != 1:
        fail(f"zamba2 generate made {syncs} host syncs, expected 1")
    if [len(o) for o in out] != [MAX_NEW] * len(prompts):
        fail(f"unexpected output lengths {[len(o) for o in out]}")
    if not all(0 <= t < CONFIG.vocab for o in out for t in o):
        fail("a generated token is outside the vocabulary")
    groups = len(_hybrid_groups(CONFIG.n_layers, CONFIG.attn_every))
    want = {"ssd_scan": CONFIG.n_layers, "flash_attention": groups,
            "argmax": MAX_NEW, "paged_decode": 0, "paged_decode_q8": 0}
    if launches != want:
        fail(f"zamba2 generate launched {launches}, expected {want}")
    dec_tok_s = len(prompts) * (MAX_NEW - 1) / max(t_gen - t_prefill, 1e-9)
    log(f"  generate: {t_gen * 1e3:.2f} ms for {len(prompts)} x {MAX_NEW} "
        f"tokens after {ZAMBA_PROMPT_LEN}-token prompts; prefill (+1 token) "
        f"{t_prefill * 1e3:.2f} ms; decode {dec_tok_s:.1f} tokens/s; "
        f"host_syncs {syncs}; launches {launches}")
    log(f"  first tokens: {[o[:4] for o in out]}")
    return lm, launches


def zamba_scheduler_path(lm):
    """Main path 4: zamba2-1.2b behind ``BatchScheduler`` with dense KV:
    16 requests of 64-512-token prompts, budgets 16-48, 8 slots; each
    admission prefills one row at its exact length and merges its SSD
    state, conv tail and KV caches into the slot."""
    from repro_torch.bench.profile_serve import run_scheduler
    from repro_torch.models.lm import _hybrid_groups
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = lm.cfg
    rng = np.random.default_rng(11)
    work = [(rng.integers(1, cfg.vocab, int(n)).tolist(), int(b), 1)
            for n, b in zip(rng.integers(64, 513, ZAMBA_REQUESTS),
                            rng.integers(16, 49, ZAMBA_REQUESTS))]
    eng = Engine(lm, ServeConfig(max_seq=1024, batch_slots=8,
                                 admission_chunk=8), device=lm.device)
    reset_counters()
    syncs0 = eng.host_syncs
    t0 = time.perf_counter()
    sched, out = run_scheduler(eng, work)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    syncs = eng.host_syncs - syncs0
    m = sched.metrics
    if sorted(out) != list(range(len(work))):
        fail(f"zamba2 scheduler completed {sorted(out)} of {len(work)}")
    for rid, (_, budget, _) in enumerate(work):
        if len(out[rid]) != budget:
            fail(f"request {rid}: {len(out[rid])} tokens, budget {budget}")
        if not all(0 <= t < cfg.vocab for t in out[rid]):
            fail(f"request {rid}: a token is outside the vocabulary")
    if syncs != m["segments"]:
        fail(f"zamba2 scheduler made {syncs} host syncs for "
             f"{m['segments']} segments")
    sched.check()
    groups = len(_hybrid_groups(cfg.n_layers, cfg.attn_every))
    want = {"ssd_scan": cfg.n_layers * m["admissions"],
            "flash_attention": groups * m["admissions"],
            "argmax": m["decode_steps"], "paged_decode": 0,
            "paged_decode_q8": 0}
    if launches != want:
        fail(f"zamba2 scheduler launched {launches}, expected {want}")
    new_tokens = sum(len(t) for t in out.values())
    ttfts = [r.ttft for r in sched.completed.values()]
    log(f"  scheduler: {len(out)} requests ({sum(len(w[0]) for w in work)} "
        f"prompt tokens), {new_tokens} tokens in {wall * 1e3:.2f} ms = "
        f"{new_tokens / wall:.1f} tokens/s; mean TTFT "
        f"{np.mean(ttfts) * 1e3:.2f} ms; segments {m['segments']:.0f}; "
        f"decode steps {m['decode_steps']:.0f}; host_syncs {syncs}; "
        f"admissions {m['admissions']:.0f}; launches {launches}")
    return launches


def zamba_token_check(dev):
    """fp32, full width, 7 layers (groups of 6 and 1): the card (kernels)
    and the CPU (plain versions) must emit the same greedy tokens, and the
    prefill logits must agree within max|d| / max|logit| <= 1e-4."""
    from repro_torch.configs.zamba2_1_2b import CONFIG
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(CONFIG, n_layers=7)
    lm_cpu = LM(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(4))
    lm_cpu.embed.table.data.mul_(0.1)
    lm_gpu = LM(cfg, torch.float32, dev)
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    rng = np.random.default_rng(12)
    # 300 tokens: a full chunk of 256 and a ragged one, equal lengths
    prompts = [rng.integers(0, cfg.vocab, 300).tolist() for _ in range(2)]
    sc = ServeConfig(max_seq=512)
    launches0 = ssd_scan.launches
    tok = {"card": Engine(lm_gpu, sc, device=dev).generate(prompts, 8),
           "cpu": Engine(lm_cpu, sc, device="cpu").generate(prompts, 8)}
    if ssd_scan.launches - launches0 != cfg.n_layers:
        fail("the fp32 zamba2 card run did not go through the ssd kernel")
    for k, v in tok.items():
        log(f"  {k}: {v}")
    if tok["card"] != tok["cpu"]:
        fail("zamba2 greedy tokens differ between the card and the CPU")
    logits = {}
    for name, lm in (("cpu", lm_cpu), ("card", lm_gpu)):
        toks = torch.tensor(prompts, dtype=torch.int32, device=lm.device)
        with torch.inference_mode():
            lg, _ = lm.prefill({"tokens": toks},
                               lm.init_decode_state(len(prompts), 512))
        logits[name] = lg.float().cpu()
    rel = ((logits["card"] - logits["cpu"]).abs().max()
           / logits["cpu"].abs().max()).item()
    log(f"  zamba2 prefill logits card vs cpu: max|d|/max|logit| = "
        f"{rel:.3g}")
    if not rel <= 1e-4:
        fail(f"zamba2 prefill logits differ: {rel} > 1e-4")


# ---------------------------------------------------------------------------
# phases 11-12: the tool layer's case studies (STREAM triad, Jacobi-7)
# ---------------------------------------------------------------------------

TRIAD_N = 1 << 27                 # 512 MiB per fp32 array, 1.5 GiB in all
STENCIL = (512, 512, 512)
SWEEPS = 4


def check_triad(dev, timer):
    from repro_torch.kernels.stream_triad import (stream_triad,
                                                  stream_triad_plain)
    gen = torch.Generator(device=dev).manual_seed(6)
    err, last = 0.0, None
    for n in (128, 4096, 128 * 513, TRIAD_N):
        for dtype in (torch.float32, torch.bfloat16):
            b = torch.randn(n, generator=gen, device=dev).to(dtype)
            c = torch.randn(n, generator=gen, device=dev).to(dtype)
            for pipelined in (True, False) if n < TRIAD_N else (True,):
                got = stream_triad(b, c, pipelined=pipelined)
                want = stream_triad_plain(b, c)
                torch.cuda.synchronize()
                e = close(f"triad N={n} {str(dtype)[6:]} pipelined="
                          f"{pipelined}", got, want)
            if n == TRIAD_N and dtype == torch.float32:
                err, last = e, (b, c)
            if n == 128 * 513:       # the schedule never changes a bit
                base = stream_triad(b, c)
                for rows in (1, 3, 256):
                    if not torch.equal(stream_triad(b, c, block_rows=rows),
                                       base):
                        fail(f"triad N={n} {dtype}: block_rows={rows} "
                             f"changes the result")
                if not torch.equal(stream_triad(b, c, pipelined=False),
                                   base):
                    fail(f"triad N={n} {dtype}: one CTA changes the result")
                log(f"  ok triad N={n} {str(dtype)[6:]}: bit-equal across "
                    f"block_rows 1, 3, 256, default and one CTA")
        # views that start 4 bytes past a 16-byte boundary: scalar path
        buf = torch.randn(n + 1, generator=gen, device=dev)
        close(f"triad N={n} fp32 unaligned views",
              stream_triad(buf[1:], buf[:-1]),
              stream_triad_plain(buf[1:], buf[:-1]))
    b, c = last
    a = torch.empty_like(b)
    ms = timer.ms(lambda: stream_triad(b, c))
    plain_ms = timer.ms(lambda: stream_triad_plain(b, c))
    library_ms = timer.ms(lambda: torch.add(b, c, alpha=2.5, out=a))
    bms, by = bound_ms(3 * 4 * TRIAD_N, 2.0 * TRIAD_N, F32_FLOPS)
    b16, c16 = b.bfloat16(), c.bfloat16()
    a16 = torch.empty_like(b16)
    log(f"  triad N=2^27 bf16: {timer.ms(lambda: stream_triad(b16, c16)):.4f}"
        f" ms, torch.add bf16 "
        f"{timer.ms(lambda: torch.add(b16, c16, alpha=2.5, out=a16)):.4f} "
        f"ms (bound {bound_ms(3 * 2 * TRIAD_N, 0.0)[0]:.4f})")
    return dict(name="stream_triad", route="cuda",
                source="src/repro_torch/csrc/stream_triad.cu",
                replaces="src/repro/kernels/stream_triad.py:32",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


def check_jacobi(dev, timer):
    from repro_torch.kernels.jacobi7 import (BLOCK_X, MAX_SWEEPS, TILE_YZ,
                                             jacobi7_naive,
                                             jacobi7_valid_plain,
                                             jacobi7_wavefront,
                                             kernel_bytes, lattice_updates)
    gen = torch.Generator(device=dev).manual_seed(7)
    err = 0.0
    default = (BLOCK_X, *TILE_YZ)
    # (37, 45, 99) is no multiple of any tile: ragged edge columns
    # everywhere, z rows not 16-byte aligned (4-byte copies)
    for shape in ((10, 18, 130), (16, 26, 130), (37, 45, 99), STENCIL):
        x = torch.randn(shape, generator=gen, device=dev)
        for t in range(1, SWEEPS + 1):
            got = (jacobi7_naive(x) if t == 1
                   else jacobi7_wavefront(x, sweeps=t))
            e = close(f"jacobi7 {shape} T={t}", got,
                      jacobi7_valid_plain(x, t))
            if shape == STENCIL and t == SWEEPS:
                err = e
        if shape == (37, 45, 99):     # the tile must not change a bit
            base = jacobi7_wavefront(x, sweeps=3)
            for tile in ((4, 8, 32), (3, 5, 7), (16, 16, 16), (8, 16, 64),
                         (16, 32, 64), (64, 16, 64)):
                if not torch.equal(jacobi7_wavefront(x, sweeps=3, tile=tile),
                                   base):
                    fail(f"jacobi7 result depends on the tile ({tile})")
            log(f"  ok jacobi7 (37, 45, 99) T=3: bit-equal across tiles "
                f"(default {default}, x columns of 3 to 64 planes)")
            # the deepest fusions a launch takes (on a tile whose planes
            # fit), and one past them
            small = (16, 8, 32)
            for t in (6, MAX_SWEEPS):
                close(f"jacobi7 {shape} T={t} tile {small}",
                      jacobi7_wavefront(x, sweeps=t, tile=small),
                      jacobi7_valid_plain(x, t))
            try:
                jacobi7_wavefront(x, sweeps=MAX_SWEEPS + 1, tile=small)
            except ValueError as e:
                if "fuses at most" not in str(e):
                    raise
                log(f"  ok jacobi7 T={MAX_SWEEPS + 1} refused on the card")
            else:
                fail(f"jacobi7 ran T={MAX_SWEEPS + 1} sweeps in one launch")
    # 16-byte copies (z rows aligned) against the same data through
    # 4-byte copies (a view one element past a 16-byte boundary), and the
    # default tile against others streaming other x extents, at 512^3
    buf = torch.empty(x.numel() + 1, device=dev)
    xu = buf[1:].view(STENCIL)
    xu.copy_(x)
    for t in (1, SWEEPS):
        base = jacobi7_wavefront(x, sweeps=t)
        others = [("4-byte copies", jacobi7_wavefront(xu, sweeps=t))]
        # (bz = 60: no whole 32-byte sectors a row, stores transposed)
        for tile in ((64, 16, 64), (256, 16, 64), (8, 16, 64), (64, 16, 60)):
            others.append((f"tile {tile}",
                           jacobi7_wavefront(x, sweeps=t, tile=tile)))
        for what, got in others:
            if not torch.equal(got, base):
                fail(f"jacobi7 {STENCIL} T={t}: {what} changes the result")
    log(f"  ok jacobi7 {STENCIL} T=1, {SWEEPS}: bit-equal across 16- and "
        f"4-byte copies, direct and transposed stores, and tiles "
        f"(default {default}, 64|256|8 x 16 x 64, 64 x 16 x 60)")
    del buf, xu
    ms = timer.ms(lambda: jacobi7_wavefront(x, sweeps=SWEEPS))
    plain_ms = timer.ms(lambda: jacobi7_valid_plain(x, SWEEPS))
    nbytes = 4 * (x.numel() + np.prod([s - 2 * SWEEPS for s in STENCIL]))
    flops = 6.0 * sum(np.prod([s - 2 * t for s in STENCIL])
                      for t in range(1, SWEEPS + 1))
    bms, by = bound_ms(float(nbytes), float(flops), F32_FLOPS)
    # one naive sweep, against one cuDNN convolution with the same filter;
    # cuDNN's fp32 convolutions default to TF32, so it is switched off
    torch.backends.cudnn.allow_tf32 = False
    w = torch.zeros((1, 1, 3, 3, 3), device=dev)
    for i in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
              (1, 1, 2)):
        w[(0, 0) + i] = 1.0 / 6.0
    conv = torch.nn.functional.conv3d
    x5 = x[None, None]
    close("conv3d yardstick (cudnn.allow_tf32 = False) vs one naive sweep",
          conv(x5, w)[0, 0], jacobi7_naive(x))
    naive_ms = timer.ms(lambda: jacobi7_naive(x))
    naive_plain_ms = timer.ms(lambda: jacobi7_valid_plain(x, 1))
    conv_ms = timer.ms(lambda: conv(x5, w))
    nbytes1 = 4 * (x.numel() + np.prod([s - 2 for s in STENCIL]))
    naive_bound = bound_ms(nbytes1, 6.0 * np.prod([s - 2 for s in STENCIL]),
                           F32_FLOPS)
    log(f"  jacobi7 naive {STENCIL} one sweep: {naive_ms:.4f} ms (plain "
        f"{naive_plain_ms:.4f}, conv3d with TF32 off {conv_ms:.4f}, bound "
        f"{naive_bound[0]:.4f} by {naive_bound[1]})")

    # the paper's order: one T-sweep wavefront against T naive sweeps
    def naive_steps():
        y = x
        for _ in range(SWEEPS):
            y = jacobi7_naive(y)
        return y

    four = timer.ms(naive_steps)
    updates = lattice_updates(STENCIL, SWEEPS)
    four_bytes = sum(kernel_bytes([n - 2 * k for n in STENCIL], 1, default)
                     for k in range(SWEEPS))
    log(f"  jacobi7 {STENCIL} {SWEEPS} steps: wavefront T={SWEEPS} "
        f"{ms:.4f} ms ({updates / ms / 1e3:.0f} MLUPS, "
        f"{kernel_bytes(STENCIL, SWEEPS, default) / ms / 1e6:.1f} GB/s "
        f"declared) against {SWEEPS} naive sweeps {four:.4f} ms "
        f"({updates / four / 1e3:.0f} MLUPS, {four_bytes / four / 1e6:.1f} "
        f"GB/s declared): the wavefront is "
        f"{'faster' if ms < four else 'slower'}")
    return dict(name="jacobi7", route="cuda",
                source="src/repro_torch/csrc/jacobi7.cu",
                replaces="src/repro/kernels/jacobi7.py:60",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def case_counters():
    from repro_torch.kernels.jacobi7 import jacobi7_sweeps
    from repro_torch.kernels.stream_triad import stream_triad
    return {"stream_triad": stream_triad, "jacobi7": jacobi7_sweeps}


def perfctr_path(dev):
    """This slice's main path: both case studies at full size through
    ``PerfCtr`` marker regions (the benches' own ``run``), then the
    bandwidth map.  Kernels were warmed up at these shapes in phase 11, so
    the regions run no untimed call and every launch counts."""
    from repro_torch.bench import bench_jacobi_traffic, bench_stream_pinning
    from repro_torch.core.bandwidth import measure_map, model_map, render_map
    from repro_torch.core.perfctr import PerfCtr
    ctr = PerfCtr(groups=("HBM", "ROOFLINE"), device=dev)
    for f in case_counters().values():
        f.launches = 0
    stream = bench_stream_pinning.run(ctr, n=TRIAD_N, samples=100, warmup=0)
    jac = bench_jacobi_traffic.run(ctr, shape=STENCIL, sweeps=SWEEPS,
                                   repeats=10, warmup=0)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in case_counters().items()}
    log(ctr.report())
    log(bench_jacobi_traffic.render(jac))
    per_kernel = {"stream_triad": 0.0, "jacobi7": 0.0}
    for name, m in ctr.regions.items():
        n = m.events["LAUNCHES"]
        if n < 1:
            fail(f"perfctr region {name!r} recorded no launch")
        per_kernel["stream_triad" if name.startswith("triad")
                   else "jacobi7"] += n
    if per_kernel != {k: float(v) for k, v in launches.items()}:
        fail(f"region LAUNCHES {per_kernel} != wrapper counters {launches}")
    hbm = ctr.chip.hbm_bw
    gbps = stream["gbps_median"]
    log(f"  triad 2^27 fp32: median {stream['median_s'] * 1e3:.4f} ms "
        f"[q1 {stream['q1_s'] * 1e3:.4f}, q3 {stream['q3_s'] * 1e3:.4f}] "
        f"= {gbps:.1f} GB/s (best {stream['gbps_best']:.1f}), "
        f"{gbps * 1e9 / hbm:.3f} of the data-sheet {hbm / 1e9:.0f} GB/s")
    if stream["gbps_best"] * 1e9 > 1.05 * hbm:
        fail(f"triad reads {stream['gbps_best']:.1f} GB/s, over 105% of "
             f"the HBM peak")

    pts = measure_map(device=dev, chip=ctr.chip)
    log(render_map(pts, title=f"bandwidth map — {ctr.chip.name} (measured, "
                              f"triad kernel, L2 not flushed)"))
    log(render_map(model_map(ctr.chip),
                   title=f"bandwidth map — {ctr.chip.name} (data sheet)"))
    for p in pts:
        if (p.working_set_bytes >= 4 * ctr.chip.l2_bytes
                and p.bandwidth_best > 1.05 * hbm):
            fail(f"bandwidth map: {p.bandwidth_best / 1e9:.1f} GB/s at "
                 f"{p.working_set_bytes} B, over 105% of the HBM peak")
    if pts[-1].working_set_bytes < 0.99 * 2**31:
        fail("the bandwidth map stops short of 2 GiB")
    return launches


# ---------------------------------------------------------------------------
# phases 13-14: sampled and speculative decoding
# ---------------------------------------------------------------------------

SAMPLED = (("top_k 50", dict(top_k=50)), ("top_p 0.9", dict(top_p=0.9)))
TEMPERATURE = 0.7
SPEC_K = 4
DRAFT_LAYERS = 2
SPEC_REQUESTS = 16


def qwen2(dev, dtype, embed_scale=1.0):
    """qwen2-0.5b at full width and depth, random weights from seed 0."""
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.models.lm import LM
    lm = LM(CONFIG, dtype, dev).init(torch.Generator(device=dev).manual_seed(0))
    lm.embed.table.data.mul_(embed_scale)
    return lm


def matched_draft(lm):
    """The target's first DRAFT_LAYERS blocks with its embedding, final norm
    and (tied) head, shared, not copied: a draft that agrees with the
    target as far as its first blocks decide."""
    from repro_torch.models.lm import LM
    dcfg = dataclasses.replace(lm.cfg, name=f"{lm.cfg.name}-draft"
                               f"{DRAFT_LAYERS}", n_layers=DRAFT_LAYERS)
    draft = LM(dcfg, lm.dtype, lm.device)
    draft.embed = lm.embed
    draft.final_norm = lm.final_norm
    draft.blocks = torch.nn.ModuleList(list(lm.blocks[:DRAFT_LAYERS]))
    return draft


def expect_launches(where, launches, want):
    for k, n in want.items():
        if launches[k] != n:
            fail(f"{k} launched {launches[k]} times on the {where}, "
                 f"expected {n}")


def sampled_path(dev, lm):
    """Phase 13: sampled ``Engine.generate`` (top_k, then top_p) at full
    width; every token is kernel #4 over Gumbel-shifted logits."""
    from repro_torch.kernels.sampling import (argmax_plain, block_argmax,
                                              filtered_logits, gumbel_shift)
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = lm.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    greedy = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024)
                    ).generate(prompts, max_new_tokens=MAX_NEW)
    n_layers = cfg.n_layers
    want = {"flash_attention": n_layers,
            "paged_decode": n_layers * (MAX_NEW - 1), "argmax": MAX_NEW,
            "paged_decode_q8": 0, "ssd_scan": 0}
    launches = None
    for name, filt in SAMPLED:
        eng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024,
                                     temperature=TEMPERATURE, seed=5,
                                     **filt))
        outs, walls = [], []
        for _ in range(2):
            reset_counters()
            syncs0 = eng.host_syncs
            t0 = time.perf_counter()
            outs.append(eng.generate(prompts, max_new_tokens=MAX_NEW))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = read_counters()
            expect_launches(f"sampled generate ({name})", launches, want)
            if eng.host_syncs - syncs0 != 1:
                fail(f"sampled generate made {eng.host_syncs - syncs0} "
                     f"host syncs, expected 1")
        if outs[0] != outs[1]:
            fail(f"sampled generate ({name}): the same seed gave other "
                 f"tokens")
        if [len(o) for o in outs[0]] != [MAX_NEW] * len(prompts) or not all(
                0 <= t < cfg.vocab for o in outs[0] for t in o):
            fail(f"sampled generate ({name}): bad output")
        # one step's #4 launch against its plain twin over the SAME
        # shifted logits (a top_k row is -inf outside its 50 tokens; the
        # edge row has one finite entry, at the vocabulary's end)
        toks, lens = eng._check_call(prompts, MAX_NEW, None)
        with torch.inference_mode():
            logits, _ = eng._prefill_call(toks, lens, prompts, MAX_NEW)
            x = filtered_logits(logits, temperature=TEMPERATURE,
                                k=filt.get("top_k", 0),
                                p=filt.get("top_p", 1.0))
            top1 = torch.softmax(x.float(), dim=-1).amax(dim=-1)
            x = gumbel_shift(x, torch.Generator(device=dev).manual_seed(9))
            x[0] = -torch.inf
            x[0, -1] = 0.0
            got, plain = block_argmax(x), argmax_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, plain) or int(got[0]) != cfg.vocab - 1:
            fail(f"argmax over shifted logits ({name}): kernel "
                 f"{got.tolist()} != plain {plain.tolist()}")
        kept = int(torch.isfinite(x[1]).sum())
        # the draws are live: a first step whose distributions are spread
        # (mean top-1 probability < 0.5) cannot give the greedy token in
        # every row but by a chance under 0.5^8
        p1 = float(top1.mean())
        first_greedy = all(o[0] == g[0] for o, g in zip(outs[0], greedy))
        if first_greedy and p1 < 0.5:
            fail(f"sampled generate ({name}): every first token is the "
                 f"greedy one at a mean top-1 probability of {p1:.3f}")
        n_greedy = sum(a == b for o, g in zip(outs[0], greedy)
                       for a, b in zip(o, g))
        log(f"  sampled generate ({name}, T {TEMPERATURE}): "
            f"{len(prompts) * MAX_NEW / walls[1]:.1f} tokens/s "
            f"({walls[1] * 1e3:.2f} ms a call, {walls[0] * 1e3:.2f} the "
            f"first); the same seed twice gives the same tokens; host_syncs "
            f"1 a call; #4 over the shifted logits equals its plain twin "
            f"({kept} finite logits in row 1); the first step's mean top-1 "
            f"probability {p1:.4f}, {n_greedy} of "
            f"{len(prompts) * MAX_NEW} tokens equal greedy's; launches "
            f"{launches}")
        log(f"  first tokens: {[o[:4] for o in outs[1]]}")
    return launches


def spec_fused_launches(rounds, cfg, k=SPEC_K, greedy=True):
    """Launches one spec ``generate`` implies: both prompt prefills (#1),
    K+1 draft decode steps a round (#2), and #4 for ``y``, the K+1 draft
    samples and, greedy, the verify's argmax."""
    return {"flash_attention": cfg.n_layers + DRAFT_LAYERS,
            "paged_decode": rounds * (k + 1) * DRAFT_LAYERS,
            "argmax": rounds * (k + 2 + int(greedy)),
            "paged_decode_q8": 0, "ssd_scan": 0}


def spec_path(dev, lm):
    """Phase 14: speculative decoding, K = 4, the 2-layer matched draft:
    fp32 parity with target-only greedy (fused and streamed), bf16 against
    target-only, then a mixed spec / non-spec BatchScheduler."""
    from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                          ServeConfig)
    from repro_torch.serve.spec import SpecConfig
    cfg = lm.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    sc = ServeConfig(page_size=PAGE_SIZE, max_seq=1024)
    blind = -(-MAX_NEW // (SPEC_K + 1))

    # ---- fp32: the reference's own invariant (the embedding scaled by 0.1,
    # as in phase 6, so tokens depend on every layer)
    lm32 = qwen2(dev, torch.float32, embed_scale=0.1)
    d32 = matched_draft(lm32)
    spec = SpecConfig(draft_config=d32.cfg, num_draft_tokens=SPEC_K)
    want = Engine(lm32, sc).generate(prompts, max_new_tokens=MAX_NEW)
    eng = Engine(lm32, sc, spec=spec, draft_lm=d32)
    reset_counters()
    syncs0 = eng.host_syncs
    fused = eng.generate(prompts, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    st = dict(eng.spec_stats)
    expect_launches("fp32 spec generate", read_counters(),
                    spec_fused_launches(st["rounds"], cfg))
    fused_syncs = eng.host_syncs - syncs0
    if fused_syncs != st["rounds"] - blind + 1:
        fail(f"fp32 spec generate made {fused_syncs} syncs over "
             f"{st['rounds']} rounds")
    events = []
    reset_counters()
    streamed = eng.generate(prompts, max_new_tokens=MAX_NEW,
                            stream_cb=lambda i, t, d: events.append(len(t)))
    torch.cuda.synchronize()
    expect_launches("fp32 spec streaming", read_counters(),
                    spec_fused_launches(eng.spec_stats["rounds"], cfg))
    log(f"  fp32 target-only: {[o[:6] for o in want]}")
    if fused != want or streamed != want:
        fail(f"fp32 greedy spec tokens differ from target-only: fused "
             f"{fused}, streamed {streamed}, target-only {want}")
    log(f"  fp32 spec greedy == target-only greedy, fused and streamed; "
        f"accept rate {st['accept_rate']:.4f} ({st['accepted']} of "
        f"{st['proposed']}), rounds {st['rounds']}, host_syncs "
        f"{fused_syncs}; streaming: {len(events)} callback "
        f"waves for {sum(events)} tokens in {eng.spec_stats['rounds']} "
        f"rounds")
    del lm32, d32, eng
    torch.cuda.empty_cache()

    # ---- bf16 at full width: spec beside target-only
    draft = matched_draft(lm)
    spec = SpecConfig(draft_config=draft.cfg, num_draft_tokens=SPEC_K)
    base = Engine(lm, sc)
    eng = Engine(lm, sc, spec=spec, draft_lm=draft)
    rates = {}
    for name, e in (("target-only", base), ("spec", eng)):
        out0 = e.generate(prompts, max_new_tokens=MAX_NEW)      # warm-up
        torch.cuda.synchronize()
        reset_counters()
        syncs0 = e.host_syncs
        t0 = time.perf_counter()
        out = e.generate(prompts, max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        if out != out0:
            fail(f"bf16 {name} generate is not deterministic")
        rates[name] = (len(prompts) * MAX_NEW / wall, wall,
                       e.host_syncs - syncs0, out)
    st = dict(eng.spec_stats)
    expect_launches("bf16 spec generate", launches,
                    spec_fused_launches(st["rounds"], cfg))
    gen_launches = launches
    same = sum(a == b for a, b in zip(rates["spec"][3],
                                      rates["target-only"][3]))
    log(f"  bf16 target-only: {rates['target-only'][0]:.1f} tokens/s "
        f"({rates['target-only'][1] * 1e3:.2f} ms, host_syncs "
        f"{rates['target-only'][2]})")
    log(f"  bf16 spec K={SPEC_K}, {DRAFT_LAYERS}-layer matched draft: "
        f"{rates['spec'][0]:.1f} tokens/s ({rates['spec'][1] * 1e3:.2f} ms, "
        f"host_syncs {rates['spec'][2]}); accept rate "
        f"{st['accept_rate']:.4f} ({st['accepted']} of {st['proposed']}), "
        f"rounds {st['rounds']}; rows equal to target-only {same} of "
        f"{len(prompts)}; launches {launches}")

    # ---- the scheduler: 8 slots, bf16 pages, half the requests spec
    seng = Engine(lm, ServeConfig(page_size=PAGE_SIZE, max_seq=1024,
                                  batch_slots=8, admission_chunk=8),
                  spec=spec, draft_lm=draft)
    srng = np.random.default_rng(7)
    work = [(srng.integers(1, cfg.vocab, int(srng.integers(16, 257))
                           ).tolist(), int(srng.integers(16, 49)), r % 2 == 0)
            for r in range(SPEC_REQUESTS)]

    def run():
        sched = BatchScheduler(seng)
        for rid, (p, budget, sp) in enumerate(work):
            sched.submit(Request(rid=rid, prompt=p, max_new_tokens=budget,
                                 spec=sp))
        return sched, sched.run()

    run()                                                    # warm-up
    torch.cuda.synchronize()
    reset_counters()
    syncs0 = seng.host_syncs
    t0 = time.perf_counter()
    sched, out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    m = sched.metrics
    if sorted(out) != list(range(SPEC_REQUESTS)):
        fail(f"spec scheduler completed {sorted(out)}")
    for rid, (_, budget, _) in enumerate(work):
        if len(out[rid].generated) != budget:
            fail(f"spec request {rid}: {len(out[rid].generated)} tokens, "
                 f"budget {budget}")
    if seng.host_syncs - syncs0 != m["segments"]:
        fail(f"spec scheduler made {seng.host_syncs - syncs0} host syncs "
             f"for {m['segments']} segments")
    sched.check()
    sched.pool.check()
    if not sched.pool.allocs == sched.pool.releases > 0:
        fail(f"spec scheduler leaked pages: {sched.pool!r}")
    misses = m["admissions"] - m["prefix_hits"]
    seg = int(m["segments"])
    expect_launches("spec scheduler", launches, {
        "flash_attention": cfg.n_layers * misses
        + DRAFT_LAYERS * m["admissions"],
        "paged_decode": seg * (SPEC_K + 1) * DRAFT_LAYERS,
        "argmax": seg * (SPEC_K + 3), "paged_decode_q8": 0, "ssd_scan": 0})
    new_tokens = sum(len(r.generated) for r in out.values())
    rate = m["draft_accepted"] / max(m["draft_proposed"], 1)
    log(f"  spec scheduler: {SPEC_REQUESTS} requests "
        f"({sum(w[2] for w in work)} spec), {new_tokens} "
        f"tokens in {wall * 1e3:.2f} ms = {new_tokens / wall:.1f} tokens/s; "
        f"rounds {seg} = segments = host_syncs {seng.host_syncs - syncs0}; "
        f"accept rate {rate:.4f} ({m['draft_accepted']:.0f} of "
        f"{m['draft_proposed']:.0f}); KVPool.check() and scheduler.check() "
        f"pass; launches {launches}")
    return gen_launches, launches


# ---------------------------------------------------------------------------
# phase 15: serving snapshots, restore and chaos injection
# ---------------------------------------------------------------------------

SNAP_BUDGETS = [9, 12, 16]
SNAP_KILL = 2           # (a): segments before the kill
CHAOS_KILL = 8          # (b): segments before the kill, past every event


def snapshot_dir():
    """A fresh directory for snapshots inside the checkout's git-ignored
    build tree."""
    import tempfile
    base = ROOT / "build" / "snapshots"
    base.mkdir(parents=True, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=base)


def instrument_snapshots(sched, writes, applies):
    """Time every snapshot write (with its file's bytes and index pages)
    and the restore's page write-back, each ended by a synchronize."""
    write, apply = sched._write_snapshot, sched._apply_restore_index

    def timed_write(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = write(*args, **kwargs)
        dt = time.perf_counter() - t0
        if path is not None:
            writes.append((dt, Path(path).stat().st_size,
                           sched.ft_events[-1]["index_pages"]))
        return path

    def timed_apply(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply(state)
        torch.cuda.synchronize()
        applies.append(time.perf_counter() - t0)
        return out

    sched._write_snapshot = timed_write
    sched._apply_restore_index = timed_apply


def indexed_snapshots(sched):
    return sum(1 for e in sched.ft_events
               if e["type"] == "snapshot" and e["index_pages"])


def check_snapshot_syncs(where, eng, syncs0, sched):
    syncs = eng.host_syncs - syncs0
    want = sched.metrics["segments"] + indexed_snapshots(sched)
    if syncs != want:
        fail(f"{where}: {syncs} host syncs, expected segments "
             f"{sched.metrics['segments']:.0f} + indexed snapshots "
             f"{indexed_snapshots(sched)}")


def snap_stats(writes):
    ms = [w[0] * 1e3 for w in writes]
    nbytes = [w[1] for w in writes]
    pages = [w[2] for w in writes]
    return (f"{len(writes)} snapshots, {min(nbytes)}-{max(nbytes)} bytes "
            f"(median {statistics.median(nbytes):.0f}), index pages "
            f"{min(pages)}-{max(pages)}, write {min(ms):.2f}-{max(ms):.2f} "
            f"ms (median {statistics.median(ms):.2f})")


def first_divergence(got, want):
    for rid in sorted(want):
        a, b = got.get(rid, []), want[rid]
        if a != b:
            k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            return f"request {rid} first differs at token {k}: {a} vs {b}"
    return "none"


def snapshot_parity(dev, smi):
    """Phase 15(a): fp32, full width, 2 layers, fp32 pages of 16 and the
    prefix cache: killed after SNAP_KILL segments with a snapshot after
    each, restored on a FRESH engine, run to the end; every request's
    tokens must equal an uninterrupted card run's."""
    from repro_torch.bench.profile_serve import shared_prefix_workload
    from repro_torch.checkpoint import store
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                          ServeConfig)
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    lm = LM(cfg, torch.float32, dev).init(
        torch.Generator(device=dev).manual_seed(2))
    lm.embed.table.data.mul_(0.1)
    work = shared_prefix_workload(cfg.vocab, 6, 40, [3, 9, 17, 30],
                                  SNAP_BUDGETS, seed=5)
    sc = ServeConfig(page_size=PAGE_SIZE, max_seq=128, batch_slots=3,
                     admission_chunk=4, kv_dtype="fp32")

    def submit(sched):
        for rid, (p, budget, prio) in enumerate(work):
            sched.submit(Request(rid=rid, prompt=p, max_new_tokens=budget,
                                 priority=prio))
        return sched

    base = submit(BatchScheduler(Engine(lm, sc, device=dev)))
    base.run()
    want = {rid: list(r.generated) for rid, r in base.completed.items()}
    writes, applies = [], []
    with snapshot_dir() as d:
        reset_counters()
        eng = Engine(lm, sc, device=dev)
        sched = submit(BatchScheduler(eng, snapshot_dir=d, snapshot_every=1))
        instrument_snapshots(sched, writes, applies)
        sched.run(max_segments=SNAP_KILL)
        check_snapshot_syncs("15(a) killed run", eng, 0, sched)
        if len(sched.completed) >= len(work):
            fail("15(a): the kill left nothing to restore")
        snap = store.latest_snapshot(d)
        eng2 = Engine(lm, sc, device=dev)               # fresh pool, fresh state
        t0 = time.perf_counter()
        sched2 = eng2.restore(snap)
        load_ms = (time.perf_counter() - t0) * 1e3
        instrument_snapshots(sched2, [], applies)
        sched2.run()
        torch.cuda.synchronize()
        launches = read_counters()
    got = {rid: list(r.generated) for rid, r in sched2.completed.items()}
    restore_ev = [e for e in sched2.ft_events if e["type"] == "restore"][0]
    log(f"  15(a) uninterrupted: {want}")
    if got != want:
        fail(f"15(a): restored fp32 tokens differ from the uninterrupted "
             f"run: {first_divergence(got, want)}")
    if restore_ev["index_pages"] <= 0:
        fail(f"15(a): the restore used no page index: {restore_ev}")
    if sched2.metrics["prefix_hits"] < 1:
        fail("15(a): no restored request hit the page index")
    check_snapshot_syncs("15(a) restored run", eng2, 0, sched2)
    sched2.check()
    expect = {"flash_attention": 1, "paged_decode": 1, "argmax": 1}
    for k in expect:
        if launches[k] < 1:
            fail(f"15(a): {k} never launched on the snapshot path")
    log(f"  15(a) killed after {SNAP_KILL} segments; restored on a fresh "
        f"engine: {restore_ev['index_pages']} index pages, "
        f"{restore_ev['pending']} pending, load {load_ms:.2f} ms + page "
        f"write-back {applies[0] * 1e3:.3f} ms; tokens == uninterrupted "
        f"(fp32 pages, card); {snap_stats(writes)}; launches {launches} "
        f"[{smi}]")
    return launches


def chaos_path(dev, lm, smi):
    """Phase 15(b): qwen2-0.5b full width and depth, bf16, phase 5's
    traffic over int8 pages: tokens/s with snapshots every 0 and 1
    segments, then ``ChaosSchedule.smoke()`` with snapshots every 2,
    killed after CHAOS_KILL segments and restored on a fresh engine."""
    from repro_torch.bench import profile_serve as ps
    from repro_torch.checkpoint import store
    from repro_torch.ft.chaos import ChaosSchedule
    from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                          ServeConfig)
    cfg = lm.cfg
    sc = ServeConfig(page_size=ps.PAGE_SIZE, max_seq=1024,
                     batch_slots=ps.SLOTS, admission_chunk=8,
                     kv_dtype="int8")
    eng = Engine(lm, sc, device=dev)
    ps.run_scheduler(eng, ps.shared_prefix_workload(
        cfg.vocab, ps.SLOTS, ps.PREFIX, ps.SUFFIX_LENS, ps.BUDGETS, seed=1))
    work = ps.shared_prefix_workload(cfg.vocab, ps.REQUESTS, ps.PREFIX,
                                     ps.SUFFIX_LENS, ps.BUDGETS, seed=0)

    def submit(sched):
        for rid, (p, budget, prio) in enumerate(work):
            sched.submit(Request(rid=rid, prompt=p, max_new_tokens=budget,
                                 priority=prio))
        return sched

    rates, outs, writes = {}, {}, []
    for every in (0, 1, 1, 0):
        with snapshot_dir() as d:
            kw = dict(snapshot_dir=d, snapshot_every=1) if every else {}
            sched = submit(BatchScheduler(eng, **kw))
            if every:
                instrument_snapshots(sched, writes, [])
            torch.cuda.synchronize()
            syncs0 = eng.host_syncs
            t0 = time.perf_counter()
            sched.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check_snapshot_syncs(f"15(b) snapshot_every={every}", eng, syncs0,
                             sched)
        toks = {rid: list(r.generated) for rid, r in sched.completed.items()}
        if sorted(toks) != list(range(len(work))):
            fail(f"15(b) snapshot_every={every}: completed {sorted(toks)}")
        outs.setdefault(every, toks)
        if toks != outs[every] or toks != outs[0]:
            fail("15(b): snapshots changed the tokens of a bf16 run")
        rates.setdefault(every, []).append(
            sum(len(t) for t in toks.values()) / wall)
    base = outs[0]
    log(f"  15(b) tokens/s, snapshot_every 0: "
        f"{', '.join(f'{r:.1f}' for r in rates[0])}; snapshot_every 1: "
        f"{', '.join(f'{r:.1f}' for r in rates[1])} (turns 0, 1, 1, 0); "
        f"{snap_stats(writes)} [{smi}]")

    chaos = ChaosSchedule.smoke()
    applies = []
    with snapshot_dir() as d:
        reset_counters()
        eng1 = Engine(lm, sc, device=dev)
        sched = submit(BatchScheduler(eng1, snapshot_dir=d, snapshot_every=2,
                                      chaos=chaos))
        sched.run(max_segments=CHAOS_KILL)
        check_snapshot_syncs("15(b) chaos run", eng1, 0, sched)
        cs = chaos.summary()
        if cs["applied"] != len(chaos.events):
            fail(f"15(b): chaos applied {cs['applied']} of "
                 f"{len(chaos.events)} events: {cs}")
        if sorted(cs["skipped"]) != ["device_death", "heartbeat_flap"]:
            fail(f"15(b): unexpected skips {cs['skipped']}")
        notes = {e["kind"]: e.get("note", "") for e in sched.ft_events
                 if e["type"] == "chaos"}
        if not notes["snapshot_corrupt"].startswith("corrupted + detected"):
            fail(f"15(b): snapshot_corrupt: {notes['snapshot_corrupt']!r}")
        bad = sorted(Path(d).glob("*.corrupt"))
        if not bad:
            fail("15(b): no corrupted snapshot on disk")
        try:
            Engine(lm, sc, device=dev).restore(str(bad[0]))
        except store.SnapshotCorrupt:
            pass
        else:
            fail(f"15(b): Engine.restore accepted {bad[0].name}")
        snap = store.latest_snapshot(d)
        eng2 = Engine(lm, sc, device=dev)
        t0 = time.perf_counter()
        sched2 = eng2.restore(snap)
        load_ms = (time.perf_counter() - t0) * 1e3
        instrument_snapshots(sched2, [], applies)
        t0 = time.perf_counter()
        sched2.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
    check_snapshot_syncs("15(b) restored run", eng2, 0, sched2)
    sched2.check()
    sched2.pool.check()
    restore_ev = [e for e in sched2.ft_events if e["type"] == "restore"][0]
    for rid in range(len(work)):
        if not sched2.requests[rid].terminal:
            fail(f"15(b): request {rid} ended {sched2.requests[rid].status}")
    got = {rid: list(r.generated) for rid, r in sched2.completed.items()}
    same = sum(int(a == b) for rid, t in got.items()
               for a, b in zip(t, base[rid]))
    total = sum(len(t) for t in got.values())
    for k in ("flash_attention", "paged_decode_q8", "argmax"):
        if launches[k] < 1:
            fail(f"15(b): {k} never launched on the chaos path")
    kinds = [e["kind"] for e in sched.ft_events if e["type"] == "chaos"]
    log(f"  15(b) chaos (smoke schedule, snapshots every 2): events "
        f"{kinds}, {cs['checks']} invariant closures (KVPool.check + "
        f"scheduler.check), corrupt {bad[0].name} refused by the loader "
        f"and Engine.restore; killed after {CHAOS_KILL} segments with "
        f"{len(sched.completed)} done")
    log(f"  15(b) restore from {Path(snap).name}: "
        f"{restore_ev['index_pages']} index pages, {restore_ev['pending']} "
        f"pending, load {load_ms:.2f} ms + page write-back "
        f"{applies[0] * 1e3:.3f} ms; the rest ran in {wall * 1e3:.2f} ms; "
        f"{len(got)} done, {len(sched2.aborted)} aborted, all terminal; "
        f"tokens equal to the uninterrupted run {same} of {total} "
        f"({same / max(total, 1):.4f}); launches {launches} [{smi}]")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    log("[1/15] probe")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"  device {torch.cuda.get_device_name(0)}, capability "
        f"{torch.cuda.get_device_capability(0)}, count "
        f"{torch.cuda.device_count()}")
    smi = gpu_name_and_limit()
    log(f"  nvidia-smi: {smi}")
    from repro_torch.core import hwinfo
    chip = hwinfo.current_chip(dev)
    bad = hwinfo.check_device(chip, torch.cuda.get_device_properties(dev))
    if bad:
        fail(f"data sheet {chip.name} disagrees with the device: {bad}")
    log(f"  data sheet {chip.name}: {chip.sm_count} SMs, L2 "
        f"{chip.l2_bytes} B, HBM {chip.hbm_bw / 1e12} TB/s, agrees with "
        f"the device's properties")

    log("[2/15] build")
    secs = _build.build_all()
    log(f"  built {list(_build.SOURCES)} in {secs:.2f} s into "
        f"{_build.build_dir()}")

    log("[3/15] kernels vs plain versions")
    timer = Timer(dev)
    from repro_torch.configs.qwen2_0_5b import CONFIG
    rows = [check_flash(dev, timer), check_paged(dev, timer),
            check_paged_q8(dev, timer),
            check_argmax(dev, timer, CONFIG.vocab), check_ssd(dev, timer)]
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.5f} by "
            f"{r['bound_by']})")
    del timer

    log("[4/15] main path 1: qwen2-0.5b Engine.generate, paged, greedy")
    lm, gen_launches = main_path(dev)

    log("[5/15] main path 2: qwen2-0.5b BatchScheduler, int8 pages, "
        "prefix cache")
    sched_launches = scheduler_path(dev, lm)
    del lm
    torch.cuda.empty_cache()

    log("[6/15] fp32 token check: card paged / card dense / cpu paged")
    token_check(dev)

    log("[7/15] fp32 scheduler token check: card scheduler / card generate "
        "/ cpu scheduler; int8 logits card vs cpu")
    sched_token_check(dev)

    log("[8/15] main path 3: zamba2-1.2b Engine.generate, dense KV, greedy")
    lm, zamba_launches = zamba_generate_path(dev)

    log("[9/15] main path 4: zamba2-1.2b BatchScheduler, dense KV")
    zamba_scheduler_path(lm)
    del lm
    torch.cuda.empty_cache()
    # each kernel's launches on the path that carries it
    for r in rows:
        r["launches"] = {"paged_decode_q8": sched_launches,
                         "ssd_scan": zamba_launches}.get(
                             r["name"], gen_launches)[r["name"]]

    log("[10/15] fp32 zamba2 token check: card / cpu, 7 layers")
    zamba_token_check(dev)

    log("[11/15] case-study kernels vs plain versions: STREAM triad, "
        "Jacobi-7")
    timer = Timer(dev)
    case_rows = [check_triad(dev, timer), check_jacobi(dev, timer)]
    del timer
    for r in case_rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.5f} by "
            f"{r['bound_by']})")

    log("[12/15] main path 5: the case studies through PerfCtr marker "
        "regions (HBM, ROOFLINE), the bandwidth map")
    case_launches = perfctr_path(dev)
    for r in case_rows:
        r["launches"] = case_launches[r["name"]]
    rows += case_rows

    log("[13/15] main path 6: qwen2-0.5b sampled Engine.generate (top_k, "
        "top_p), paged")
    # the embedding scaled by 0.1 (as in phase 6): unscaled, the random
    # model echoes its last token with a near one-hot distribution, so
    # neither the draws nor the draft's rejections would matter
    lm = qwen2(dev, torch.bfloat16, embed_scale=0.1)
    sampled_launches = sampled_path(dev, lm)

    log("[14/15] main path 7: speculative decoding, K = 4, 2-layer matched "
        "draft: fp32 parity, bf16 generate, mixed BatchScheduler")
    spec_launches, spec_sched_launches = spec_path(dev, lm)

    log("[15/15] main path 8: serving snapshots and chaos: (a) fp32 "
        "kill / restore parity, (b) qwen2-0.5b int8 scheduler under the "
        "smoke schedule, killed and restored")
    snap_launches = snapshot_parity(dev, smi)
    chaos_launches = chaos_path(dev, lm, smi)
    del lm
    torch.cuda.empty_cache()
    by_path = {"generate": gen_launches, "scheduler_int8": sched_launches,
               "zamba2_generate": zamba_launches,
               "sampled_generate": sampled_launches,
               "spec_generate": spec_launches,
               "spec_scheduler": spec_sched_launches,
               "snapshot_restore_fp32": snap_launches,
               "chaos_restore_int8": chaos_launches}
    for r in rows:
        r["launches_by_path"] = (
            {"perfctr": r["launches"]} if r in case_rows else
            {p: c[r["name"]] for p, c in by_path.items() if c[r["name"]]})

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path")
    print(gpu_name_and_limit(), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
