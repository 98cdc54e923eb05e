"""Request-plane robustness under fault injection, on one card.

Counterpart of ``benchmarks/bench_chaos.py``: its four claims, measured
with the port's ``BatchScheduler`` (fp32 greedy, so every parity check is
exact):

1. **Overload is O(1) and honest** — with a bounded admission queue, the
   rejected submit returns in microseconds with a structured retryable
   error, and the admitted requests keep their time to first token within
   2x of the uncontended baseline (asserted).
2. **Kill-and-restore parity** — a run killed after two segments resumes
   from its crash-safe snapshot on a FRESH engine and gives the greedy
   tokens of an uninterrupted run (asserted).
3. **Corruption is detected, never restored** — flipping a byte in the
   newest snapshot makes the loader raise ``SnapshotCorrupt`` (asserted);
   the restore falls back to the older intact snapshot.
4. **A seeded chaos schedule is survivable** — ``ChaosSchedule.smoke()``:
   pool exhaustion, slow and hung segments, snapshot corruption, with the
   pool + scheduler invariant closure after every event; every request
   ends terminal.  The port serves on one card, so the heartbeat flap and
   the device death are recorded as skipped (the JAX bench needs a mesh
   for them too).

The model is the JAX bench's (dense, vocab 256, 2 layers, 8 heads over 4
KV heads; d_model 64 with ``--smoke``, else 128) with random weights from
seed 0 and the embedding scaled by 0.1, so greedy tokens depend on every
layer; pages of 16 tokens, 4 slots.

    PYTHONPATH=src python -m repro_torch.bench.bench_chaos [--smoke]
        [--device cpu] [--json PATH]

``--device`` defaults to ``cuda``; ``--device cpu`` runs the kernels'
plain versions on the host (its times are the host's, not the card's).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.bench.common import card_line, finish, setup_device, sync
from repro_torch.checkpoint import store
from repro_torch.ft.chaos import ChaosSchedule
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve.admission import AdmissionRejected
from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                      ServeConfig)


def _lm(smoke: bool, device) -> LM:
    cfg = LMConfig(name="chaos-bench", family="dense", vocab=256,
                   d_model=64 if smoke else 128, n_layers=2, num_heads=8,
                   num_kv_heads=4, d_ff=128 if smoke else 256)
    lm = LM(cfg, torch.float32, device).init(
        torch.Generator(device=device).manual_seed(0))
    lm.embed.table.data.mul_(0.1)
    return lm


SERVE = ServeConfig(max_seq=256, batch_slots=4, temperature=0.0,
                    admission_chunk=8, page_size=16)


def _requests(vocab: int, n: int, plen: int, max_new: int, base: int = 0,
              priorities=(1,)) -> List[Request]:
    rng = np.random.default_rng(7 + base)
    return [Request(rid=base + rid,
                    prompt=rng.integers(1, vocab, size=plen).tolist(),
                    max_new_tokens=max_new,
                    priority=priorities[rid % len(priorities)])
            for rid in range(n)]


def _ttfts(done) -> List[float]:
    return [r.ttft for r in done.values() if r.ttft is not None]


def run(csv: list, smoke: bool = False, device="cuda") -> Dict:
    device = torch.device(device)
    n_req, plen, max_new = 6, 8, 16
    lm = _lm(smoke, device)
    vocab = lm.cfg.vocab
    eng = Engine(lm, SERVE, device=device)
    summary: Dict = {}

    # ---- 1. uncontended baseline (the first pass warms every shape) ----
    for _ in range(2):
        sched = BatchScheduler(eng)
        for r in _requests(vocab, n_req, plen, max_new):
            sched.submit(r)
        sync(device)
        t0 = time.perf_counter()
        base_done = sched.run()
        sync(device)
        t_base = time.perf_counter() - t0
    base_toks = {rid: list(r.generated) for rid, r in base_done.items()}
    ntok = sum(len(t) for t in base_toks.values())
    base_ttft = float(np.mean(_ttfts(base_done)))
    print(f"baseline: {ntok} tokens in {t_base:.3f}s "
          f"({ntok / t_base:.1f} tok/s), mean TTFT {base_ttft * 1e3:.2f} ms")
    csv.append(("chaos_baseline_tok_s", 1e6 * t_base / max(ntok, 1),
                f"tok_s={ntok / t_base:.1f}"))
    summary["baseline"] = {"tok_s": ntok / t_base,
                           "mean_ttft_ms": base_ttft * 1e3}

    # ---- 2. overload: O(1) retryable rejection, bounded TTFT ----------
    cap = SERVE.batch_slots                  # queue bound = one extra wave
    sched = BatchScheduler(eng, max_queue=cap, shed_policy="reject-new")
    admitted, rejections, rej_walls = [], [], []
    for r in _requests(vocab, 8 * cap, plen, max_new, base=100):
        t0 = time.perf_counter()
        try:
            sched.submit(r)
            admitted.append(r)
        except AdmissionRejected as e:
            rej_walls.append(time.perf_counter() - t0)
            rejections.append(e.rejection)
    over_done = sched.run()
    over_ttft = float(np.mean(_ttfts(over_done)))
    rej_us = 1e6 * float(np.mean(rej_walls))
    ratio = over_ttft / base_ttft
    print(f"overload: {len(admitted)} admitted / {len(rejections)} "
          f"rejected (mean {rej_us:.1f} us/rejection, all retryable="
          f"{all(r.retryable for r in rejections)}); admitted TTFT "
          f"{over_ttft * 1e3:.2f} ms = {ratio:.2f}x baseline")
    assert rejections and all(r.retryable for r in rejections)
    assert all(r.retry_after_s > 0 for r in rejections)
    assert len(over_done) == len(admitted), "an admitted request was lost"
    assert ratio <= 2.0, \
        f"admitted TTFT under overload {ratio:.2f}x baseline (> 2x)"
    csv.append(("chaos_rejection_us", rej_us,
                f"rejected={len(rejections)},retryable=1"))
    csv.append(("chaos_overload_ttft_ratio", ratio * 1e6,
                f"ratio={ratio:.2f}"))
    summary["overload"] = {
        "admitted": len(admitted), "rejections": len(rejections),
        "rejection_us": rej_us, "retryable": True,
        "mean_ttft_ms": over_ttft * 1e3, "ttft_ratio": ratio}

    # ---- 3. kill-and-restore parity + corruption detection ------------
    with tempfile.TemporaryDirectory() as snapdir:
        sched = BatchScheduler(eng, snapshot_dir=snapdir, snapshot_every=1)
        for r in _requests(vocab, n_req, plen, max_new):
            sched.submit(r)
        sched.run(max_segments=2)               # "killed" after two segments
        snaps = store.list_snapshots(snapdir)
        assert len(snaps) >= 2, f"expected >=2 snapshots, got {snaps}"
        with open(snaps[-1], "r+b") as f:
            blob = bytearray(f.read())
            blob[len(blob) // 2] ^= 0xFF
            f.seek(0)
            f.write(blob)
        try:
            store.load_serving_snapshot(snaps[-1])
            corrupt_detected = False
        except store.SnapshotCorrupt:
            corrupt_detected = True
        assert corrupt_detected, "corrupted snapshot loaded cleanly"
        os.replace(snaps[-1], snaps[-1] + ".corrupt")
        intact = store.latest_snapshot(snapdir)
        assert intact is not None, "no intact snapshot to fall back to"
        eng2 = Engine(lm, SERVE, device=device)     # same weights, new pool
        t0 = time.perf_counter()
        sched2 = eng2.restore(intact)
        restore_ms = (time.perf_counter() - t0) * 1e3
        sched2.run()
        got = {rid: list(r.generated) for rid, r in sched2.completed.items()}
        parity = got == base_toks
        index_pages = [e for e in sched2.ft_events
                       if e["type"] == "restore"][0]["index_pages"]
        print(f"kill-and-restore: killed at segment 2, corrupt newest "
              f"detected={corrupt_detected}, restored from "
              f"{os.path.basename(intact)} ({index_pages} index pages, "
              f"{restore_ms:.2f} ms to load); token parity: "
              f"{'OK' if parity else 'FAIL'}")
        assert parity, "restored tokens diverged from uninterrupted run"
        csv.append(("chaos_restore_parity", 1.0,
                    f"parity={parity},corrupt_detected={corrupt_detected}"))
        summary["restore"] = {
            "parity": parity, "corrupt_detected": corrupt_detected,
            "index_pages": index_pages, "restore_ms": restore_ms,
            "snapshots_written": int(sched.metrics["snapshots"]),
            "restores": int(sched2.metrics["restores"])}

    # ---- 4. seeded chaos schedule ------------------------------------
    with tempfile.TemporaryDirectory() as snapdir:
        chaos = ChaosSchedule.smoke()
        sched = BatchScheduler(Engine(lm, SERVE, device=device),
                               snapshot_dir=snapdir, snapshot_every=2,
                               chaos=chaos, max_queue=16,
                               shed_policy="shed-lowest")
        # sized so the run outlives the whole smoke schedule (>= 6
        # segments): every injection kind fires
        mix = _requests(vocab, 12, plen, 24, base=500, priorities=(0, 1, 2))
        mix[3].deadline_ms = 0.5                # expires at the first boundary
        for r in mix:
            sched.submit(r)
        sched.cancel(mix[5].rid)
        t0 = time.perf_counter()
        sched.run()
        dt = time.perf_counter() - t0
        sched.check()                            # final invariant closure
        terminal = all(sched.requests[r.rid].terminal for r in mix)
        chaos_events = [e for e in sched.ft_events if e["type"] == "chaos"]
        assert terminal, "a request survived the chaos run non-terminal"
        assert chaos_events, "chaos schedule never fired"
        cs = chaos.summary()
        assert sorted(cs["skipped"]) == ["device_death", "heartbeat_flap"], \
            cs["skipped"]
        print(f"chaos: {cs['applied']}/{cs['events']} events applied "
              f"({cs['by_kind']}), {cs['checks']} invariant closures, "
              f"{len(sched.completed)} finished / {len(sched.aborted)} "
              f"cleanly aborted in {dt:.3f}s; skipped={cs['skipped']}")
        csv.append(("chaos_schedule_events", float(cs["applied"]) or 1.0,
                    f"checks={cs['checks']},terminal={terminal}"))
        summary["chaos"] = {
            "schedule": cs, "all_terminal": terminal,
            "completed": len(sched.completed),
            "aborted": len(sched.aborted), "mesh": False,
            "event_types": sorted({e["type"] for e in sched.ft_events}),
            "ft_events": sched.ft_events}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI scale: d_model 64")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the summary here")
    args = ap.parse_args(argv)
    device = setup_device(args.device)
    print(f"[bench_chaos] device {device}: {card_line(device)}")
    csv: list = []
    summary = run(csv, smoke=args.smoke, device=device)
    return finish("bench_chaos", csv, summary, args, device)


if __name__ == "__main__":
    raise SystemExit(main())
