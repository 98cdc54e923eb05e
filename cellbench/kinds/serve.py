"""A serving cell: a closed loop of clients over the port's
``BatchScheduler`` on a paged ``Engine``, and the check of what it served.

Set-up builds the port's ``LM`` at the configuration's widths in
bfloat16, fills it with :mod:`cellbench.weights`' draw, and builds the
``Engine`` and one ``BatchScheduler``.  The loop then starts: one client
a slot, each sending its session's next ask when the previous answer is
complete.  The scheduler has no intake of arrivals while ``run()`` runs;
its one per-segment callback is ``chaos.tick(sched, segment)``, called
after retirement, and the loop is passed there: it submits each finished
client's next ask.  The window opens at the first segment boundary after
every client's first answer (the ramp of the first round, the warm-up of
every path, counts as set-up) and closes at the first boundary
``--seconds`` later; then no client asks again and the scheduler drains.

End to end: ``serve_tokens_per_s`` is the prompt tokens of every
admission the window's segments completed (the scheduler's
``prompt_tokens``) plus every generated token that reached the host in
the window, over the window's seconds; ``ttft_p95_ms`` is the 95th
percentile of ``Request.ttft`` over every ask submitted in the window,
its first token waited for through the drain.

The check: once the drain is over and the program's state freed, a
sample of the window's answers drawn from the seed (the longest among
them) goes through the plain reference (:mod:`cellbench.reference.
model`) over prompt and served tokens, and each served token's logit is
read against the reference's best at its position: the widest gap over
the sample is compared with the cell's limit.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cellbench import flops as F
from cellbench.bench import device_info, family, p95, reset_peak
from cellbench import traffic as T
from cellbench.program import build_lm
from cellbench.reference import model as R
from cellbench.trace import Profile, Spans, profile_summary

__all__ = ["run", "check", "readings", "run_serve", "served_gaps"]

#: seconds of the traced run's profiled window
PROFILE_SECONDS = 3.0


class _Wrapped:
    """The benchmark's spans around the engine's two entry points, each
    call's wall and, in the traced run, the shapes its kernels ran at for
    the rooflines.  In the traced run a call outside the profiled window
    ends in a synchronize, so its wall holds its device work; inside it
    the host runs ahead of the device as in an untraced run."""

    def __init__(self, eng, spans: Spans, prof: Optional[Profile]):
        self.traced = prof is not None
        self.loop: Optional["ClosedLoop"] = None
        self.prefills: List[dict] = []
        self.decodes: List[dict] = []
        pf, dec = eng.prefill_slot, eng.decode_segment

        def timed(name, fn, *args, **kwargs):
            # traced: synchronize after the call, outside the profiled
            # window only (inside it the host runs ahead as untraced)
            profiled = bool(prof and prof.active)
            synced = self.traced and not profiled
            t0 = time.perf_counter()
            with spans.span(name, sync=synced):
                out = fn(*args, **kwargs)
            return out, dict(wall_s=time.perf_counter() - t0, synced=synced,
                             profiled=profiled)

        def prefill_slot(state, logits_buf, prompt, slot, table_row=None,
                         prefix_len=0):
            out, rec = timed("prefill_slot", pf, state, logits_buf, prompt,
                             slot, table_row=table_row, prefix_len=prefix_len)
            rec.update(new=len(prompt), past=int(prefix_len),
                       in_window=self.loop is not None
                       and self.loop.phase == "window")
            self.prefills.append(rec)
            return out

        def decode_segment(state, logits, steps, generator=None):
            # each row's context before the segment, from the scheduler's
            # host-side count (no sync); an idle slot counts as empty
            lengths = ([int(n) for n in self.loop.sched._slot_len]
                       if prof is not None and prof.active else None)
            out, rec = timed("decode_segment", dec, state, logits, steps,
                             generator)
            rec.update(steps=int(out[0].shape[1]), lengths=lengths)
            self.decodes.append(rec)
            return out

        eng.prefill_slot = prefill_slot
        eng.decode_segment = decode_segment


class ClosedLoop:
    """One client a slot, each asking its sessions' questions in turn;
    ticked by the scheduler after each segment's retirement."""

    def __init__(self, sched, sessions: T.Sessions, clients: int,
                 seconds: float, prof: Optional[Profile], cfg: dict):
        from repro_torch.serve.engine import Request
        self.Request = Request
        self.sched, self.sessions, self.seconds = sched, sessions, seconds
        self.prof, self.cfg = prof, cfg
        self.queue: List[List[T.Ask]] = [[] for _ in range(clients)]
        self.current: List[Optional[object]] = [None] * clients
        self.first_round: set = set()
        self.phase = "ramp"
        self.t_open = self.t_close = 0.0
        self.at_open = self.at_close = (0, 0)
        self.window_rids: List[int] = []
        self.rid = 0
        self.gen_total = 0
        self.flops = 0.0
        self.profile_stop = 0.0
        self.seen_len: Dict[int, int] = {}

    def _submit(self, c: int) -> None:
        if not self.queue[c]:
            self.queue[c] = self.sessions.next_session()
        ask = self.queue[c].pop(0)
        req = self.Request(rid=self.rid, prompt=ask.prompt,
                           max_new_tokens=ask.max_new_tokens)
        if self.phase == "window":
            self.window_rids.append(self.rid)
        self.rid += 1
        self.current[c] = req
        self.sched.submit(req)

    def start(self) -> None:
        for c in range(len(self.current)):
            self._submit(c)
            self.first_round.add(self.current[c].rid)

    def _count(self) -> None:
        """Tokens that reached the host since the last tick (and, traced,
        the FLOPs of producing them)."""
        for req in self.sched.requests.values():
            n0 = self.seen_len.get(req.rid, 0)
            n1 = len(req.generated)
            if n1 > n0:
                self.gen_total += n1 - n0
                if self.prof is not None and self.phase == "window":
                    s = len(req.prompt)
                    for j in range(max(n0, 1), n1):
                        self.flops += F.forward_flops(self.cfg, 1, s + j - 1,
                                                      1)
                self.seen_len[req.rid] = n1

    def tick(self, sched, segment: int) -> None:
        now = time.perf_counter()
        self._count()
        done = [c for c, r in enumerate(self.current)
                if r is not None and r.terminal]
        if self.phase == "ramp" and all(
                sched.requests[r].terminal for r in self.first_round):
            if self.prof is not None:
                # the profiler's own start-up (seconds) stays outside
                self.prof.start()
            now = time.perf_counter()
            self.phase, self.t_open = "window", now
            self.profile_stop = now + PROFILE_SECONDS
            self.at_open = (self.gen_total, sched.metrics["prompt_tokens"])
        elif self.phase == "window":
            if self.prof is not None and self.prof.active and \
                    now >= self.profile_stop:
                self.prof.stop()
            if now - self.t_open >= self.seconds:
                self.phase, self.t_close = "closed", now
                self.at_close = (self.gen_total,
                                 sched.metrics["prompt_tokens"])
                if self.prof is not None and self.prof.active:
                    self.prof.stop()
        if self.phase != "closed":
            for c in done:
                self._submit(c)


def run_serve(cell, seed: int, seconds: float, traced: bool,
              device: torch.device, t_start: float, log) -> dict:
    """One run of a serving cell.  Returns the e2e numbers, the context
    the per-layer readers read, the compared numbers and the device."""
    from repro_torch.serve.engine import BatchScheduler, Engine, ServeConfig
    cfg, spec = cell.cfg, cell.traffic
    dtype = getattr(torch, cfg["torch_dtype"])
    t0 = time.perf_counter()
    lm = build_lm(cfg, seed, device, dtype)
    log(f"[cellbench] set-up: imports and device {t0 - t_start:.2f} s, "
        f"weights {time.perf_counter() - t0:.2f} s")
    scfg = ServeConfig(max_seq=int(spec["max_seq"]),
                       batch_slots=int(spec["slots"]), temperature=0.0,
                       admission_chunk=int(spec["admission_chunk"]),
                       page_size=int(spec["page_size"]),
                       kv_dtype=spec.get("kv_dtype"),
                       prefix_cache=bool(spec["prefix_cache"]))
    if T.max_request_tokens(spec) > scfg.max_seq:
        raise ValueError("the mix's longest request exceeds max_seq")
    eng = Engine(lm, scfg, device=device)
    spans = Spans(traced)
    prof = Profile(device) if traced else None
    wrapped = _Wrapped(eng, spans, prof)
    sessions = T.Sessions(spec, cfg["vocab_size"], seed)
    sched = BatchScheduler(eng)
    loop = ClosedLoop(sched, sessions, int(spec["clients"]), seconds, prof,
                      cfg)
    sched.chaos = loop
    wrapped.loop = loop
    gc.collect()
    reset_peak(device)
    loop.start()
    t_run = time.perf_counter()
    log(f"[cellbench] set-up: engine {t_run - t0:.2f} s after the start "
        f"of the weights")
    with spans.span("run"):
        sched.run()
    if loop.phase != "closed":
        raise RuntimeError("the loop never closed its window")
    setup_s = loop.t_open - t_start
    log(f"[cellbench] ramp {loop.t_open - t_run:.2f} s, drain "
        f"{time.perf_counter() - loop.t_close:.2f} s")
    window_s = loop.t_close - loop.t_open
    gen = loop.at_close[0] - loop.at_open[0]
    prompt = loop.at_close[1] - loop.at_open[1]
    reqs = [sched.requests[r] for r in loop.window_rids]
    ttfts = [r.ttft for r in reqs if r.ttft is not None]
    failed = sum(1 for r in reqs if r.status != "done"
                 or len(r.generated) != r.max_new_tokens)
    e2e = {"setup_s": setup_s,
           "serve_tokens_per_s": (gen + prompt) / window_s,
           "ttft_p95_ms": p95(ttfts) * 1e3 if ttfts else float("nan")}
    log(f"[cellbench] window {window_s:.3f} s: {len(reqs)} asks, "
        f"{len(ttfts)} first tokens (p95 over all), {prompt} prompt + "
        f"{gen} generated tokens; ttft median "
        f"{float(np.median(ttfts)) * 1e3 if ttfts else float('nan'):.1f} ms")
    dev_info = device_info(device, cell.chips)
    summary = profile_summary(prof) if traced and prof.done else None
    ctx = dict(kind="serve", cfg=cfg, spec=spec, window_s=window_s,
               spans=dict(spans.seconds), metrics=dict(sched.metrics),
               prefills=wrapped.prefills, decodes=wrapped.decodes,
               profile=summary,
               serve_flops=loop.flops + sum(
                   F.forward_flops(cfg, p["new"], p["past"], 1)
                   for p in wrapped.prefills if p["in_window"]))
    # the sample to check, drawn from the seed, with the longest in it
    finished = [r for r in reqs if r.status == "done"]
    order = sorted(finished, key=lambda r: (-(len(r.prompt)
                                              + len(r.generated)), r.rid))
    rng = np.random.default_rng([int(seed), 7])
    n = min(int(spec["check_requests"]), len(finished))
    pick = order[:1] + [order[i] for i in sorted(
        rng.choice(np.arange(1, len(order)), size=max(n - 1, 0),
                   replace=False))] if n else []
    admissions = [rid for rid, _ in sched.admission_log]
    prefix = {rid: p["past"] for rid, p in zip(admissions, wrapped.prefills)}
    checks = [(list(r.prompt), list(r.generated), prefix.get(r.rid, 0))
              for r in pick]
    del sched, eng, lm, loop, wrapped
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(e2e=e2e, ctx=ctx, device=dev_info, checks=checks,
                attempted=len(reqs), failed=failed)


def served_gaps(cfg: dict, seed: int, checks, device: torch.device,
                precs=("fp32",)) -> Dict[str, float]:
    """The gap, over every served token of ``checks``, between the
    reference's best logit and the served token's, for each precision of
    the reference (for a precision other than fp32 the token is the one
    that precision puts first, its gap read in fp32's logits): the widest
    over every token (``served_gap``), the widest at a request's first
    token, the prefill's (``prefill_gap``), the mean over the decoded
    tokens (``decode_gap_mean``), and the share of tokens the reference
    puts first too."""
    fam = family(cfg)
    streams = [R.Stream(prompt + gen[:-1], len(prompt) - 1,
                        fam.prefill_calls(past, len(prompt)))
               for prompt, gen, past in checks]
    out = R.serve_logits(cfg, seed, streams, device,
                         getattr(torch, cfg["torch_dtype"]),
                         precs=tuple(dict.fromkeys(("fp32",) + tuple(precs))))
    ref = out["fp32"]
    gaps: Dict[str, Dict[str, float]] = {}
    for pr in precs:
        first, later = [], []
        for (prompt, gen, _), lg, lp in zip(checks, ref, out[pr]):
            toks = (torch.tensor(gen, device=lg.device) if pr == "fp32"
                    else lp.argmax(-1))
            gap = lg.max(-1).values - lg.gather(-1, toks[:, None])[:, 0]
            first.append(gap[:1])
            later.append(gap[1:])
        first, later = torch.cat(first).double(), torch.cat(later).double()
        every = torch.cat([first, later])
        gaps[pr] = {"served_gap": float(every.max()),
                    "prefill_gap": float(first.max()),
                    "decode_gap_mean": float(later.mean()),
                    "same_share": float((every == 0).double().mean())}
    return gaps


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t_start: float, log) -> dict:
    """The kind's run: :func:`run_serve`."""
    return run_serve(cell, seed, seconds, traced, device, t_start, log)


def check(cell, seed: int, out: dict, device: torch.device, log) -> dict:
    """The numbers compared: the served gaps against the float32
    reference."""
    t0 = time.perf_counter()
    nums = served_gaps(cell.cfg, seed, out["checks"], device)["fp32"]
    log(f"[cellbench] reference {time.perf_counter() - t0:.2f} s over "
        f"{sum(len(c[1]) for c in out['checks'])} served tokens")
    return nums


def readings(cell, seed: int, seconds: float, device: torch.device,
             controls: bool = True) -> dict:
    """One seed's program and control readings: the served gaps against
    the float32 reference, and the gaps of the tokens each float8
    control puts first."""
    out = run_serve(cell, seed, seconds, False, device, time.perf_counter(),
                    lambda m: None)
    precs = ("fp32", "fp8_gemm", "fp8") if controls else ("fp32",)
    g = served_gaps(cell.cfg, seed, out["checks"], device, precs=precs)
    res = {"program": g["fp32"], "e2e": out["e2e"],
           "tokens_checked": sum(len(c[1]) for c in out["checks"])}
    res.update({f"control_{pr}": g[pr] for pr in precs[1:]})
    return res
