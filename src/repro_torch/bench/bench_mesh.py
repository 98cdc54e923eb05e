"""Mesh-sharded serving: token parity, per-sharding tuning, ft/ degradation.

Port of ``benchmarks/bench_mesh.py``; three claims, measured (fp32 so
greedy argmax is bit-exact):

1. **Parity** — the sharded engine (weights and paged-KV head slices over
   the ``model`` axis) gives the same greedy tokens as the single-device
   engine on the same request mix, at every mesh shape the world's ranks
   allow ((1, 2) and (1, 4)).
2. **Per-sharding tuning** — the autotuner keys on ``(mesh_shape, axis,
   per_device_heads)``; each sharding sweeps once, at the head counts
   each rank's kernel sees, and a fresh process reads its record back
   with 0 sweeps and 0 timed probes (the tests run this bench twice).
3. **Degradation** — killing a rank's heartbeats mid-run trips the
   heartbeat -> governor -> re-mesh path: in-flight requests finish with
   the same tokens on the survivors and the hot spare, and the event
   (re-mesh latency, new mesh) lands in the summary.

    PYTHONPATH=src python -m repro_torch.bench.bench_mesh --device cpu \\
        --ranks 5 --smoke --json BENCH_mesh.json     # 5 gloo ranks
    PYTHONPATH=src python -m repro_torch.bench.bench_mesh --ranks 3 \\
        --json BENCH_mesh.json                       # 3 ranks on the card

``--ranks N`` spawns N ranks over a ``file://`` store (no network):
gloo on the CPU, and on the card one rank a card over NCCL, or gloo when
the ranks outnumber the cards (every rank then runs on ``cuda:0``).
``python -m repro_torch.bench --only mesh`` runs it the same way
(:func:`run_spawned`, 3 ranks).  Under
``torchrun`` it runs in the launched ranks instead.  With fewer than 3
ranks the shapes (and the kill experiment) degrade: the bench reports
what it could cover instead of failing.  Rank 0 tunes (``--cache-dir``,
else ``$REPRO_CACHE_DIR``, else a temporary root) and writes ``--json``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.bench.common import card_line, claim


def _build(smoke: bool, device: torch.device):
    from repro_torch.models.lm import LM, LMConfig
    from repro_torch.serve.engine import ServeConfig
    # kvh=4 so the model axis can be 2 (pdh=2) or 4 (pdh=1); fp32 keeps
    # greedy argmax bit-exact across the reduction orders of the shards
    cfg = LMConfig(name="mesh-bench", family="dense", vocab=256,
                   d_model=64 if smoke else 128, n_layers=2,
                   num_heads=8, num_kv_heads=4, d_ff=128 if smoke else 256)
    # the full model lives on the CPU: the sharded engines take it as
    # their host copy and put only their blocks on the rank's device
    host = LM(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    scfg = ServeConfig(max_seq=256, batch_slots=4, temperature=0.0,
                       admission_chunk=8, page_size=16)
    if device.type == "cpu":
        return host, host, scfg
    lm = LM(cfg, torch.float32, device)
    lm.load_state_dict(host.state_dict())
    return host, lm, scfg


def _requests(vocab: int, n: int, plen: int, max_new: int):
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(7)
    return [Request(rid=rid,
                    prompt=rng.integers(1, vocab, size=plen).tolist(),
                    max_new_tokens=max_new)
            for rid in range(n)]


def _run_sched(eng, reqs, kill=None, **sched_kw):
    from repro_torch.serve.engine import BatchScheduler
    sched = BatchScheduler(eng, **sched_kw)
    for r in reqs:
        sched.submit(r)
    if kill is not None:
        sched.inject_failure(kill, at_segment=1)
    t0 = time.perf_counter()
    done = sched.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    return {rid: list(r.generated) for rid, r in done.items()}, dt, sched


def run(csv: list, session=None, smoke: bool = False,
        ft: Optional[Dict] = None, device=None) -> Dict:
    """The three claims, on every rank of the world (SPMD); rank 0's
    summary is the bench's.  ``session`` (rank 0's) tunes per sharding."""
    import torch.distributed as dist
    from repro_torch.kernels import registry
    from repro_torch.launch.mesh import make_serve_mesh, rank_device
    from repro_torch.serve.engine import Engine
    device = device or rank_device()
    ft = dict(ft or {})
    # the degradation experiment wants aggressive detection by default
    ft.setdefault("ft_timeout_steps", 1)
    ft.setdefault("ft_confirm", 1)
    world = dist.get_world_size()
    shapes = [s for s in [(1, 2), (1, 4)] if int(np.prod(s)) <= world]
    print(f"== mesh-sharded serving ({world} ranks on {device}; shapes "
          f"{shapes or '[none: single rank]'}) ==")
    lm, card_lm, scfg = _build(smoke, device)
    n_req, plen, max_new = 8, 8, 24

    def mk():
        return _requests(lm.cfg.vocab, n_req, plen, max_new)

    ref_toks, t_ref, _ = _run_sched(Engine(card_lm, scfg, device=device),
                                    mk())
    del card_lm
    ntok = sum(len(t) for t in ref_toks.values())
    print(f"single-device: {ntok} tokens in {t_ref:.2f}s "
          f"({ntok / t_ref:.1f} tok/s)")
    csv.append(("mesh_serve_single_tok_s", 1e6 * t_ref / max(ntok, 1),
                f"tok_s={ntok / t_ref:.1f}"))
    head_dim = lm.cfg.resolved_head_dim
    summary = {"ranks": world, "device": str(device), "shapes": [],
               "tune": [], "parity": None, "degradation": None}
    parity_ok = True
    for shape in shapes:
        sm = make_serve_mesh(shape)
        eng = Engine(lm, scfg, device=device, mesh=sm)
        toks, dt, _ = _run_sched(eng, mk())
        same = toks == ref_toks
        parity_ok &= same
        tps = ntok / dt
        facts = eng.mesh_facts
        print(f"mesh {shape}: {tps:10.1f} tok/s  token parity vs "
              f"single-device: {'OK' if same else 'FAIL'}  facts={facts}")
        claim(same, f"sharded tokens diverged on mesh {shape}")
        tag = "x".join(str(s) for s in shape)
        csv.append((f"mesh_serve_{tag}_tok_s", 1e6 * dt / max(ntok, 1),
                    f"tok_s={tps:.1f},pdh={facts['per_device_heads']}"))
        summary["shapes"].append({
            "shape": list(shape), "tok_s": tps,
            "per_device_heads": facts["per_device_heads"], "parity": same})
        if session is not None:
            # per-sharding tune record at the rank's head counts: the mesh
            # facts join the key, so THIS sharding's winner persists
            # independently of the others
            m = shape[-1]
            rec = registry.autotune(
                "attention", session, b=1, h=lm.cfg.num_heads // m,
                kvh=lm.cfg.num_kv_heads // m, sq=plen, sk=plen, dh=head_dim,
                dtype=lm.dtype, backend=device.type, **facts)
            print(f"  tune[{tag}]: key={rec.key} choice={tuple(rec.choice)} "
                  f"({'swept' if rec.swept else 'warm'}, "
                  f"{rec.lowerings} timed probes)")
            summary["tune"].append({
                "shape": list(shape), "key": rec.key,
                "choice": list(rec.choice), "swept": bool(rec.swept),
                "timed_probes": int(rec.lowerings)})
    summary["parity"] = parity_ok

    # ---- ft/: kill a rank mid-run, finish degraded on the survivors ----
    if world > 2:
        sm = make_serve_mesh((1, 2))
        eng = Engine(lm, scfg, device=device, mesh=sm)
        killed = sm.device_ids[1]
        toks, dt, sched = _run_sched(eng, mk(), kill=killed, **ft)
        same = toks == ref_toks
        remesh = [e for e in sched.ft_events if e["type"] == "remesh"]
        claim(bool(remesh), "injected failure never triggered a re-mesh")
        ev = remesh[0]
        print(f"degradation: killed rank {killed} after segment "
              f"{ev['segment']}; re-mesh onto {ev['device_ids']} in "
              f"{ev['remesh_latency_s'] * 1e3:.1f} ms; post-re-mesh token "
              f"parity: {'OK' if same else 'FAIL'}")
        claim(same, "tokens diverged after the re-mesh")
        claim(killed not in ev["device_ids"],
              f"the killed rank {killed} is still in the mesh")
        csv.append(("mesh_serve_remesh_latency_ms",
                    ev["remesh_latency_s"] * 1e3,
                    f"failed={ev['failed']},mesh={ev['axis_sizes']}"))
        summary["degradation"] = {
            "killed": int(killed), "events": sched.ft_events,
            "remeshes": int(sched.metrics["remeshes"]),
            "token_parity_after": same, "tok_s_degraded": ntok / dt}
    else:
        print("degradation experiment skipped: needs >2 ranks "
              "(mesh 1x2 + a hot spare)")
    return summary


def _rank(rank: int, world: int, init_method: Optional[str],
          device: str, smoke: bool, ft: Dict, cache_dir: Optional[str]):
    """One rank of the bench: join the group, run, return rank 0's
    (summary, csv)."""
    from repro_torch.bench.common import tune_session
    from repro_torch.launch.mesh import init_process
    ncards = torch.cuda.device_count() if device == "cuda" else 0
    if device == "cuda" and world > ncards:
        dev = init_process("cuda:0", backend="gloo",
                           init_method=init_method, rank=rank,
                           world_size=world)
    else:
        dev = init_process(device, init_method=init_method, rank=rank,
                           world_size=world)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    torch.set_num_threads(1)
    csv: list = []
    if rank != 0:                   # rank 0 speaks for the run
        with contextlib.redirect_stdout(io.StringIO()):
            run(csv, smoke=smoke, ft=ft, device=dev)
        return None
    with tune_session(cache_dir) as sess:
        return run(csv, session=sess, smoke=smoke, ft=ft, device=dev), csv


def run_spawned(csv: list, smoke: bool = False, device="cuda",
                ranks: int = 3, cache_dir: Optional[str] = None) -> Dict:
    """:func:`run` over ``ranks`` spawned ranks (the bench runner's entry):
    rank 0's summary, its CSV rows appended to ``csv``."""
    from repro_torch.launch.mesh import spawn
    ft = {"ft_timeout_steps": 1, "ft_confirm": 1}
    summary, rows = spawn(_rank, ranks, args=(
        torch.device(device).type, smoke, ft, cache_dir))[0]
    csv.extend(rows)
    return summary


def main(argv=None) -> int:
    from repro_torch.launch import cli
    from repro_torch.launch.mesh import spawn
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI scale: d_model 64")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--ranks", type=int, default=5,
                    help="ranks to spawn (default 5: (1, 4) and the kill "
                         "experiment); ignored under torchrun")
    ap.add_argument("--cache-dir", default=None,
                    help="tune-record root (default $REPRO_CACHE_DIR, "
                         "else a temporary one)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the spawned ranks may take")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the summary here")
    cli.add_ft_args(ap)
    ap.set_defaults(ft_timeout_steps=1, ft_confirm=1)
    args = ap.parse_args(argv)
    ft = cli.ft_kwargs(args, ap)
    ft = {k: ft[k] for k in ("ft_timeout_steps", "ft_confirm")}
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        out = _rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                    None, args.device, args.smoke, ft, args.cache_dir)
        if out is None:
            return 0
    else:
        out = spawn(_rank, args.ranks, args=(args.device, args.smoke, ft,
                                             args.cache_dir),
                    timeout_s=args.timeout)[0]
    summary, csv = out
    print("name,us_per_call,derived")
    for name, us, derived in csv:
        print(f"{name},{us:.2f},{derived}")
    if args.json:
        card = card_line(torch.device(args.device))
        with open(args.json, "w") as f:
            json.dump({"smoke": args.smoke, "card": card, **summary}, f,
                      indent=1)
        print(f"[bench_mesh] wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
