"""Flash prefill on the card: kernel #1 against its plain versions.

Counterpart of the parity half of ``benchmarks/bench_flash_prefill.py``:
on the serving shapes the old JAX kernel got wrong (``sq != sk`` with
``q_offset = sk - sq``, ragged ``kv_valid``) it holds three
implementations to an fp64 oracle computed from the same inputs:

* ``flash``: :func:`repro_torch.kernels.flash_attention.
  flash_attention_bhsd`, the CUDA kernel on the card (its plain twin on
  the CPU);
* ``plain``: :func:`~repro_torch.kernels.flash_attention.
  flash_attention_plain`, the twin (materialized scores, fp32 softmax);
* ``dense``: the model layer's GQA attention (``models/attention.py``'s
  grouped scores and outputs over BSHD tensors) with the causal and
  ragged mask, the JAX bench's ``full`` path.

Each is held to ``max|err| < 1e-4`` in fp32 (raises otherwise) and wall
timed; ``torch.nn.functional.scaled_dot_product_attention`` with the same
mask is timed beside them as ``library_us`` (the port never calls it on
its path).  qwen2-0.5b's prefill shape (14 heads over 2, Dh 64, 8 ragged
prompts of up to 512 tokens) runs too, in bf16, held at the repo's bf16
tolerance (rtol = atol = 3e-2).

The autotune half (``--tune``, or ``run(..., tune=True)``): the kernel's
``(bq, bk)`` at the JAX bench's shape through ``registry.autotune`` and a
``ProfileSession`` (timed on the card; the roofline over declared events
on the CPU), where the JAX bench goes through the deprecated
``kernels/autotune.py``; then the same sweep on a fresh session over the
same cache, which must time nothing (raises otherwise).

    PYTHONPATH=src python -m repro_torch.bench.bench_flash_prefill
        [--smoke] [--device cpu] [--tune] [--json PATH]
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.bench.common import (card_line, claim, finish,
                                      setup_device, timed, tune_session)
from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                 flash_attention_plain)
from repro_torch.models.attention import NEG_INF, _gqa_out, _gqa_scores

#: qwen2-0.5b's prefill: the 8 ragged prompts of the main path
QWEN2_PROMPTS = [512, 384, 301, 256, 129, 64, 17, 1]
FP32_ATOL = 1e-4
BF16_TOL = 3e-2


def shapes(smoke: bool) -> Dict[str, int]:
    """The JAX bench's shapes (``benchmarks/bench_flash_prefill.py:25-28``)."""
    if smoke:
        return dict(b=2, h=4, kvh=2, sq=128, sk=192, dh=32)
    return dict(b=2, h=8, kvh=4, sq=512, sk=768, dh=64)


def _mask(kv_len: torch.Tensor, sq: int, sk: int, q_offset: int
          ) -> torch.Tensor:
    """[B, Sq, Sk] causal at ``q_offset`` and ragged at ``kv_len``."""
    kpos = torch.arange(sk, device=kv_len.device)
    qpos = torch.arange(sq, device=kv_len.device) + q_offset
    return ((kpos[None, None, :] <= qpos[None, :, None])
            & (kpos[None, None, :] < kv_len[:, None, None]))


def oracle(q, k, v, kv_len, q_offset) -> torch.Tensor:
    """fp64 masked softmax attention, q [B,H,Sq,Dh], k/v [B,KVH,Sk,Dh]."""
    g = q.shape[1] // k.shape[1]
    kd = k.double().repeat_interleave(g, 1)
    vd = v.double().repeat_interleave(g, 1)
    s = (q.double() @ kd.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    ok = _mask(kv_len, q.shape[2], k.shape[2], q_offset)[:, None]
    p = torch.softmax(torch.where(ok, s, -torch.inf), dim=-1)
    return p @ vd


def dense_attention(q, k, v, kv_len, q_offset) -> torch.Tensor:
    """The model layer's GQA attention over BSHD views with the mask, in
    q's dtype with an fp32 softmax; returns BHSD."""
    qb, kb, vb = (t.transpose(1, 2) for t in (q, k, v))
    scores = _gqa_scores(qb, kb).float()                  # [B,KVH,G,Sq,Sk]
    ok = _mask(kv_len, q.shape[2], k.shape[2], q_offset)[:, None, None]
    probs = torch.softmax(torch.where(ok, scores, NEG_INF), -1).to(q.dtype)
    return _gqa_out(probs, vb).transpose(1, 2)


def _case(name: str, b, h, kvh, sq, sk, dh, kv_len, q_offset, dtype,
          device, reps: int, seed: int) -> Dict:
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(n, s):
        return torch.randn((b, n, s, dh), generator=gen).to(device, dtype)

    q, k, v = rnd(h, sq), rnd(kvh, sk), rnd(kvh, sk)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=device)
    kw = dict(causal=True, q_offset=q_offset, kv_valid=kvl)
    want = oracle(q, k, v, kvl, q_offset)
    impls = {
        "flash": lambda: flash_attention_bhsd(q, k, v, **kw),
        "plain": lambda: flash_attention_plain(q, k, v, **kw),
        "dense": lambda: dense_attention(q, k, v, kvl, q_offset),
    }
    g = h // kvh
    ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    mask = _mask(kvl, sq, sk, q_offset)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    errs, walls = {}, {}
    for impl, fn in impls.items():
        out, _ = timed(device, fn)                     # warm-up, built
        _, walls[impl] = timed(device, fn, reps)
        errs[impl] = float((out.double() - want).abs().max())
        if dtype == torch.float32:
            claim(errs[impl] < FP32_ATOL,
                  f"{name} {impl}: max|err| {errs[impl]:.2e} >= "
                  f"{FP32_ATOL}")
        else:
            claim(torch.allclose(out.double(), want, rtol=BF16_TOL,
                                 atol=BF16_TOL),
                  f"{name} {impl}: max|err| {errs[impl]:.2e} beyond "
                  f"rtol = atol = {BF16_TOL}")
    timed(device, lambda: sdpa(q, ke, ve, attn_mask=mask))
    _, lib = timed(device, lambda: sdpa(q, ke, ve, attn_mask=mask), reps)
    print(f"== flash prefill parity: {name} ==")
    for impl in impls:
        print(f"{impl:>8}: max|err| {errs[impl]:.2e}   "
              f"{walls[impl] * 1e6:10.1f} us/call")
    print(f"    SDPA (library, masked): {lib * 1e6:10.1f} us/call")
    return {"shape": dict(b=b, h=h, kvh=kvh, sq=sq, sk=sk, dh=dh,
                          q_offset=q_offset, kv_len=list(kv_len),
                          dtype=str(dtype).replace("torch.", "")),
            "impl_us": {n: t * 1e6 for n, t in walls.items()},
            "parity_max_err": errs, "library_us": lib * 1e6}


def autotune_half(csv: list, sh: Dict[str, int], smoke: bool, device,
                  session=None) -> Dict:
    """The (bq, bk) sweep at ``sh`` in fp32, cold and then on a fresh
    session over the same cache (which must time nothing); without a
    ``session``, one from :func:`tune_session`."""
    import time

    from repro_torch.core.artifact_cache import ArtifactCache
    from repro_torch.core.session import ProfileSession
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import FLASH_PAIRS
    if session is None:
        with tune_session() as session:
            return autotune_half(csv, sh, smoke, device, session)
    cands = ((64, 32), (32, 32)) if smoke else FLASH_PAIRS[torch.float32]
    kw = dict(sh, dtype=torch.float32, causal=True, backend=device.type,
              candidates=cands)
    t0 = time.perf_counter()
    rec = registry.autotune("attention", session, **kw)
    t_cold = time.perf_counter() - t0
    warm = ProfileSession(cache=ArtifactCache(
        session.cache.root, enabled=session.cache.enabled))
    t0 = time.perf_counter()
    registry.autotune("attention", warm, **kw)
    t_warm = time.perf_counter() - t0
    print("== (bq, bk) autotune over ProfileSession ==")
    for (bq, bk), score in sorted(rec.scores.items(), key=lambda kv: kv[1]):
        mark = " <- chosen" if (bq, bk) == tuple(rec.choice) else ""
        print(f"  bq={bq:<4d} bk={bk:<4d} {score * 1e6:9.3f} us{mark}")
    print(f"cold sweep: {rec.lowerings} timed probes, {t_cold:.2f}s; "
          f"warm rerun: {warm.lowerings} timed probes, {t_warm:.2f}s")
    if session.cache.enabled:
        claim(warm.lowerings == 0,
              f"warm autotune re-timed {warm.lowerings} candidates")
    csv.append(("flash_autotune_warm_s", t_warm * 1e6,
                f"lowerings_warm={warm.lowerings},"
                f"lowerings_cold={rec.lowerings}"))
    return {"bq": rec.choice[0], "bk": rec.choice[1], "key": rec.key,
            "score_us": rec.score_s * 1e6,
            "lowerings_cold": rec.lowerings,
            "lowerings_warm": warm.lowerings,
            "candidates": {f"{bq}x{bk}": sc
                           for (bq, bk), sc in rec.scores.items()}}


def run(csv: list, smoke: bool = False, device="cuda",
        tune: bool = False) -> Dict:
    device = torch.device(device)
    sh = shapes(smoke)
    b, sq, sk = sh["b"], sh["sq"], sh["sk"]
    kv_len = np.random.default_rng(1).integers(sk // 2, sk + 1,
                                               size=b).tolist()
    reps = 2 if smoke else 3
    res = _case("sq != sk causal offset + ragged KV, fp32", **sh,
                kv_len=kv_len, q_offset=sk - sq, dtype=torch.float32,
                device=device, reps=reps, seed=0)
    s = max(QWEN2_PROMPTS)
    qwen2 = _case("qwen2-0.5b prefill, bf16", b=len(QWEN2_PROMPTS), h=14,
                  kvh=2, sq=s, sk=s, dh=64, kv_len=QWEN2_PROMPTS,
                  q_offset=0, dtype=torch.bfloat16, device=device,
                  reps=reps, seed=1)
    for tag, r in (("", res), ("qwen2_", qwen2)):
        csv.append((f"flash_prefill_{tag}kernel", r["impl_us"]["flash"],
                    f"max_err={r['parity_max_err']['flash']:.1e},"
                    f"library_us={r['library_us']:.1f}"))
        csv.append((f"flash_prefill_{tag}plain", r["impl_us"]["plain"],
                    f"max_err={r['parity_max_err']['plain']:.1e}"))
    out = dict(res, qwen2=qwen2)
    if tune:
        out["autotune"] = autotune_half(csv, sh, smoke, device)
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI scale: the JAX bench's smoke shape, few reps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the summary here")
    ap.add_argument("--tune", action="store_true",
                    help="also run the (bq, bk) autotune half")
    args = ap.parse_args(argv)
    device = setup_device(args.device)
    print(f"[bench_flash_prefill] device {device}: {card_line(device)}")
    csv: list = []
    summary = run(csv, smoke=args.smoke, device=device, tune=args.tune)
    return finish("bench_flash_prefill", csv, summary, args, device)


if __name__ == "__main__":
    raise SystemExit(main())
