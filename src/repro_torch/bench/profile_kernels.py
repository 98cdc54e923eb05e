"""Device-only and host time of every kernel of the port, on one card.

    python -m repro_torch.bench.profile_kernels [--json out.json]
    PYTHONPATH=<other tree>/src \
        python src/repro_torch/bench/profile_kernels.py --only paged_host

Runs the flash kernel (#1) at qwen2-0.5b's prefill (q [8,14,512,64], the
8 ragged prompts of ``chip_smoke.py`` phase 3 as ``kv_valid``, causal) in
bf16 and fp32 beside SDPA with the same boolean mask (``sdpa_*`` rows),
argmax (#4) at b = 8 over qwen2's 151936 logits in bf16 and fp32 beside
``torch.argmax`` (``torch_argmax_*`` rows), and
the int8 paged decode kernel (#3) and the fp paged decode kernel
(#2) at ``chip_smoke.py`` phase 3's main shape (q4 [8,2,7,64] bf16,
pages of 16 tokens, lengths prompt+16 for prompts 512..1, the page table
as ``plan_table`` lays it out) and the same q8 call at the scheduler's
table width (64 pages a row), the STREAM triad (#6) at N = 2^27 in fp32
and bf16 beside ``torch.add(b, c, alpha=2.5, out=a)``, and Jacobi-7 (#7)
at 512^3 fp32 with its default tile, one T = 4 launch and one naive
(T = 1) sweep, and the SSD scan (#5) at zamba2's generate call
([8,512,64,64,64], q and k broadcast over heads, a carried state, chunk
256) in bf16 and fp32, at the scheduler's one-row admission (B = 1, S =
512) and at mLSTM's dk = dv = 512 (B = 1, 4 heads, S = 512, normalize) in
bf16.  For each call it reports:

* ``device_us``: device time a launch under ``torch.profiler``, 100
  launches with the 50 MB L2 flushed before each (the flush kernel is
  left out of the sum; :func:`repro_torch.core.devtime.
  device_us_per_call`, the reader ``ProfileSession.measure`` uses; where
  a profiler session drops kernel records it times the calls between CUDA
  events, and ``device_timers`` says which timer each reading took);
* ``device_us_warm``: the same, launches back to back (L2 warm);
* ``timer_ms``: ``chip_smoke.py``'s ``Timer`` reading (median of 25
  launches between CUDA events, the L2 flushed before each), which counts
  a call's host enqueue where it outlasts the flush;
* ``host_us``: host microseconds a call takes to enqueue its work;
* ``by_kernel`` (SSD rows): device us a call in each ``__global__``
  function the call ran (L2 flushed), so the bf16 route's three passes
  and the fp32 route's kernel show apart;

and for the triad in each dtype, ``turns`` pairs of ``Timer`` readings,
the kernel's and then ``torch.add``'s, so the two are compared in
alternation on one card: the median ratio and how many pairs the kernel
won (``--turns``, default 8).  ``paged_host`` holds the host us of the
bf16 fp paged call three ways, each the median of 5 x 200 calls: the
direct wrapper, ``registry.run`` and ``registry.run`` inside
``registry.env_snapshot`` (the engine's path).

The second form runs this file against another tree's ``repro_torch``
(the parent commit unpacked with ``git archive``), so two versions are
compared in one call on one card; ``--only paged_host`` runs just that
row (no device-time reader, which older trees lack).  ``--only
head_dims`` runs the rows of stablelm-3b's head dim instead: #1 in bf16
and fp32 at q [8,32,512,80] (the same ragged prompts) beside SDPA and
beside the same call at Dh 64, and #2 / #3 at 8 rows of 32 kv heads, G
= 1, Dh 80 and 64, and at mistral-large-123b's 8 kv heads, G = 12, Dh
128 (``flash_prefill_h32_dh*``, ``sdpa_prefill_h32_dh80_*``,
``paged_decode[_q8]_kvh*`` rows).  ``--only vlm_encdec`` runs the vlm and
encdec paths' shapes (:func:`vlm_encdec`).  Prints one JSON
object; needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.bench.profile_generate import _device_time_us

#: qwen2-0.5b's prefill: phase 3's 8 ragged prompts, 14 heads over 2 of 64
FLASH_SHAPE = (8, 14, 2, 512, 64)
ARGMAX_SHAPE = (8, 151936)

PROMPT_LENS = (512, 384, 301, 256, 129, 64, 17, 1)
DECODED = 16                 # phase 3's lengths: prompt + 16 tokens
EXTRA = 16                   # table room past the lengths (32 new - 16)
PAGE_SIZE = 16
SCHED_WIDTH = 64             # max_seq 1024 over 16-token pages
TRIAD_N = 1 << 27
STENCIL = (512, 512, 512)
FLUSH_BYTES = 64 << 20
#: the SSD scan's ``__global__`` functions: the bf16 route's three passes
#: and the fp32 route's kernel
SSD_KERNELS = ("ssd_local_states_kernel", "ssd_state_pass_kernel",
               "ssd_outputs_kernel", "ssd_scan_kernel")
#: (b, s, h, dk, dv, dtype, normalize) of the SSD rows
SSD_SHAPES = {
    "ssd_scan_generate_bf16": (8, 512, 64, 64, 64, torch.bfloat16, False),
    "ssd_scan_generate_fp32": (8, 512, 64, 64, 64, torch.float32, False),
    "ssd_scan_admission_bf16": (1, 512, 64, 64, 64, torch.bfloat16, False),
    "ssd_scan_mlstm_bf16": (1, 512, 4, 512, 512, torch.bfloat16, True),
}


class Probe:
    def __init__(self, dev):
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def timer_ms(self, fn, reps: int = 25) -> float:
        """``chip_smoke.py``'s ``Timer.ms``, unchanged."""
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

    def device_us(self, fn, flush: bool, n: int = 100):
        """``(us, timer)``: device time a call, every CUDA kernel the
        calls launched, the flush's fill kernel left out, over ``n``
        calls (``timer`` "events" where the profiler dropped kernels)."""
        from repro_torch.core.devtime import device_us_per_call
        return device_us_per_call(fn, n, self.flush if flush else None)

    @staticmethod
    def host_us(fn, n: int = 200) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    def all(self, fn) -> dict:
        cold, cold_timer = self.device_us(fn, True)
        warm, warm_timer = self.device_us(fn, False)
        return dict(device_us=cold, device_us_warm=warm,
                    device_timers=[cold_timer, warm_timer],
                    timer_ms=self.timer_ms(fn), host_us=self.host_us(fn))


def device_us_by_kernel(fn, names, n: int = 5, flush=None) -> dict:
    """Device microseconds a call of ``fn`` spends in each ``__global__``
    function of ``names`` that it launches, under ``torch.profiler`` over
    ``n`` calls (zeroing ``flush`` before each, when given); a name it
    never launches is absent."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for a in prof.key_averages():
        if a.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in names:
            if f"{name}<" in a.key or f"{name}(" in a.key:
                out[name] = out.get(name, 0.0) + _device_time_us(a) / n
    return out


def ssd_inputs(dev, b, s, h, dk, dv, dtype, normalize, seed: int = 5):
    """ssd_scan arguments in the model layout: q, k of one head broadcast
    over ``h`` (Mamba2's single group; |.| for ``normalize``, mLSTM-like),
    gates -softplus(N(0,1)), and a carried fp32 state."""
    rng = np.random.default_rng(seed)

    def qk():
        x = rng.standard_normal((b, s, 1, dk), np.float32) * dk ** -0.25
        x = np.abs(x) if normalize else x
        return torch.from_numpy(x).to(dev, dtype).expand(b, s, h, dk)

    def gate():
        return torch.from_numpy(-np.logaddexp(
            rng.standard_normal((b, s, h)), 0.0).astype(np.float32)).to(dev)

    q, k = qk(), qk()
    v = torch.from_numpy(rng.standard_normal((b, s, h, dv), np.float32)
                         ).to(dev, dtype)
    st = (torch.from_numpy(rng.standard_normal((b, h, dk, dv), np.float32)
                           ).to(dev),
          torch.from_numpy(np.abs(rng.standard_normal((b, h, dk),
                                                      np.float32))).to(dev))
    return (q, k, v, gate(), gate()), st


def paged_inputs(dev, q8: bool, width=None, seed: int = 4,
                 heads=(2, 7, 64), prompts=PROMPT_LENS):
    """Phase 3's main decode call: row-major page table (ids 1..), room
    for EXTRA more tokens a row, optionally widened to ``width``;
    ``heads`` is (KVH, G, Dh), qwen2-0.5b's by default, and the lengths
    are ``prompts`` + DECODED."""
    rng = np.random.default_rng(seed)
    lens = [n + DECODED for n in prompts]
    (kvh, g, dh), ps = heads, PAGE_SIZE
    per_row = [-(-(n + EXTRA) // ps) for n in lens]
    np_w = max(width or 0, max(per_row))
    num_pages = -(-(1 + sum(per_row)) // 16) * 16
    table = np.zeros((len(lens), np_w), np.int32)
    nxt = 1
    for i, npg in enumerate(per_row):
        table[i, :npg] = np.arange(nxt, nxt + npg)
        nxt += npg

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, torch.bfloat16)

    def codes():
        return torch.from_numpy(rng.integers(
            -127, 128, (num_pages, ps, kvh, dh)).astype(np.int8)).to(dev)

    def scales():
        return torch.from_numpy(rng.uniform(
            0.005, 0.05, (num_pages, ps)).astype(np.float32)).to(dev)

    b = len(lens)
    pt = torch.from_numpy(table).to(dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    if q8:
        return (rnd(b, kvh, g, dh), codes(), codes(), scales(), scales(), pt,
                ln, rnd(b, kvh, dh), rnd(b, kvh, dh))
    return (rnd(b, kvh, g, dh), rnd(num_pages, ps, kvh, dh),
            rnd(num_pages, ps, kvh, dh), pt, ln, rnd(b, kvh, dh),
            rnd(b, kvh, dh))


def in_turns(probe: Probe, fn, ref, turns: int) -> dict:
    """``turns`` pairs of Timer readings, ``fn`` then ``ref``."""
    pairs = [(probe.timer_ms(fn), probe.timer_ms(ref)) for _ in range(turns)]
    return dict(ms=statistics.median(p[0] for p in pairs),
                ref_ms=statistics.median(p[1] for p in pairs),
                ratio=statistics.median(p[0] / p[1] for p in pairs),
                wins=sum(p[0] <= p[1] for p in pairs), turns=turns)


def flash_inputs(dev, dtype, seed: int = 0, shape=FLASH_SHAPE,
                 lens=PROMPT_LENS, causal: bool = True):
    """Phase 3's qwen2 prefill call (or ``shape``'s (B, H, KVH, S, Dh)
    over rows of ``lens`` tokens): q, k, v [B,H,S,Dh], the ragged
    ``kv_valid`` and SDPA's equivalent boolean mask and expanded K/V."""
    b, h, kvh, s, dh = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(n):
        return torch.randn((b, n, s, dh), generator=gen, device=dev).to(dtype)

    q, k, v = rnd(h), rnd(kvh), rnd(kvh)
    kvv = torch.tensor(lens, dtype=torch.int32, device=dev)
    kpos = torch.arange(s, device=dev)
    mask = ((kpos[None, :] <= kpos[:, None] if causal
             else torch.ones((s, s), dtype=torch.bool, device=dev))[None, None]
            & (kpos[None, None, None, :] < kvv[:, None, None, None]))
    g = h // kvh
    return (q, k, v, kvv), (k.repeat_interleave(g, 1),
                            v.repeat_interleave(g, 1), mask)


def paged_host(dev, n_runs: int = 5) -> dict:
    """Host us of the bf16 fp paged call: the wrapper, ``registry.run``,
    and ``registry.run`` inside ``env_snapshot`` (medians of ``n_runs``
    x 200 calls, interleaved)."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.paged_decode import \
        paged_decode_attention_grouped
    fp = paged_inputs(dev, q8=False)
    runs = {"direct": [], "registry_run": [], "registry_run_snapshot": []}
    for _ in range(n_runs):
        runs["direct"].append(Probe.host_us(
            lambda: paged_decode_attention_grouped(*fp)))
        runs["registry_run"].append(Probe.host_us(
            lambda: registry.run("paged_decode", *fp)))
        with registry.env_snapshot():
            runs["registry_run_snapshot"].append(Probe.host_us(
                lambda: registry.run("paged_decode", *fp)))
    out = {k: statistics.median(v) for k, v in runs.items()}
    out["runs"] = runs
    return out


def flash_argmax(dev, probe: Probe, out: dict) -> None:
    """The flash (#1) and argmax (#4) rows and their library calls'."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.sampling import block_argmax
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        (q, k, v, kvv), (ke, ve, mask) = flash_inputs(dev, dtype)
        out[f"flash_prefill_{tag}"] = probe.all(
            lambda: flash_attention_bhsd(q, k, v, causal=True, kv_valid=kvv))
        out[f"sdpa_prefill_{tag}"] = probe.all(
            lambda: sdpa(q, ke, ve, attn_mask=mask))
        gen = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(ARGMAX_SHAPE, generator=gen, device=dev).to(dtype)
        out[f"argmax_{tag}"] = probe.all(lambda: block_argmax(x))
        out[f"torch_argmax_{tag}"] = probe.all(
            lambda: torch.argmax(x, dim=-1))
        del q, k, v, kvv, ke, ve, mask, x


def head_dims(dev, probe: Probe, out: dict) -> None:
    """#1, #2 and #3 at stablelm-3b's head dim 80 (32 heads, G = 1) beside
    the same shapes at Dh 64, SDPA at stablelm's prefill, and the paged
    kernels at mistral-large-123b's G = 12, Dh 128."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.paged_decode import (
        paged_decode_attention_grouped, paged_decode_attention_q8_grouped)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dh in (80, 64):
        shape = (8, 32, 32, 512, dh)
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            (q, k, v, kvv), (ke, ve, mask) = flash_inputs(dev, dtype,
                                                          shape=shape)
            out[f"flash_prefill_h32_dh{dh}_{tag}"] = probe.all(
                lambda: flash_attention_bhsd(q, k, v, causal=True,
                                             kv_valid=kvv))
            if dh == 80:
                out[f"sdpa_prefill_h32_dh{dh}_{tag}"] = probe.all(
                    lambda: sdpa(q, ke, ve, attn_mask=mask))
            del q, k, v, kvv, ke, ve, mask
    for tag, heads in (("kvh32_g1_dh80", (32, 1, 80)),
                       ("kvh32_g1_dh64", (32, 1, 64)),
                       ("kvh8_g12_dh128", (8, 12, 128))):
        fp = paged_inputs(dev, q8=False, heads=heads)
        out[f"paged_decode_{tag}"] = probe.all(
            lambda: paged_decode_attention_grouped(*fp))
        q8 = paged_inputs(dev, q8=True, heads=heads)
        out[f"paged_decode_q8_{tag}"] = probe.all(
            lambda: paged_decode_attention_q8_grouped(*q8))
        del fp, q8


def vlm_encdec(dev, probe: Probe, out: dict) -> None:
    """``chip_smoke.py`` phase 22's kernel shapes: #1 at qwen2-vl-7b's
    prefill (q [8,28,512,128], G 7, its 8 prompts of 512-288 tokens) and
    at seamless-m4t-medium's encoder (q [8,16,64,64], not causal) and
    decoder prefill ([8,16,256,64], causal), each beside SDPA with the
    same mask; #2 and #3 at qwen2-vl's decode heads (KVH 4, G 7, Dh 128)
    over its prompts + DECODED; #4 over seamless's 8 x 256206 logits
    beside ``torch.argmax``."""
    from repro_torch.bench.profile_generate import VLM_LENS
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.paged_decode import (
        paged_decode_attention_grouped, paged_decode_attention_q8_grouped)
    from repro_torch.kernels.sampling import block_argmax
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash = (("vlm", (8, 28, 4, 512, 128), VLM_LENS, True),
             ("seamless_encoder", (8, 16, 16, 64, 64), (64,) * 8, False),
             ("seamless_decoder", (8, 16, 16, 256, 64), (256,) * 8, True))
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for name, shape, lens, causal in flash:
            (q, k, v, kvv), (ke, ve, mask) = flash_inputs(
                dev, dtype, shape=shape, lens=lens, causal=causal)
            out[f"flash_prefill_{name}_{tag}"] = probe.all(
                lambda: flash_attention_bhsd(q, k, v, causal=causal,
                                             kv_valid=kvv))
            out[f"sdpa_prefill_{name}_{tag}"] = probe.all(
                lambda: sdpa(q, ke, ve, attn_mask=mask))
            del q, k, v, kvv, ke, ve, mask
        gen = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn((8, 256206), generator=gen, device=dev).to(dtype)
        out[f"argmax_v256206_{tag}"] = probe.all(lambda: block_argmax(x))
        out[f"torch_argmax_v256206_{tag}"] = probe.all(
            lambda: torch.argmax(x, dim=-1))
        del x
    fp = paged_inputs(dev, q8=False, heads=(4, 7, 128), prompts=VLM_LENS)
    out["paged_decode_kvh4_g7_dh128"] = probe.all(
        lambda: paged_decode_attention_grouped(*fp))
    q8 = paged_inputs(dev, q8=True, heads=(4, 7, 128), prompts=VLM_LENS)
    out["paged_decode_q8_kvh4_g7_dh128"] = probe.all(
        lambda: paged_decode_attention_q8_grouped(*q8))


def profile(dev, turns: int, only=None) -> dict:
    if only == "paged_host":
        return {"paged_host": paged_host(dev)}
    from repro_torch.kernels import _build
    from repro_torch.kernels.jacobi7 import jacobi7_naive, jacobi7_wavefront
    from repro_torch.kernels.paged_decode import (
        paged_decode_attention_grouped, paged_decode_attention_q8_grouped)
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.stream_triad import stream_triad
    _build.build_all()
    probe = Probe(dev)
    out = {}
    if only == "head_dims":
        head_dims(dev, probe, out)
        return out
    if only == "vlm_encdec":
        vlm_encdec(dev, probe, out)
        return out
    flash_argmax(dev, probe, out)
    if only == "flash_argmax":
        return out
    out["paged_host"] = paged_host(dev)
    for name, (b, s, h, dk, dv, dtype, norm) in SSD_SHAPES.items():
        args, st = ssd_inputs(dev, b, s, h, dk, dv, dtype, norm)

        def call():
            return ssd_scan(*args, chunk=256, normalize=norm,
                            initial_state=st)

        out[name] = probe.all(call)
        out[name]["by_kernel"] = device_us_by_kernel(call, SSD_KERNELS, 20,
                                                     flush=probe.flush)
        del args, st
    args = paged_inputs(dev, q8=True)
    out["paged_decode_q8"] = probe.all(
        lambda: paged_decode_attention_q8_grouped(*args))
    wide = paged_inputs(dev, q8=True, width=SCHED_WIDTH)
    out["paged_decode_q8_np64"] = probe.all(
        lambda: paged_decode_attention_q8_grouped(*wide))
    fp = paged_inputs(dev, q8=False)
    out["paged_decode"] = probe.all(
        lambda: paged_decode_attention_grouped(*fp))
    del args, wide, fp
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(STENCIL, generator=gen, device=dev)
    out["jacobi7_T4"] = probe.all(lambda: jacobi7_wavefront(x, sweeps=4))
    out["jacobi7_T1"] = probe.all(lambda: jacobi7_naive(x))
    del x
    gen = torch.Generator(device=dev).manual_seed(6)
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        b = torch.randn(TRIAD_N, generator=gen, device=dev).to(dtype)
        c = torch.randn(TRIAD_N, generator=gen, device=dev).to(dtype)
        a = torch.empty_like(b)
        out[f"stream_triad_{tag}"] = probe.all(lambda: stream_triad(b, c))
        out[f"torch_add_{tag}"] = probe.all(
            lambda: torch.add(b, c, alpha=2.5, out=a))
        out[f"stream_triad_{tag}_vs_torch_add"] = in_turns(
            probe, lambda: stream_triad(b, c),
            lambda: torch.add(b, c, alpha=2.5, out=a), turns)
        del a, b, c
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--only", default=None,
                    choices=["paged_host", "flash_argmax", "head_dims",
                             "vlm_encdec"],
                    help="run only these rows (paged_host: the host us of "
                         "a paged call three ways; flash_argmax: #1 and "
                         "#4 beside their library calls; head_dims: #1, "
                         "#2 and #3 at Dh 80 beside Dh 64, and the paged "
                         "kernels at G 12, Dh 128; vlm_encdec: #1-#4 at "
                         "qwen2-vl-7b's and seamless-m4t-medium's shapes)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    import repro_torch
    res = dict(kernels=profile(torch.device("cuda", 0), args.turns,
                               args.only),
               package=str(repro_torch.__file__),
               device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               torch=torch.__version__, cuda=torch.version.cuda)
    text = json.dumps(res)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
