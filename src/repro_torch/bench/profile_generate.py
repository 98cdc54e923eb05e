"""Where the time of one ``Engine.generate`` call goes, on one CUDA card.

    python -m repro_torch.bench.profile_generate [--arch qwen2-0.5b]
        [--page-size 16] [--json out.json]

Builds ``--arch`` at full width and depth (bf16, random weights from seed
0) and serves its ``generate`` path of ``chip_smoke.py``, 32 greedy tokens
per prompt: for qwen2-0.5b 8 ragged prompts of 512, 384, 301, 256, 129,
64, 17 and 1 tokens with a paged (``--page-size 16``, the default) or
dense (``--page-size 0``) KV cache; for zamba2-1.2b 8 prompts of 512
tokens with dense KV (the hybrid family has no pages).  It warms the
engine up, then:

* times ``generate`` on the host clock, ending in ``torch.cuda.synchronize``
  (the whole call, and prefill plus one token alone);
* runs the same call under ``torch.profiler`` and sums the device time of
  every CUDA kernel: the device's busy share of the call's wall time, and
  the kernels that take most of it;
* profiles prefill plus one token alone the same way, and lists the device
  time and launches of the port's own kernels in both calls.

Prints one JSON object (also written to ``--json`` when given).  Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _device_time_us(avg) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, attr):
            return float(getattr(avg, attr))
    raise AttributeError("profiler averages carry no device time")


#: prompt lengths per arch: ragged for an attention-cache family, equal
#: for a recurrent one (its prefill cannot mask pads)
PROMPT_LENS = {"qwen2-0.5b": (512, 384, 301, 256, 129, 64, 17, 1),
               "zamba2-1.2b": (512,) * 8}
MAX_NEW = 32
#: the port's kernels by the names of their ``__global__`` functions
#: (the SSD scan: the bf16 route's three passes, the fp32 route's kernel)
PORT_KERNELS = ("flash_mma_kernel", "flash_fwd_kernel",
                "paged_decode_kernel", "paged_decode_q8_kernel",
                "argmax_kernel", "ssd_local_states_kernel",
                "ssd_state_pass_kernel", "ssd_outputs_kernel",
                "ssd_scan_kernel")


def _profiled(fn):
    """Run ``fn`` under ``torch.profiler``: (wall ms, the CUDA kernels'
    averages with device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an op's own entry repeats the device time of the
    # kernels it launched
    return wall_ms, [a for a in prof.key_averages()
                     if a.device_type == torch.autograd.DeviceType.CUDA
                     and _device_time_us(a) > 0]


def _port_kernels(avgs) -> dict:
    out = {}
    for a in avgs:
        for name in PORT_KERNELS:
            if f"{name}<" in a.key or f"{name}(" in a.key:
                k = out.setdefault(name, {"calls": 0, "device_ms": 0.0})
                k["calls"] += a.count
                k["device_ms"] += _device_time_us(a) / 1e3
    return out


def profile(arch: str, page_size: int) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    _build.build_all()
    cfg = get_arch(arch).config
    max_new = MAX_NEW
    lm = LM(cfg, torch.bfloat16).init(
        torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in PROMPT_LENS[arch]]
    eng = Engine(lm, ServeConfig(page_size=page_size, max_seq=1024))

    def timed(n_new: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=n_new)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    timed(max_new)                                    # warm-up
    gen_ms = [timed(max_new) for _ in range(3)]
    prefill_ms = [timed(1) for _ in range(3)]

    wall_ms, avgs = _profiled(
        lambda: eng.generate(prompts, max_new_tokens=max_new))
    busy_ms = sum(_device_time_us(a) for a in avgs) / 1e3
    pre_wall_ms, pre_avgs = _profiled(
        lambda: eng.generate(prompts, max_new_tokens=1))
    top = sorted(avgs, key=_device_time_us, reverse=True)[:10]
    med_gen, med_pre = float(np.median(gen_ms)), float(np.median(prefill_ms))
    tokens = len(prompts) * (max_new - 1)
    return {
        "arch": arch, "page_size": page_size, "max_new": max_new,
        "prompt_lens": list(PROMPT_LENS[arch]),
        "generate_ms": gen_ms, "prefill_plus_1_ms": prefill_ms,
        "decode_tokens_per_s": tokens / max(med_gen - med_pre, 1e-9) * 1e3,
        "decode_step_ms": (med_gen - med_pre) / max(max_new - 1, 1),
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels": [{"name": a.key[:90], "calls": a.count,
                         "device_ms": _device_time_us(a) / 1e3}
                        for a in top],
        "port_kernels": _port_kernels(avgs),
        "prefill_plus_1_profiled_wall_ms": pre_wall_ms,
        "prefill_plus_1_device_busy_ms":
            sum(_device_time_us(a) for a in pre_avgs) / 1e3,
        "prefill_plus_1_port_kernels": _port_kernels(pre_avgs),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=sorted(PROMPT_LENS))
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV page size (default: 16 for qwen2-0.5b, 0 = "
                         "dense for zamba2-1.2b)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    page_size = args.page_size
    if page_size is None:
        page_size = 16 if args.arch == "qwen2-0.5b" else 0
    if not torch.cuda.is_available():
        print("profile_generate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    res = profile(args.arch, page_size)
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
