"""Serve a small model with batched requests on the PyTorch port: prefill
-> KV-cache decode -> batch scheduler, with the kernel registry picking
(or pinned to) the attention implementations.

The port's counterpart of ``examples/serve_batched.py``:

    PYTHONPATH=src python examples/serve_batched_torch.py              # card
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

On the card the unpinned engine prefills through the flash kernel and
decodes through argmax; the pinned one (``impls={"attention":
"torch_flash"}``, the counterpart of the reference's ``jnp_flash``) runs
the flash kernel's plain PyTorch version.  The weights are random, from
a ``torch.Generator`` seeded with 0.
"""

import argparse
import time

import torch

from repro_torch.kernels import registry
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                      ServeConfig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    cfg = LMConfig(name="serve-demo", family="dense", vocab=2048,
                   d_model=256, n_layers=4, num_heads=8, num_kv_heads=4,
                   d_ff=1024)
    # fp32: greedy argmax ties are then identical across softmax
    # algorithms, so switching kernel impls cannot change the tokens
    lm = LM(cfg, torch.float32, args.device)
    lm.init(torch.Generator(device=lm.device).manual_seed(0))
    # ServeConfig.impls pins kernel impls per registry family for every
    # call the engine makes (the same ladder REPRO_IMPL and
    # registry.use_impl drive); omitted families keep the heuristics
    engine = Engine(lm, ServeConfig(
        max_seq=128, batch_slots=4, temperature=0.0,
        impls={"attention": "torch_flash"}), device=lm.device)
    picked = registry.select("attention", sq=128, sk=128, dh=32,
                             backend=lm.device.type)
    print(f"attention unpinned would pick {picked!r} on "
          f"{lm.device.type}; this engine pins {engine.cfg.impls!r}\n")

    # -- direct batched generate (one host sync) --------------------------
    # ragged prompts are exact: per-row masks keep pads out of attention
    prompts = [[1, 2, 3], [100, 200], [5, 6, 7, 8, 9]]
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=16)
    dt = time.perf_counter() - t0
    for p, o in zip(prompts, outs):
        print(f"prompt {p} -> {o}")
    total_tokens = sum(len(o) for o in outs)
    print(f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s incl. kernel builds, "
          f"{lm.device.type}) — {engine.host_syncs} host sync(s) total")

    # the same pin is available ad hoc: every call inside this block
    # dispatches the forced impls (thread-local, nestable)
    with registry.use_impl(attention="full"):
        outs_full = Engine(lm, ServeConfig(max_seq=128),
                           device=lm.device).generate(prompts,
                                                      max_new_tokens=16)
    assert outs_full == outs, "fp32 greedy tokens are impl-independent"
    print("use_impl(attention='full') reproduced the same tokens")
    # unpinned: the registry's own choice (the flash kernel on the card)
    outs_auto = Engine(lm, ServeConfig(max_seq=128),
                       device=lm.device).generate(prompts, max_new_tokens=16)
    assert outs_auto == outs, "fp32 greedy tokens are impl-independent"
    print(f"the unpinned engine ({picked!r}) reproduced the same tokens\n")

    # -- continuous batching over more requests than slots ----------------
    sched = BatchScheduler(engine)
    for rid in range(10):
        sched.submit(Request(rid=rid, prompt=[rid + 1, rid + 2],
                             max_new_tokens=8))
    done = sched.run()
    print(f"scheduler finished {len(done)} requests "
          f"(batch_slots={engine.cfg.batch_slots}, "
          f"segments={sched.metrics['segments']:.0f}, "
          f"admissions={sched.metrics['admissions']:.0f})")
    for rid in sorted(done)[:3]:
        ttft = done[rid].ttft
        print(f"  request {rid}: {done[rid].generated} "
              f"(ttft {ttft * 1e3:.0f} ms)" if ttft else
              f"  request {rid}: {done[rid].generated}")
    return outs, {rid: list(r.generated) for rid, r in done.items()}


if __name__ == "__main__":
    main()
