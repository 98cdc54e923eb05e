"""Speculative decoding on the card: accept rate + tok/s vs target-only.

Counterpart of ``benchmarks/bench_spec.py``, fp32 greedy so every parity
check is exact.  The bench builds its own pair: the target has
``n_layers`` blocks, every block past the first all zeros (its residual
contribution is exactly +0.0, so the target's logits ARE a one-block
computation), and the matched draft is that one block with the target's
embedding, final norm and head; an unrelated draft of the same shape
(its own random weights) gives the low-acceptance leg.  Claims, carried
over (each raises when it fails):

* speculative tokens equal target-only tokens on the high- and the
  low-acceptance leg;
* the matched draft's accept rate is over 0.95;
* the unrelated draft accepts less than the matched one.

The speed bar, the high-acceptance leg at least 1.5x target-only
tokens/s, is recorded under ``bars``; ``main`` exits 1 when it is
missed.  K = 4, pages of 16, 4 ragged prompts.  ``--arch qwen2-0.5b``
builds the same pair at qwen2-0.5b's width and 24 layers (fp32; the
tied embedding scaled by 0.1 in both models, as ``chip_smoke.py``'s
sampled and speculative phases do, since the unscaled random model
echoes its last token whatever the draft).  The JAX bench's ``--draft``
pairing for the low leg is not carried over.

    PYTHONPATH=src python -m repro_torch.bench.bench_spec [--smoke]
        [--arch qwen2-0.5b] [--device cpu] [--json PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bench.common import (bar, card_line, claim, finish,
                                      setup_device, timed)
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.spec import SpecConfig

K = 4
SERVE = ServeConfig(max_seq=256, batch_slots=4, temperature=0.0,
                    page_size=16)


def target_config(smoke: bool, arch: Optional[str] = None) -> LMConfig:
    """The JAX bench's target (``benchmarks/bench_spec.py:40-45``), or
    ``arch``'s full config."""
    if arch is not None:
        from repro_torch.configs import get_arch
        return get_arch(arch).config
    return LMConfig(name="spec-bench-target", family="dense", vocab=256,
                    d_model=64 if smoke else 128,
                    n_layers=6 if smoke else 8,
                    num_heads=8, num_kv_heads=4,
                    d_ff=128 if smoke else 256)


def build(tcfg: LMConfig, device: torch.device, embed_scale: float = 1.0
          ) -> Tuple[LM, LM, LM]:
    """(target with zeroed upper blocks, matched one-block draft,
    unrelated one-block draft), fp32, random weights from seeds 0 and
    123."""
    dcfg = dataclasses.replace(tcfg, name=f"{tcfg.name}-draft", n_layers=1)

    def lm(cfg, seed):
        m = LM(cfg, torch.float32, device).init(
            torch.Generator(device=device).manual_seed(seed))
        m.embed.table.data.mul_(embed_scale)
        return m

    target = lm(tcfg, 0)
    with torch.no_grad():
        for blk in target.blocks[1:]:
            for p in blk.parameters():
                p.zero_()
    hi = LM(dcfg, torch.float32, device)
    hi.load_state_dict({k: v for k, v in target.state_dict().items()
                        if not k.startswith("blocks.")
                        or k.startswith("blocks.0.")})
    return target, hi, lm(dcfg, 123)


def prompts(vocab: int, n: int, max_len: int) -> List[List[int]]:
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, size=int(rng.integers(3, max_len)))
            .tolist() for _ in range(n)]


def _timed_generate(eng: Engine, ps, max_new: int):
    eng.generate(ps, max_new)                    # warm-up
    out, dt = timed(eng.device, lambda: eng.generate(ps, max_new))
    return out, sum(len(t) for t in out) / dt


def run(csv: list, smoke: bool = False, device="cuda",
        arch: Optional[str] = None) -> Dict:
    device = torch.device(device)
    tcfg = target_config(smoke, arch)
    target, draft_hi, draft_lo = build(tcfg, device,
                                       embed_scale=0.1 if arch else 1.0)
    max_new = 48 if smoke else 128
    ps = prompts(tcfg.vocab, 4, 12)
    summary: Dict = {"k": K, "n_layers": tcfg.n_layers, "max_new": max_new,
                     "model": tcfg.name}

    # ---- target-only baseline ----------------------------------------
    ref, base_tok_s = _timed_generate(Engine(target, SERVE, device=device),
                                      ps, max_new)
    print(f"target-only: {base_tok_s:.1f} tok/s "
          f"({tcfg.n_layers}-layer fp32 greedy)")
    summary["target_only"] = {"tok_s": base_tok_s}

    def spec_leg(draft: LM):
        eng = Engine(target, SERVE, device=device, draft_lm=draft,
                     spec=SpecConfig(draft_config=draft.cfg,
                                     num_draft_tokens=K))
        out, tok_s = _timed_generate(eng, ps, max_new)
        return out, tok_s, dict(eng.spec_stats)

    # ---- high acceptance: the matched one-block draft ----------------
    out_hi, hi_tok_s, hi_stats = spec_leg(draft_hi)
    speedup = hi_tok_s / base_tok_s
    print(f"spec high-acceptance: {hi_tok_s:.1f} tok/s = {speedup:.2f}x, "
          f"accept_rate={hi_stats['accept_rate']:.3f} "
          f"({hi_stats['accepted']}/{hi_stats['proposed']}, "
          f"{hi_stats['rounds']} rounds), "
          f"parity: {'OK' if out_hi == ref else 'FAIL'}")
    claim(out_hi == ref, "speculative greedy tokens diverged from "
          "target-only")
    claim(hi_stats["accept_rate"] > 0.95,
          f"the matched draft should accept ~all: {hi_stats['accept_rate']}")
    csv.append(("spec_high_tok_s", 1e6 / hi_tok_s,
                f"speedup={speedup:.2f},"
                f"accept={hi_stats['accept_rate']:.3f}"))
    summary["high"] = {"tok_s": hi_tok_s, "speedup": speedup,
                       "parity": True, **hi_stats}

    # ---- low acceptance: an unrelated draft --------------------------
    out_lo, lo_tok_s, lo_stats = spec_leg(draft_lo)
    print(f"spec low-acceptance: {lo_tok_s:.1f} tok/s = "
          f"{lo_tok_s / base_tok_s:.2f}x, "
          f"accept_rate={lo_stats['accept_rate']:.3f}, "
          f"parity: {'OK' if out_lo == ref else 'FAIL'}")
    claim(out_lo == ref,
          "low-acceptance speculative tokens diverged from target-only")
    claim(lo_stats["accept_rate"] < hi_stats["accept_rate"],
          "the unrelated draft accepted as much as the matched one")
    csv.append(("spec_low_tok_s", 1e6 / lo_tok_s,
                f"accept={lo_stats['accept_rate']:.3f},parity=1"))
    summary["low"] = {"tok_s": lo_tok_s, "speedup": lo_tok_s / base_tok_s,
                      "parity": True, **lo_stats}
    summary["bars"] = {"high_speedup": bar(speedup, 1.5)}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI scale: tiny model, short generations")
    ap.add_argument("--arch", default=None, choices=["qwen2-0.5b"],
                    help="build the pair at this ported config's width")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the summary here")
    args = ap.parse_args(argv)
    device = setup_device(args.device)
    print(f"[bench_spec] device {device}: {card_line(device)}")
    csv: list = []
    summary = run(csv, smoke=args.smoke, device=device, arch=args.arch)
    return finish("bench_spec", csv, summary, args, device)


if __name__ == "__main__":
    raise SystemExit(main())
