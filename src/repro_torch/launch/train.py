"""End-to-end training launcher.

Port of ``repro/launch/train.py``::

    # on the card (bf16 compute, fp32 masters), full width and depth:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 20 --batch 8 --seq 512 --ckpt-dir build/ckpt

    # on the host, the arch's reduced smoke config:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke-dims --device cpu --steps 30 --batch 8 --seq 64

    # then serve what it trained:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --ckpt-dir build/ckpt

The reference's flags (``--arch``, ``--steps``, ``--batch``, ``--seq``,
``--accum``, ``--lr``, ``--warmup``, ``--smoke-dims``, ``--scale``,
``--ckpt-dir``, ``--ckpt-every``, ``--compress-grads``, ``--remat``),
and the port's serve launcher's ``--device``, ``--layers N`` and
``--dtype`` (the compute dtype; parameters are fp32 masters either way).
``--mesh`` and ``--pin`` shard the run over a device mesh: not ported
yet (ROADMAP.md, item 14b), and refused.
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--smoke-dims", action="store_true",
                    help="use the arch's reduced smoke config (CPU-friendly)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="width multiplier on the smoke config (e.g. 4 for "
                         "a ~100M-class run)")
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="train N layers (default: the config's depth)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                    help="the compute dtype (default bf16); parameters "
                         "and gradients are fp32")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--mesh", choices=["single", "multi"], default=None,
                    help="not ported yet (ROADMAP.md, item 14b)")
    ap.add_argument("--pin", default=None,
                    help="not ported yet (ROADMAP.md, item 14b)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", default="none",
                    help="none | dots | dots_no_batch | full")
    args = ap.parse_args(argv)
    for flag in ("mesh", "pin"):
        if getattr(args, flag) is not None:
            ap.error(f"--{flag} shards the run over a device mesh, which is "
                     f"not ported yet (ROADMAP.md, item 14b: the training "
                     f"half of the mesh); the port trains on one card")
    if args.layers is not None and args.layers < 1:
        ap.error(f"--layers must be at least 1, not {args.layers}")

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.features import default_features
    from repro_torch.data import DataConfig
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import Trainer, TrainerConfig

    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke_dims else spec.config
    if args.smoke_dims and args.scale != 1.0:
        cfg = dataclasses.replace(
            cfg,
            d_model=int(cfg.d_model * args.scale),
            d_ff=int(cfg.d_ff * args.scale),
            n_layers=max(int(cfg.n_layers * args.scale ** 0.5), 2))
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    try:
        feats = default_features().with_(remat_policy=args.remat)
    except ValueError as e:
        ap.error(str(e))
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[args.dtype]
    lm = LM(cfg, dtype, args.device, features=feats,
            param_dtype=torch.float32)
    data_cfg = DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab,
        src_embeds_dim=cfg.d_model if cfg.family == "encdec" else 0,
        src_ratio=cfg.src_ratio,
        patch_embeds=cfg.n_patches if cfg.family == "vlm" else 0,
        d_model=cfg.d_model)
    trainer = Trainer(
        lm, data_cfg,
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, accum_steps=args.accum,
                      log_every=max(args.steps // 30, 1)),
        AdamWConfig(grad_compression="int8_ef" if args.compress_grads
                    else "none"),
        ScheduleConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                       total_steps=args.steps))
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, {args.dtype} "
          f"compute, fp32 params, remat={args.remat} on {lm.device}")
    state = trainer.run()
    n = lm.num_params()
    print(f"[train] finished at step {int(state.step)}; params={n:,}; "
          f"final loss {trainer.history[-1]['loss']:.4f} "
          f"(first {trainer.history[0]['loss']:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
