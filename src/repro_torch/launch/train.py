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

    # the production mesh, one rank a card (256 ranks; 512 for multi):
    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \\
        --arch qwen2-moe-a2.7b --mesh single --pin ring --steps 1000

The reference's flags (``--arch``, ``--steps``, ``--batch``, ``--seq``,
``--accum``, ``--lr``, ``--warmup``, ``--smoke-dims``, ``--scale``,
``--ckpt-dir``, ``--ckpt-every``, ``--compress-grads``, ``--remat``),
and the port's serve launcher's ``--device``, ``--layers N`` and
``--dtype`` (the compute dtype; parameters are fp32 masters either way).
``--mesh single|multi`` builds the production mesh ((16, 16) data x
model, or (2, 16, 16) with pods) over the ``torchrun`` world, ordered by
``--pin`` (``repro_torch.launch.mesh.make_production_mesh``), and trains
sharded: ``Trainer(mesh=, state_shardings=train_state_pspecs(...))``,
``--compress-grads`` sharding the error-feedback residuals too.  A world
of another size exits 2 with the production mesh's message.  Each rank
builds the full model on the CPU as its host copy and keeps its slices
of the state on its card (``cuda:<LOCAL_RANK>``, NCCL; gloo with
``--device cpu``); only the mesh's first rank prints.  Without
``--mesh``, ``--pin`` is unused, as in the reference.
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
                    help="train on the production mesh over the torchrun "
                         "world (256 ranks; 512 for multi)")
    ap.add_argument("--pin", default=None,
                    help="pin strategy ordering the mesh's ranks")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", default="none",
                    help="none | dots | dots_no_batch | full")
    args = ap.parse_args(argv)
    if args.layers is not None and args.layers < 1:
        ap.error(f"--layers must be at least 1, not {args.layers}")

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.features import default_features
    from repro_torch.data import DataConfig
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import Trainer, TrainerConfig, train_state_pspecs

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
    mesh = state_shardings = None
    if args.mesh:
        from repro_torch.launch import mesh as mesh_mod
        mesh_mod.init_process(args.device)
        try:
            mesh = mesh_mod.make_production_mesh(
                multi_pod=args.mesh == "multi", pin_strategy=args.pin)
        except ValueError as e:
            ap.error(str(e))
    lm = LM(cfg, dtype, "cpu" if mesh is not None else args.device,
            features=feats, param_dtype=torch.float32)
    if mesh is not None:
        state_shardings = train_state_pspecs(lm, mesh,
                                             ef=args.compress_grads)
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
                       total_steps=args.steps),
        mesh=mesh, state_shardings=state_shardings)
    if mesh is not None:
        from repro_torch.launch.mesh import mesh_layout
        where = f"the {args.mesh} mesh {dict(zip(*mesh_layout(mesh)))}"
    else:
        where = lm.device
    if trainer.leader:
        print(f"[train] {cfg.name}: {cfg.n_layers} layers, {args.dtype} "
              f"compute, fp32 params, remat={args.remat} on {where}")
    state = trainer.run()
    n = lm.num_params()
    if trainer.leader:
        print(f"[train] finished at step {int(state.step)}; params={n:,}; "
              f"final loss {trainer.history[-1]['loss']:.4f} "
              f"(first {trainer.history[0]['loss']:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
