"""End-to-end training on the PyTorch port: data pipeline -> train
loop -> checkpoints -> perfctr report, then the trained weights
served.  The port's counterpart of ``examples/train_e2e.py``:

    PYTHONPATH=src python examples/train_e2e_torch.py                # card
    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu   # ~13M
    PYTHONPATH=src python examples/train_e2e_torch.py --model 100m

Everything is the production path: the same Trainer, checkpoint store,
straggler detector and PerfCtr that ``repro_torch.launch.train`` uses,
bf16 compute over fp32 masters on the card (fp32 on the host), and a
synthetic token stream.
"""

import argparse
import os
import tempfile

import torch

from repro_torch.core import events
from repro_torch.core.features import default_features
from repro_torch.core.perfctr import PerfCtr
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.lm import LM, LMConfig
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train.step import model_flops
from repro_torch.train.trainer import Trainer, TrainerConfig

MODELS = {
    # ~13M backbone: fits a few-minute CPU run
    "13m": LMConfig(name="demo-13m", family="dense", vocab=2048,
                    d_model=256, n_layers=4, num_heads=8, num_kv_heads=4,
                    d_ff=1024),
    # ~100M: the e2e size (slow on the CPU; same code path)
    "100m": LMConfig(name="demo-100m", family="dense", vocab=32768,
                     d_model=512, n_layers=12, num_heads=8, num_kv_heads=8,
                     d_ff=2048),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="13m", choices=list(MODELS))
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = MODELS[args.model]
    dev = torch.device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    lm = LM(cfg, dtype, dev, features=default_features().with_(
        remat_policy="none"), param_dtype=torch.float32)
    print(f"model {cfg.name}: {lm.num_params()/1e6:.1f}M params on {dev}")

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"repro-torch-{cfg.name}")
    data = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab, seed=0)
    trainer = Trainer(
        lm, data,
        TrainerConfig(total_steps=args.steps, log_every=10,
                      ckpt_every=50, ckpt_dir=ckpt_dir),
        adamw=AdamWConfig(),
        sched=ScheduleConfig(peak_lr=3e-4, warmup_steps=20,
                             total_steps=args.steps))

    # perfctr marker mode over one loss-and-gradient pass (the step minus
    # its update, so the run below starts from the same state): timed on
    # the card, its model FLOPs declared
    state = trainer.init_or_restore()
    batch0 = trainer.batch_at(int(state.step))
    params = list(state.params.values())
    flops = model_flops(lm, args.batch, args.seq)

    def loss_and_grads(batch):
        events.record_ops(flops=flops,
                          arg_bytes=sum(p.numel() * 4 for p in params),
                          out_bytes=sum(p.numel() * 4 for p in params),
                          f32=dtype == torch.float32)
        return torch.autograd.grad(lm.loss(batch)[0], params)

    ctr = PerfCtr(groups=("ROOFLINE",), device=dev)
    with ctr.marker("train_step"):
        ctr.probe(loss_and_grads, batch0, warmup=1, repeats=3)
    print(ctr.report())

    state = trainer.run(state)
    first = trainer.history[0]["loss"]
    last = trainer.history[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {len(trainer.history)} "
          f"steps (ckpts in {ckpt_dir})")
    if len(trainer.history) > 1:
        assert last < first, "training must reduce loss"

    # serve what was trained: the same weights in the compute dtype
    served = LM(cfg, dtype, dev)
    served.load_state_dict({k: p.detach() for k, p in lm.state_dict().items()})
    eng = Engine(served, ServeConfig(max_seq=64, batch_slots=2), device=dev)
    prompts = [trainer.data.batch_at(0)["tokens"][i, :16].tolist()
               for i in range(2)]
    print("greedy continuations:", eng.generate(prompts, max_new_tokens=8))


if __name__ == "__main__":
    main()
