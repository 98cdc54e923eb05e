"""The rank side of ``tests/test_torch_train_mesh.py`` and
``tests/test_torch_moe_mesh.py``: what each spawned gloo rank trains or
serves.  A plain module (no test in it, no JAX import), so each spawned
process imports only torch and the port; the tests compute the unsharded
references in their own process from the same seeds."""

import dataclasses

import numpy as np
import torch

#: one SMOKE config a family (qwen2-0.5b's has one kv head, so the dense
#: case is qwen1.5-0.5b's: 4 kv heads, a tied vocab of 256)
ARCHS = {"dense": "qwen1.5-0.5b", "moe": "qwen2-moe-a2.7b",
         "vlm": "qwen2-vl-7b"}
SHAPES = ((1, 2), (2, 1), (2, 2))
#: the divisibility guard on a model axis of 4: 6 experts stay whole on
#: every rank (the shared expert's 64 split, and its 66 not)
GUARDED = {"moe-e6": dict(moe_experts=6),
           "moe-e6-fs66": dict(moe_experts=6, moe_d_ff_shared=66)}
#: the batch: 4 rows of 12 tokens; rows 1 and 2 hold -1 labels
B, S = 4, 12
STEPS = 3
SCHED = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
#: the Trainer's run: synthetic tokens, 8 x 16 a step
TRAIN = dict(batch=8, seq=16, steps=4, ckpt_at=2)
#: the serving config (pages of 8, fp32)
SERVE = dict(max_seq=64, batch_slots=2, admission_chunk=8, page_size=8)
MAX_NEW = 6


def config(fam):
    from repro_torch.configs import get_arch
    if fam in GUARDED:
        return dataclasses.replace(get_arch(ARCHS["moe"]).smoke,
                                   **GUARDED[fam])
    return get_arch(ARCHS[fam]).smoke


def host_lm(fam):
    """The whole model, fp32, drawn from seed 0 on the CPU (equal in
    every process), its embedding scaled by 0.1 so the random model does
    not echo its input."""
    from repro_torch.core.features import default_features
    from repro_torch.models.lm import LM
    lm = LM(config(fam), torch.float32, "cpu",
            features=default_features().with_(remat_policy="none"),
            param_dtype=torch.float32)
    lm.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        lm.embed.table.mul_(0.1)
    return lm


def batch(fam):
    """The global batch: labels are the next tokens, -1 at each row's
    end, and row 1 masks all but 3 positions, row 2 its first 5."""
    cfg = config(fam)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    labels = np.full_like(tokens, -1)
    labels[:, :-1] = tokens[:, 1:]
    labels[1, 3:] = -1
    labels[2, :5] = -1
    out = {"tokens": torch.from_numpy(tokens.astype(np.int32)),
           "labels": torch.from_numpy(labels.astype(np.int32))}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return out


def rank_rows(b, index, size, accum=1):
    """Data rank ``index``'s rows of the global batch ``b`` over ``size``
    ranks: for microbatch i of ``accum``, rows ``(i size + index) n``
    onward (n = B / (accum size)), as ``Trainer`` reads them."""
    n = next(iter(b.values())).shape[0] // (accum * size)
    return {k: torch.cat([v[(i * size + index) * n:(i * size + index + 1) * n]
                          for i in range(accum)]) for k, v in b.items()}


def optim(ef=False):
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    return (AdamWConfig(grad_compression="int8_ef" if ef else "none"),
            ScheduleConfig(**SCHED))


def _numpy(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def sharded_run(fam, mesh, accum=1, ef=False):
    """On a rank of ``mesh``: the first step's loss and whole gradients
    (gathered from the slices; not with ``accum``, whose rows are laid out
    for microbatches), the vocab-parallel cross entropy's largest gap
    from the gathered form's, then ``STEPS`` AdamW steps: their losses
    and grad norms and the whole parameters after them."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM
    from repro_torch.optim import init_opt_state
    from repro_torch.train import step as step_mod
    host = host_lm(fam)
    tp, dp = mesh_mod.model_axis(mesh), mesh_mod.data_axis(mesh)
    lm = LM(host.cfg, torch.float32, "cpu", features=host.features,
            param_dtype=torch.float32, tp=tp, dp=dp).requires_grad_(True)
    adamw, sched = optim(ef)
    specs = step_mod.train_state_pspecs(host, mesh, ef=ef).params
    layout = step_mod.StateLayout(lm, specs, mesh,
                                  dict(host.named_parameters()))
    params = layout.init_params(dict(host.named_parameters()))
    state = step_mod.TrainState(params, init_opt_state(params, adamw),
                                torch.zeros((), dtype=torch.int32))
    rows = rank_rows(batch(fam), dp.index, dp.size, accum)
    layout.gather(state.params)
    with torch.no_grad():
        x = lm._embed(rows["tokens"], rows.get("patch_embeds"))
        local = lm._head(lm._backbone(x, rows)[0], gather=False).float()
        whole = tp.all_gather(local, dim=-1)
        labels = rows["labels"].clamp(min=0).long()
        gathered = (torch.logsumexp(whole, -1)
                    - whole.gather(-1, labels[..., None])[..., 0])
        ce_gap = float((lm._nll(local, rows["labels"]) - gathered).abs()
                       .max())
    loss = grads = None
    if accum == 1:
        loss, _, grads = step_mod._grads(lm, layout.compute, rows)
        loss, grads = float(loss), _numpy(layout.full(
            layout.reduce_grads(grads)))
    layout.release()
    fn = step_mod.make_train_step(lm, adamw, sched, accum_steps=accum,
                                  layout=layout)
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = fn(state, rows)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    held = sum(t.numel() for t in (*state.params.values(),
                                   *state.opt.m.values()))
    return dict(loss=loss, grads=grads, ce_gap=ce_gap,
                vocab_split=local.shape[-1] < lm.cfg.vocab, losses=losses,
                norms=norms, params=_numpy(layout.full(state.params)),
                lrs=[sched.peak_lr] * STEPS, held=held,
                gathered=list(layout.gathered),
                local_shapes={k: tuple(v.shape)
                              for k, v in state.params.items()})


def trainer_run(mesh, ckpt_dir, total, accum=1):
    """``Trainer(mesh=)`` over the dense config's synthetic tokens to step
    ``total``, restoring the latest checkpoint under ``ckpt_dir`` first
    and writing one at ``TRAIN["ckpt_at"]`` and at the end."""
    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.step import train_state_pspecs
    host = host_lm("dense")
    adamw, sched = optim()
    cfg = host.cfg
    tr = Trainer(host, DataConfig(seq_len=TRAIN["seq"],
                                  global_batch=TRAIN["batch"],
                                  vocab=cfg.vocab),
                 trainer_cfg(total, ckpt_dir, accum), adamw, sched,
                 mesh=mesh, state_shardings=train_state_pspecs(host, mesh))
    state = tr.run()
    return dict(losses=[r["loss"] for r in tr.history],
                norms=[r["grad_norm"] for r in tr.history],
                step=int(state.step),
                params=_numpy(tr.layout.full(state.params)))


def trainer_cfg(total, ckpt_dir, accum=1):
    from repro_torch.train import TrainerConfig
    return TrainerConfig(total_steps=total, log_every=100,
                         ckpt_every=TRAIN["ckpt_at"], ckpt_dir=ckpt_dir,
                         ckpt_keep=5, accum_steps=accum)


def train_world(rank, world, init_method, ckpt_root):
    """Every training scenario on one rank of a world of four: each
    family on each shape of :data:`SHAPES`, accumulation and int8 error
    feedback on (2, 2), the Trainer saving on (2, 2) and resuming on
    (1, 2), and the launcher's ``--mesh`` over a (2, 2) production mesh
    (``mesh_axes`` replaced)."""
    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.init_process("cpu", init_method=init_method, rank=rank,
                          world_size=world)
    torch.set_num_threads(1)
    out = {"rank": rank, "runs": {}}

    def mesh_of(shape):
        # collective: every rank of the world builds every mesh
        n = int(np.prod(shape))
        return mesh_mod.build_mesh(range(n), shape, ("data", "model")), n

    for fam in ARCHS:
        for shape in SHAPES:
            mesh, n = mesh_of(shape)
            if rank < n:
                out["runs"][(fam, shape)] = sharded_run(fam, mesh)
        mesh, _ = mesh_of((2, 2))
        out["runs"][(fam, "accum")] = sharded_run(fam, mesh, accum=2)
        out["runs"][(fam, "ef")] = sharded_run(fam, mesh, ef=True)
    for fam in GUARDED:
        mesh, _ = mesh_of((1, 4))
        out["runs"][(fam, (1, 4))] = sharded_run(fam, mesh)
    # a checkpoint written on (2, 2), resumed on (1, 2)
    mesh, _ = mesh_of((2, 2))
    out["saved"] = trainer_run(mesh, ckpt_root, TRAIN["ckpt_at"])
    mesh, n = mesh_of((1, 2))
    if rank < n:
        out["resumed"] = trainer_run(mesh, ckpt_root, TRAIN["steps"])
    # the Trainer on (2, 1) with 2 microbatches, uninterrupted
    mesh, n = mesh_of((2, 1))
    if rank < n:
        out["accum"] = trainer_run(mesh, None, TRAIN["steps"], accum=2)
    # the launcher's --mesh, the production mesh cut to (2, 2)
    from repro_torch.launch import train as train_launch
    real = mesh_mod.mesh_axes
    mesh_mod.mesh_axes = lambda multi_pod=False: (
        ((1, 2, 2), ("pod", "data", "model")) if multi_pod
        else ((2, 2), ("data", "model")))
    try:
        for kind in ("single", "multi"):
            out[("launcher", kind)] = train_launch.main([
                "--arch", ARCHS["dense"], "--smoke-dims", "--device", "cpu",
                "--dtype", "fp32", "--steps", "3", "--batch", "4", "--seq",
                "8", "--mesh", kind, "--pin", "compact", "--compress-grads",
                "--ckpt-dir", f"{ckpt_root}-{kind}"])
    finally:
        mesh_mod.mesh_axes = real
    return out


# ---------------------------------------------------------------------------
# serving the moe and vlm families on a mesh
# ---------------------------------------------------------------------------

def prompts(fam):
    cfg = config(fam)
    rng = np.random.default_rng(31)
    return [rng.integers(1, cfg.vocab, n).tolist() for n in (9, 14, 6)]


def patch_embeds(fam):
    cfg = config(fam)
    rng = np.random.default_rng(32)
    return rng.standard_normal((3, cfg.n_patches, cfg.d_model)).astype(
        np.float32)


def workload(fam):
    cfg = config(fam)
    rng = np.random.default_rng(33)
    return [(rng.integers(1, cfg.vocab, int(n)).tolist(), int(b))
            for n, b in zip(rng.integers(4, 15, 5), rng.integers(4, 10, 5))]


def run_sched(E, eng, work, kill=None):
    sched = E.BatchScheduler(eng)
    for rid, (prompt, budget) in enumerate(work):
        sched.submit(E.Request(rid=rid, prompt=list(prompt),
                               max_new_tokens=budget))
    if kill is not None:
        sched.inject_failure(kill, at_segment=1)
    done = sched.run()
    return sched, {rid: list(r.generated) for rid, r in done.items()}


def serve_tokens(E, lm, fam, kv, mesh=None, kill=None):
    """(generate tokens, scheduler tokens, engine, scheduler)."""
    eng = E.Engine(lm, E.ServeConfig(kv_dtype=kv, **SERVE), device="cpu",
                   mesh=mesh)
    extra = ({"patch_embeds": patch_embeds(fam)} if fam == "vlm" else None)
    gen = eng.generate(prompts(fam), MAX_NEW, extra_batch=extra)
    sched, toks = run_sched(E, eng, workload(fam), kill=kill)
    return gen, toks, eng, sched


def serve_world(rank, world, init_method, weights):
    """The moe and vlm families on a (1, 2) serving mesh plus a spare, fp32
    and int8 pages, and the moe model re-meshed onto the spare after a
    kill; ``weights`` maps a family to a saved state dict."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM
    from repro_torch.serve import engine as E
    mesh_mod.init_process("cpu", init_method=init_method, rank=rank,
                          world_size=world)
    torch.set_num_threads(1)
    out = {"rank": rank}
    for fam, path in weights.items():
        lm = LM(config(fam), torch.float32, "cpu")
        lm.load_state_dict(torch.load(path))
        for kv in (None, "int8"):
            sm = mesh_mod.make_serve_mesh((1, 2))
            gen, toks, eng, _ = serve_tokens(E, lm, fam, kv, sm)
            out[(fam, kv)] = dict(
                generate=gen, tokens=toks, member=eng.member,
                facts=eng.mesh_facts,
                experts=(eng.lm.blocks[0].moe.w_gate.shape[0]
                         if eng.member and fam == "moe" else None),
                local_kvh=(eng.lm.block_config().attn.num_kv_heads
                           if eng.member else None))
        if fam == "moe":
            sm = mesh_mod.make_serve_mesh((1, 2))
            _, toks, eng, sched = serve_tokens(E, lm, fam, None, sm,
                                               kill=sm.device_ids[1])
            out[(fam, "kill")] = dict(
                tokens=toks, remeshes=sched.metrics["remeshes"],
                member=eng.member, device_ids=list(eng.serve_mesh.device_ids),
                experts=(eng.lm.blocks[0].moe.w_gate.shape[0]
                         if eng.member else None))
    return out
