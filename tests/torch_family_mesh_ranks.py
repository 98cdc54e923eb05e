"""The rank side of ``tests/test_torch_family_mesh.py``: what each spawned
gloo rank serves or trains for the hybrid, xlstm and encdec families.  A
plain module (no test in it, no JAX import), so each spawned process
imports only torch and the port; the tests compute the unsharded
references in their own process from the same seeds."""

import dataclasses

import numpy as np
import torch

from torch_train_mesh_ranks import _numpy, optim, rank_rows

#: one SMOKE config a family (zamba2's: 4 layers at attn_every 2, so the
#: shared block runs at two points)
ARCHS = {"hybrid": "zamba2-1.2b", "xlstm": "xlstm-350m",
         "encdec": "seamless-m4t-medium"}
SHAPES = ((1, 2), (2, 1), (2, 2))
#: seamless on a model axis of 4 with a vocab 4 does not divide: the
#: embedding and the head stay whole, the loss reduces no vocab
VOCAB4 = dict(vocab=510)
#: the serving config (dense KV, fp32)
SERVE = dict(max_seq=64, batch_slots=2, admission_chunk=8)
MAX_NEW = 6
#: the training batch: 4 rows of 12 tokens, rows 1 and 2 holding -1
B, S = 4, 12


def config(fam, change=None):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(ARCHS[fam]).smoke, **(change or {}))


def host_lm(fam, change=None):
    """The whole model, fp32, drawn from seed 0 on the CPU (equal in every
    process), its embedding scaled by 0.1."""
    from repro_torch.core.features import default_features
    from repro_torch.models.lm import LM
    lm = LM(config(fam, change), torch.float32, "cpu",
            features=default_features().with_(remat_policy="none"),
            param_dtype=torch.float32)
    lm.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        lm.embed.table.mul_(0.1)
    return lm


def src_embeds(cfg, rows, seq, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (rows, max(seq // cfg.src_ratio, 1), cfg.d_model)).astype(np.float32)


def prompts(fam):
    """Three prompts of one length (the recurrent families and encdec
    prefill equal-length rows)."""
    rng = np.random.default_rng(41)
    return [rng.integers(1, config(fam).vocab, 10).tolist()
            for _ in range(3)]


def workload(fam):
    rng = np.random.default_rng(43)
    return [(rng.integers(1, config(fam).vocab, int(n)).tolist(), int(b))
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


def serve(E, lm, fam, mesh=None, kill=None, scheduler=True):
    """(prefill logits, generate tokens, scheduler tokens, engine,
    scheduler) of one engine over the family's traffic."""
    eng = E.Engine(lm, E.ServeConfig(**SERVE), device="cpu", mesh=mesh)
    ps = prompts(fam)
    extra = ({"src_embeds": src_embeds(lm.cfg, len(ps), 10, 42)}
             if fam == "encdec" else None)
    with eng._impl_ctx(), torch.inference_mode():
        toks, lens, ex = eng._check_call(ps, MAX_NEW, extra)
        logits, _ = eng._prefill_call(toks, lens, ps, MAX_NEW, ex)
    gen = eng.generate(ps, MAX_NEW, extra_batch=extra)
    sched = toks = None
    if scheduler:
        sched, toks = run_sched(E, eng, workload(fam), kill=kill)
    return logits.numpy(), gen, toks, eng, sched


def _held(eng):
    """This rank's card-side sizes: its heads a family, its state."""
    lm = eng.lm
    state, _ = eng.init_state()
    return dict(params=sum(p.numel() for p in lm.parameters()),
                state={k: tuple(t.shape) for k, t in _named(state)})


def _named(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}.")
    elif tree is not None:
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}.")


def serve_world(rank, world, init_method, weights):
    """Every family on (1, 2), (2, 1) and (2, 2) serving meshes (the rest
    of the world of five as spares), the hybrid re-meshed onto a spare
    after a kill, and seamless on (1, 4) with a vocab of 510;
    ``weights`` maps a run's key to a saved state dict."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM
    from repro_torch.serve import engine as E
    mesh_mod.init_process("cpu", init_method=init_method, rank=rank,
                          world_size=world)
    torch.set_num_threads(1)
    out = {"rank": rank}

    def load(key, change=None):
        lm = LM(config(key, change), torch.float32, "cpu")
        lm.load_state_dict(torch.load(weights[(key, bool(change))]))
        return lm

    for fam in ARCHS:
        lm = load(fam)
        for shape in SHAPES:
            sm = mesh_mod.make_serve_mesh(shape)
            logits, gen, toks, eng, _ = serve(E, lm, fam, sm,
                                              scheduler=fam != "encdec")
            out[(fam, shape)] = dict(
                logits=logits if eng.member else None, generate=gen,
                tokens=toks, member=eng.member,
                held=_held(eng) if eng.member else None)
        if fam == "hybrid":
            sm = mesh_mod.make_serve_mesh((1, 2))
            _, _, toks, eng, sched = serve(E, lm, fam, sm,
                                           kill=sm.device_ids[1])
            out[(fam, "kill")] = dict(
                tokens=toks, remeshes=sched.metrics["remeshes"],
                member=eng.member, device_ids=list(eng.serve_mesh.device_ids))
    lm = load("encdec", VOCAB4)
    sm = mesh_mod.make_serve_mesh((1, 4))
    logits, gen, _, eng, _ = serve(E, lm, "encdec", sm, scheduler=False)
    out[("encdec", (1, 4))] = dict(
        logits=logits if eng.member else None, generate=gen,
        member=eng.member,
        vocab_rows=eng.lm.embed.table.shape[0] if eng.member else None)
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def batch(fam, change=None):
    """The global batch: labels are the next tokens, -1 at each row's
    end; row 1 masks all but 3 positions, row 2 its first 5."""
    cfg = config(fam, change)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    labels = np.full_like(tokens, -1)
    labels[:, :-1] = tokens[:, 1:]
    labels[1, 3:] = -1
    labels[2, :5] = -1
    out = {"tokens": torch.from_numpy(tokens.astype(np.int32)),
           "labels": torch.from_numpy(labels.astype(np.int32))}
    if cfg.family == "encdec":
        out["src_embeds"] = torch.from_numpy(src_embeds(cfg, B, S, 8))
    return out


def train_one(fam, mesh, change=None):
    """On a rank of ``mesh``: the first step's loss and whole gradients
    (gathered from the slices), then one AdamW step's loss, grad norm
    and whole parameters, and the shapes of the rank's slices."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM
    from repro_torch.optim import init_opt_state
    from repro_torch.train import step as step_mod
    host = host_lm(fam, change)
    tp, dp = mesh_mod.model_axis(mesh), mesh_mod.data_axis(mesh)
    lm = LM(host.cfg, torch.float32, "cpu", features=host.features,
            param_dtype=torch.float32, tp=tp, dp=dp).requires_grad_(True)
    adamw, sched = optim()
    specs = step_mod.train_state_pspecs(host, mesh).params
    layout = step_mod.StateLayout(lm, specs, mesh,
                                  dict(host.named_parameters()))
    params = layout.init_params(dict(host.named_parameters()))
    state = step_mod.TrainState(params, init_opt_state(params, adamw),
                                torch.zeros((), dtype=torch.int32))
    rows = rank_rows(batch(fam, change), dp.index, dp.size)
    layout.gather(state.params)
    loss, _, grads = step_mod._grads(lm, layout.compute, rows)
    grads = _numpy(layout.full(layout.reduce_grads(grads)))
    layout.release()
    fn = step_mod.make_train_step(lm, adamw, sched, layout=layout)
    state, m = fn(state, rows)
    return dict(loss=float(loss), grads=grads, step_loss=float(m["loss"]),
                norm=float(m["grad_norm"]), lr=sched.peak_lr,
                params=_numpy(layout.full(state.params)),
                local_shapes={k: tuple(v.shape)
                              for k, v in state.params.items()})


def train_world(rank, world, init_method):
    """One training step of every family on each shape of
    :data:`SHAPES`, and seamless on (1, 4) with a vocab of 510."""
    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.init_process("cpu", init_method=init_method, rank=rank,
                          world_size=world)
    torch.set_num_threads(1)
    out = {"rank": rank, "runs": {}}
    for fam in ARCHS:
        for shape in SHAPES:
            n = int(np.prod(shape))
            mesh = mesh_mod.build_mesh(range(n), shape, ("data", "model"))
            if rank < n:
                out["runs"][(fam, shape)] = train_one(fam, mesh)
    mesh = mesh_mod.build_mesh(range(4), (1, 4), ("data", "model"))
    out["runs"][("encdec", (1, 4))] = train_one("encdec", mesh, VOCAB4)
    return out


# ---------------------------------------------------------------------------
# the dry run's counting axis against the collectives a run sends
# ---------------------------------------------------------------------------

#: the (1, 2) cells the dry run's walk is held to: a family's SMOKE
#: config, one step of each kind at 2 rows of 16 tokens
WALK_ARCHS = ("qwen2-moe-a2.7b", "zamba2-1.2b", "xlstm-350m",
              "seamless-m4t-medium")
WALK_KINDS = ("train", "prefill", "decode")
WALK_SEQ = 16
#: the walks under the reference's other layouts: a decode under
#: ``kv_shard="headdim"`` and a train step under ``act_seq -> model``
#: (the prefill and decode walks above cut their state by
#: ``LM.state_pspecs``: the sequence over the model axis)
WALK_LAYOUTS = (("qwen2-moe-a2.7b", "decode", "headdim"),
                ("zamba2-1.2b", "decode", "headdim"),
                ("seamless-m4t-medium", "decode", "headdim"),
                ("qwen2-moe-a2.7b", "train", "sp"),
                ("qwen2-vl-7b", "train", "sp"),
                ("zamba2-1.2b", "train", "sp"))


def walk_rules(kind, layout):
    """The walk's rules for one of :data:`WALK_LAYOUTS`."""
    from repro_torch.launch import dryrun
    pol = dryrun.TrainPolicy(accum_steps=1,
                             kv_shard="headdim" if layout == "headdim"
                             else "seq",
                             sequence_parallel=layout == "sp")
    return dryrun._rules_for(None, pol, kind)


def walk_batch(cfg, kind, device):
    from repro_torch.configs import input_specs
    from repro_torch.configs.base import Shape
    meta = input_specs(cfg, Shape("walk", WALK_SEQ, 2, kind))
    if device == "meta":
        return meta
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in meta.items()}


def walk_world(rank, world, init_method):
    """Each cell of :data:`WALK_ARCHS` x :data:`WALK_KINDS` run for real
    on a (1, 2) mesh over gloo (``dryrun.walk`` on the mesh's own axes):
    the collective events this rank declared."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.init_process("cpu", init_method=init_method, rank=rank,
                          world_size=world)
    torch.set_num_threads(1)
    mesh = mesh_mod.build_mesh(range(2), (1, 2), ("data", "model"))
    out = {}
    for arch in WALK_ARCHS:
        cfg = get_arch(arch).smoke
        for kind in WALK_KINDS:
            info = dryrun.walk(cfg, kind, walk_batch(cfg, kind, "cpu"),
                               mesh=mesh, device="cpu", seq_len=WALK_SEQ,
                               dtype=torch.float32,
                               policy=dryrun.TrainPolicy(accum_steps=1))
            out[(arch, kind)] = {k: v for k, v in
                                 info["events"].counts.items()
                                 if k.startswith("ICI_")}
    for arch, kind, layout in WALK_LAYOUTS:
        cfg = get_arch(arch).smoke
        info = dryrun.walk(cfg, kind, walk_batch(cfg, kind, "cpu"),
                           mesh=mesh, device="cpu", seq_len=WALK_SEQ,
                           dtype=torch.float32,
                           rules=walk_rules(kind, layout),
                           policy=dryrun.TrainPolicy(accum_steps=1))
        out[(arch, kind, layout)] = {k: v for k, v in
                                     info["events"].counts.items()
                                     if k.startswith("ICI_")}
    return out
