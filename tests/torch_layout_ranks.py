"""The rank side of ``tests/test_torch_seq_parallel.py``: what each
spawned gloo rank decodes or trains under the reference's layouts.  A
plain module (no test in it, no JAX import), so each spawned process
imports only torch and the port; the test computes the JAX references in
its own process and hands every rank the same bridged weights."""

import numpy as np
import torch

#: the decode cases: (arch, layout, mesh shape, rows).  "seq" cuts the
#: caches' sequence over the axes the batch leaves free (the model axis
#: at two rows; both axes at one row), "headdim" the head dim over the
#: model axis (the sequence whole)
DECODE_ARCHS = ("qwen2-0.5b", "zamba2-1.2b", "seamless-m4t-medium")
DECODE_CASES = tuple((a, lay, shape, rows) for a in DECODE_ARCHS
                     for lay, shape, rows in (("seq", (1, 2), 2),
                                              ("seq", (2, 2), 1),
                                              ("headdim", (1, 2), 2)))
#: the prompt length, the cache's length and the decoded tokens (fixed,
#: not sampled)
PROMPT, SMAX, STEPS = 6, 16, 4
#: the decode cases that prefill through the rank's LM into its cut of a
#: zeroed state (``LM(mesh=).prefill``): (arch, mesh shape, rows, cache
#: length).  At 20 positions the encdec memory's 5 do not divide over the
#: model axis, so the memory is cut by kv heads while the caches are cut
#: by positions; at 16 on (2, 2) both are cut by positions over both axes
PREFILL_CASES = tuple((a, shape, rows, smax) for a in DECODE_ARCHS
                      for shape, rows, smax in (((1, 2), 2, 20),
                                                ((2, 2), 1, 16)))
#: the sequence-parallel archs (``TRAIN_POLICY``) and meshes
SP_ARCHS = ("mistral-large-123b", "qwen3-moe-235b-a22b", "qwen2-vl-7b")
SP_SHAPES = ((1, 2), (2, 2))
#: the other families under ``act_seq -> model`` (``--sp 1``), on (1, 2):
#: the hybrid's shared block on the slice and its Mamba2 groups on the
#: gathered sequence, the xlstm and encdec backbones on the gathered
#: sequence
SP_MORE_ARCHS = ("zamba2-1.2b", "xlstm-350m", "seamless-m4t-medium")
WORLD = 4


def config(arch):
    from repro_torch.configs import get_arch
    return get_arch(arch).smoke


def host_lm(arch, state_dict, remat="none"):
    """The whole model, fp32 on the CPU, from the bridged weights."""
    from repro_torch.core.features import default_features
    from repro_torch.models.lm import LM
    lm = LM(config(arch), torch.float32, "cpu",
            features=default_features().with_(remat_policy=remat),
            param_dtype=torch.float32)
    lm.load_state_dict({k: torch.from_numpy(v)
                        for k, v in state_dict.items()})
    return lm


def decode_rules(layout):
    from repro_torch.launch import dryrun
    return dryrun._rules_for(
        None, dryrun.TrainPolicy(kv_shard="headdim" if layout == "headdim"
                                 else "seq"), "decode")


def decode_inputs(arch, rows, smax=SMAX):
    """The prompts (and the encdec source stub, the state's ``S_src``
    long) and the decoded tokens, from seed 11."""
    cfg = config(arch)
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg.vocab, (rows, PROMPT))
             .astype(np.int32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (rows, smax // cfg.src_ratio, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab, (STEPS, rows, 1)).astype(np.int32)
    return batch, steps


def rank_lm(host, mesh, rules):
    """This rank's LM of ``host`` on ``mesh`` under ``rules`` (its weights
    whole where the model axis does not divide a head count, as the
    divisibility guard keeps them), loaded with its blocks."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.lm import LM, _split_heads
    tp = mesh_mod.model_axis(mesh)
    headdim = "model" in (rules.lookup("head_dim") or ())
    if any(n % tp.size for n in _split_heads(host.cfg, headdim).values()):
        tp = None
    lm = LM(host.cfg, torch.float32, "cpu", features=host.features,
            rules=rules, tp=tp, mesh=mesh)
    with torch.no_grad():
        own = dict(lm.named_parameters())
        for k, v in lm.shard_params(dict(host.named_parameters()),
                                    mesh).items():
            own[k].copy_(v)
    return lm


def decode_run(arch, layout, mesh, rows, state_dict):
    """Prefill unsharded, cut the state by ``state_pspecs`` under the
    layout's rules, then decode :data:`STEPS` fixed tokens on this rank:
    the logits of each step and the shape of this rank's first KV
    buffer."""
    host = host_lm(arch, state_dict)
    batch, steps = decode_inputs(arch, rows)
    state = host.init_decode_state(rows, SMAX)
    with torch.no_grad():
        _, state = host.prefill(
            {k: torch.from_numpy(v) for k, v in batch.items()}, state)
        rules = host.state_rules(state, mesh, decode_rules(layout))
        lm = rank_lm(host, mesh, rules)
        local = lm.cut_state(state)
        out = []
        for tok in steps:
            logits, local = lm.decode_step(torch.from_numpy(tok), local)
            out.append(logits.numpy())
    kv = local.get("caches", local.get("attn_caches"))
    return np.stack(out), tuple(kv.k.shape)


def layout_prefill_run(arch, mesh, rows, smax, state_dict):
    """Cut a zeroed state under the sequence layout's rules, prefill
    through this rank's LM into it, then decode :data:`STEPS` fixed
    tokens: the prefill's logits, each step's, and the shapes of this
    rank's first KV buffer and (encdec) memory.  Every case leaves the
    batch whole on the rank (one data rank, or one row)."""
    host = host_lm(arch, state_dict)
    batch, steps = decode_inputs(arch, rows, smax)
    whole = host.init_decode_state(rows, smax)
    with torch.no_grad():
        rules = host.state_rules(whole, mesh, decode_rules("seq"))
        lm = rank_lm(host, mesh, rules)
        local = lm.cut_state(whole)
        first, local = lm.prefill(
            {k: torch.from_numpy(v) for k, v in batch.items()}, local)
        out = []
        for tok in steps:
            logits, local = lm.decode_step(torch.from_numpy(tok), local)
            out.append(logits.numpy())
    kv = local.get("caches", local.get("attn_caches"))
    mem = local.get("mem_k")
    return (first.numpy(), np.stack(out), tuple(kv.k.shape),
            None if mem is None else tuple(mem.shape))


def sp_run(arch, mesh, state_dict, batch):
    """The first train step's loss and whole gradients on this rank of
    ``mesh`` under ``act_seq -> model`` (the rank's rows of ``batch``)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.layers import DEFAULT_RULES
    from repro_torch.models.lm import LM
    from repro_torch.train import step as step_mod
    host = host_lm(arch, state_dict)
    tp, dp = mesh_mod.model_axis(mesh), mesh_mod.data_axis(mesh)
    lm = LM(host.cfg, torch.float32, "cpu", features=host.features,
            param_dtype=torch.float32, tp=tp, dp=dp,
            rules=DEFAULT_RULES.replace(act_seq=("model",)))
    lm.requires_grad_(True)
    layout = step_mod.StateLayout(
        lm, step_mod.train_state_pspecs(host, mesh).params, mesh,
        dict(host.named_parameters()))
    params = layout.init_params(dict(host.named_parameters()))
    n = next(iter(batch.values())).shape[0] // dp.size
    rows = {k: torch.from_numpy(v[dp.index * n:(dp.index + 1) * n])
            for k, v in batch.items()}
    layout.gather(params)
    loss, _, grads = step_mod._grads(lm, layout.compute, rows)
    grads = layout.full(layout.reduce_grads(grads))
    layout.release()
    return float(loss), {k: v.detach().numpy() for k, v in grads.items()}


def layout_world(rank, world, init_method, weights, sp_batches):
    """Every decode case and every sequence-parallel train step on one
    rank of a world of four; ``weights`` the bridged state dicts by arch,
    ``sp_batches`` the train batches by arch."""
    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.init_process("cpu", init_method=init_method, rank=rank,
                          world_size=world)
    torch.set_num_threads(1)
    meshes = {}

    def mesh_of(shape):
        # collective: every rank of the world builds every mesh, in order
        if shape not in meshes:
            n = int(np.prod(shape))
            meshes[shape] = mesh_mod.build_mesh(range(n), shape,
                                                ("data", "model"))
        return meshes[shape]

    for shape in ((1, 2), (2, 2)):
        mesh_of(shape)
    out = {}
    for arch, layout, shape, rows in DECODE_CASES:
        if rank < int(np.prod(shape)):
            out[(arch, layout, shape)] = decode_run(
                arch, layout, mesh_of(shape), rows, weights[arch])
    for arch, shape, rows, smax in PREFILL_CASES:
        if rank < int(np.prod(shape)):
            out[(arch, "prefill", shape)] = layout_prefill_run(
                arch, mesh_of(shape), rows, smax, weights[arch])
    sp_cases = [(a, s) for a in SP_ARCHS for s in SP_SHAPES]
    for arch, shape in sp_cases + [(a, (1, 2)) for a in SP_MORE_ARCHS]:
        if rank < int(np.prod(shape)):
            out[(arch, "sp", shape)] = sp_run(
                arch, mesh_of(shape), weights[arch], sp_batches[arch])
    return out
