"""Training checkpoints, the Trainer, the train launcher and serving what
was trained, on the CPU.

* ``save_checkpoint`` writes the JAX package's layout: one file a
  REFERENCE leaf in ``tree_flatten`` order of its ``TrainState``, the
  per-layer tensors stacked, ``keystr`` paths, bf16 moments under
  ``"bfloat16"``; ``restore_checkpoint`` restores bit for bit, keeps
  ``keep`` steps, commits atomically, joins async saves (one writer at
  a time: two writes of one step do not race), raises a failed async
  write's error from ``wait_pending`` and refuses a wrong structure,
  path or shape;
* a checkpoint the JAX package writes (after two of its steps) restores
  into the port and the next step's loss and grad norm match the JAX
  package's within 1e-5; one the port writes restores into JAX's
  ``restore_checkpoint(target=...)`` bit for bit;
* ``Trainer`` runs, checkpoints and resumes EXACTLY: a run stopped at step 3 and
  resumed by a fresh Trainer gives the uninterrupted run's losses and
  parameters bit for bit;
* ``python -m repro_torch.launch.train --device cpu --smoke-dims`` trains
  and checkpoints, and refuses ``--mesh`` for the families still owed
  to item 14b (hybrid, xlstm, encdec) citing item 14; so does
  ``Trainer(mesh=)`` (the dense, moe and vlm families train on a mesh:
  ``tests/test_torch_train_mesh.py``);
* the serve launcher's ``--ckpt-dir`` serves the trained params: its
  greedy tokens equal those of an engine built on the trainer's
  in-memory weights.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_arch as jax_get_arch
from repro.core.features import default_features as jax_features
from repro.models.lm import LM as JaxLM
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import ScheduleConfig as JaxSched
from repro.train.step import init_train_state as jax_init_state
from repro.train.step import make_train_step as jax_make_step
from repro_torch.bridge import params_to_jax
from repro_torch.checkpoint import (latest_step, list_steps,
                                    restore_checkpoint, save_checkpoint,
                                    wait_pending)
from repro_torch.configs import get_arch
from repro_torch.core.features import default_features
from repro_torch.data import DataConfig, make_source
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.serve.engine import (BatchScheduler, Engine, Request,
                                      ServeConfig)
from repro_torch.train import (Trainer, TrainerConfig, init_train_state,
                               make_train_step)

torch.set_num_threads(1)

#: a checkpoint writer thread that dies (two writers racing on one
#: directory) fails the test that started it
pytestmark = pytest.mark.filterwarnings(
    "error::pytest.PytestUnhandledThreadExceptionWarning")

ARCH = "qwen2-0.5b"
CFG = get_arch(ARCH).smoke
SCHED = dict(peak_lr=1e-2, warmup_steps=2, total_steps=6)


def _lm(seed=0):
    lm = LM(CFG, torch.float32, "cpu",
            features=default_features().with_(remat_policy="none"))
    return lm.init(torch.Generator().manual_seed(seed))


def _batch(step, batch=4, seq=16):
    b = make_source(DataConfig(seq_len=seq, global_batch=batch,
                               vocab=CFG.vocab)).batch_at(step)
    return ({k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


def _jax_state(adamw):
    jlm = JaxLM(jax_get_arch(ARCH).smoke,
                jax_features().with_(remat_policy="none"), dtype=jnp.float32)
    return jlm, jax_init_state(jlm, jax.random.PRNGKey(0), adamw)


def test_checkpoint_layout_is_the_references(tmp_path):
    kw = dict(moment_dtype="bfloat16", grad_compression="int8_ef")
    lm = _lm()
    state = init_train_state(lm, AdamWConfig(**kw))
    step = make_train_step(lm, AdamWConfig(**kw), ScheduleConfig(**SCHED))
    state, _ = step(state, _batch(0)[0])
    state, _ = step(state, _batch(1)[0])
    d = save_checkpoint(str(tmp_path), 2, state)
    assert d.endswith("step_000000002")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    _, jstate = _jax_state(JaxAdamW(**kw))
    flat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert [e["path"] for e in manifest["leaves"]] == \
        [jax.tree_util.keystr(p) for p, _ in flat]
    assert [tuple(e["shape"]) for e in manifest["leaves"]] == \
        [tuple(leaf.shape) for _, leaf in flat]
    assert [e["dtype"] for e in manifest["leaves"]] == \
        [str(leaf.dtype) for _, leaf in flat]
    assert ".opt.m['blocks']['attn']['wq']" in \
        [e["path"] for e in manifest["leaves"]]
    # a fresh state restores bit for bit, bf16 moments included
    lm2 = _lm(seed=1)
    fresh = init_train_state(lm2, AdamWConfig(**kw))
    restored, m2 = restore_checkpoint(str(tmp_path), target=fresh)
    assert m2["step"] == 2 and int(restored.step) == 2
    for tree in ("params",):
        for k, v in getattr(state, tree).items():
            assert torch.equal(getattr(restored, tree)[k], v), k
    for a, b in ((state.opt.m, restored.opt.m), (state.opt.v, restored.opt.v),
                 (state.opt.ef, restored.opt.ef)):
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert int(restored.opt.step) == 2
    assert dict(lm2.named_parameters())["blocks.1.attn.wq"] is \
        restored.params["blocks.1.attn.wq"]          # restored in place


def test_retention_async_atomicity_and_refusals(tmp_path):
    base = str(tmp_path)
    lm = _lm()
    state = init_train_state(lm, AdamWConfig())
    for s in (1, 2, 3, 4, 4):            # step 4 twice, both on threads
        save_checkpoint(base, s, state, keep=2, async_save=(s % 2 == 0))
    wait_pending()
    assert list_steps(base) == [3, 4] and latest_step(base) == 4
    # a write that fails on its thread (its marker path is a directory)
    # raises from the join, once
    os.makedirs(str(tmp_path / "bad" / "step_000000005.COMMITTED"))
    save_checkpoint(str(tmp_path / "bad"), 5, state, async_save=True)
    with pytest.raises(IsADirectoryError):
        wait_pending()
    wait_pending()
    # a save that crashed before its marker is never restored
    os.makedirs(os.path.join(base, "step_000000009.tmp-1"))
    os.makedirs(os.path.join(base, "step_000000008"))
    assert latest_step(base) == 4
    with pytest.raises(FileNotFoundError, match="not committed"):
        restore_checkpoint(base, 8, target=state)
    with pytest.raises(FileNotFoundError, match="no committed"):
        restore_checkpoint(str(tmp_path / "empty"), target=state)
    # another structure (error-feedback leaves), another shape, another
    # path order: each refused
    ef_state = init_train_state(lm, AdamWConfig(grad_compression="int8_ef"))
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(base, target=ef_state)
    wide = LM(CFG.__class__(**dict(CFG.__dict__, d_ff=CFG.d_ff * 2)),
              torch.float32, "cpu")
    with pytest.raises(ValueError, match="stored"):
        restore_checkpoint(base, target=init_train_state(wide,
                                                         AdamWConfig()))
    renamed = state._replace(opt=state.opt._replace(
        m={k.replace("final_norm", "zz_norm"): v
           for k, v in state.opt.m.items()}))
    with pytest.raises(ValueError, match="stored .*!= target"):
        restore_checkpoint(base, target=renamed)


def test_jax_checkpoint_restores_into_the_port_and_back(tmp_path):
    jlm, jstate = _jax_state(JaxAdamW())
    jstep = jax.jit(jax_make_step(jlm, JaxAdamW(), JaxSched(**SCHED)))
    for i in range(2):
        jstate, _ = jstep(jstate, _batch(i)[1])
    jax_save(str(tmp_path / "jax"), 2, jstate)
    # the port, from other weights, restores JAX's state and continues
    lm = _lm(seed=5)
    state, _ = restore_checkpoint(str(tmp_path / "jax"),
                                  target=init_train_state(lm, AdamWConfig()))
    assert int(state.step) == 2
    got = params_to_jax(state.params, CFG)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate.params)[0]:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    step = make_train_step(lm, AdamWConfig(), ScheduleConfig(**SCHED))
    tb, jb = _batch(2)
    state, m = step(state, tb)
    jstate, jm = jstep(jstate, jb)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5)
    # the port writes, JAX restores bit for bit
    save_checkpoint(str(tmp_path / "port"), 3, state)
    back, _ = jax_restore(str(tmp_path / "port"), target=jstate)
    assert int(back.step) == 3 and int(back.opt.step) == 3
    for tree, port in ((back.params, state.params), (back.opt.m, state.opt.m),
                       (back.opt.v, state.opt.v)):
        want = params_to_jax(port, CFG)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            node = want
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(np.asarray(leaf), node)


def _trainer(lm, ckpt_dir, total, every=100):
    data = DataConfig(seq_len=16, global_batch=4, vocab=CFG.vocab, seed=0)
    return Trainer(lm, data,
                   TrainerConfig(total_steps=total, log_every=10,
                                 ckpt_every=every, ckpt_dir=ckpt_dir,
                                 ckpt_keep=2),
                   AdamWConfig(), ScheduleConfig(**SCHED))


def test_trainer_runs_and_resumes_exactly(tmp_path):
    full = _trainer(_lm(), str(tmp_path / "full"), 6, every=2)
    state = full.run()
    assert int(state.step) == 6 and len(full.history) == 6
    assert list_steps(str(tmp_path / "full")) == [4, 6]
    # stop at 3, then a fresh Trainer over fresh weights resumes to 6
    first = _trainer(_lm(), str(tmp_path / "cut"), 3)
    first.run()
    second = _trainer(_lm(seed=9), str(tmp_path / "cut"), 6)
    resumed = second.init_or_restore()
    assert int(resumed.step) == 3
    resumed = second.run(resumed)
    assert int(resumed.step) == 6
    want = [r["loss"] for r in full.history]
    got = [r["loss"] for r in first.history + second.history]
    assert got == want                                    # bit for bit
    for k, v in state.params.items():
        assert torch.equal(resumed.params[k], v), k
    assert all(np.isfinite(r["grad_norm"]) for r in full.history)
    # every family trains on a mesh (tests/test_torch_family_mesh.py);
    # a sharded trainer still refuses a full LM that is not a host copy
    for arch in ("zamba2-1.2b", "xlstm-350m", "seamless-m4t-medium"):
        with pytest.raises(ValueError, match="host copy on the CPU"):
            Trainer(LM(get_arch(arch).smoke, torch.float32, "meta"),
                    DataConfig(seq_len=8, global_batch=2, vocab=8),
                    TrainerConfig(), mesh=object())


def test_train_launcher_runs_and_refuses_the_mesh(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    assert train_launch.main(["--arch", "zamba2-1.2b", "--smoke-dims",
                              "--device", "cpu", "--dtype", "fp32",
                              "--steps", "3", "--batch", "2", "--seq", "16",
                              "--ckpt-dir", d, "--ckpt-every", "2",
                              "--remat", "full", "--compress-grads"]) == 0
    out = capsys.readouterr().out
    assert "finished at step 3" in out
    assert list_steps(d) == [2, 3]
    # --mesh trains every family; a world of one is refused by the
    # production mesh's size
    from repro_torch.launch import mesh as mesh_mod
    for arch, flags, want in (
            ("zamba2-1.2b", ("--mesh", "single"),
             "(16, 16) needs a world of 256 ranks"),
            ("xlstm-350m", ("--mesh", "multi", "--pin", "ring"),
             "(2, 16, 16) needs a world of 512 ranks")):
        try:
            with pytest.raises(SystemExit) as e:
                train_launch.main(["--arch", arch, "--smoke-dims",
                                   "--device", "cpu", *flags])
            assert e.value.code == 2
            assert want in capsys.readouterr().err
        finally:
            mesh_mod.leave_process_group()


def test_serve_ckpt_dir_serves_the_trained_params(tmp_path):
    d = str(tmp_path / "ckpt")
    lm = LM(CFG, torch.float32, "cpu",
            features=default_features().with_(remat_policy="none"),
            param_dtype=torch.float32)
    trainer = _trainer(lm, d, 4)
    trainer.run()
    out = str(tmp_path / "serve.json")
    args = ["--requests", "3", "--prompt-len", "6", "--max-new", "5",
            "--slots", "2", "--max-seq", "32", "--page-size", "4"]
    assert serve_launch.main(["--arch", ARCH, "--smoke-dims", "--device",
                              "cpu", "--dtype", "fp32", "--ckpt-dir", d,
                              "--json", out, *args]) == 0
    with open(out) as f:
        served = json.load(f)
    # the same requests through an engine on the in-memory weights
    mem = LM(CFG, torch.float32, "cpu")
    mem.load_state_dict({k: v.detach() for k, v in lm.state_dict().items()})
    eng = Engine(mem, ServeConfig(max_seq=32, batch_slots=2, page_size=4),
                 device=mem.device)
    sched = BatchScheduler(eng)
    rng = np.random.default_rng(0)
    for rid in range(3):
        sched.submit(Request(rid=rid, max_new_tokens=5,
                             prompt=rng.integers(1, CFG.vocab,
                                                 size=6).tolist()))
    done = sched.run()
    assert served["tokens"] == {str(r): list(done[r].generated)
                                for r in sorted(done)}
    assert set(served["launches"]) >= {"flash_attention_bhsd",
                                       "block_argmax"}
    # random weights give other tokens: the checkpoint really was served
    rnd = str(tmp_path / "rnd.json")
    serve_launch.main(["--arch", ARCH, "--smoke-dims", "--device", "cpu",
                       "--dtype", "fp32", "--json", rnd, *args])
    with open(rnd) as f:
        assert json.load(f)["tokens"] != served["tokens"]
