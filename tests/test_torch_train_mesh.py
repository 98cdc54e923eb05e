"""Training on a mesh, on the CPU: four spawned gloo ranks over a
``file://`` store (no network), held to the unsharded port and, for the
specs, to the JAX package.

* ``train_state_pspecs`` (error feedback off and on) against the JAX
  function on duck-typed meshes, and ``StateLayout``'s refusal of a
  spec the rank's LM does not hold;
* in one spawn (``tests/torch_train_mesh_ranks.py``): the dense
  (qwen1.5-0.5b's SMOKE: 4 kv heads), moe and vlm SMOKE configs, fp32,
  on (1, 2), (2, 1) and (2, 2) meshes, against the unsharded port on the
  same global batch (4 x 12 tokens, rows 1 and 2 holding -1 labels; the
  moe batch drops tokens at its capacity): the loss within 1e-5
  relative, every gradient within 1e-4 relative plus 1e-6 of the largest
  gradient (the replicated leaves named), three AdamW steps' losses and
  grad norms within 1e-5 relative and the parameters after them held
  as ``tests/test_torch_train_step.py`` holds the port's to the JAX
  package's (every element within Adam's bound, all but 0.1%, or 1% with
  int8 error feedback, within 1e-5 relative plus 1e-5 of the leaf's
  largest or 1e-3 of the summed rate); on (2, 2) also two microbatches and
  int8 error feedback; 6 experts on a model axis of 4, which the
  divisibility guard keeps whole on every rank (with the shared expert
  split, and whole); the vocab-parallel cross entropy within 1e-6 of
  the gathered form's; each rank's slices of the state;
* ``Trainer(mesh=)``: a run saved on (2, 2) and resumed on (1, 2), and
  one on (2, 1) with two microbatches, give the unsharded Trainer's
  losses and parameters, and the unsharded Trainer resumes the (2, 2)
  checkpoint;
* the launcher's ``--mesh single|multi --pin compact --compress-grads``
  over a production mesh cut to (2, 2) (``mesh_axes`` replaced in the
  ranks) writes the unsharded launch's checkpoint, and a world of the
  wrong size exits 2 with the production mesh's message.
"""

import os

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.core.features import default_features as jax_features
from repro.models.lm import LM as JaxLM
from repro.train.step import train_state_pspecs as jax_pspecs
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as train_launch
from repro_torch.models import moe as moe_mod
from repro_torch.models.lm import LM
from repro_torch.optim import init_opt_state
from repro_torch.train import Trainer, init_train_state, make_train_step
from repro_torch.train import step as step_mod

import torch_train_mesh_ranks as ranks

torch.set_num_threads(1)

WORLD = 4


class DuckMesh:
    def __init__(self, shape, names=("data", "model")):
        self.axis_names = names
        self.devices = np.empty(shape)


# ---------------------------------------------------------------------------
# the specs against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b",
                                  "qwen2-vl-7b"])
@pytest.mark.parametrize("ef", [False, True])
def test_train_state_pspecs_match_jax(arch, ef):
    jlm = JaxLM(jax_get_arch(arch).smoke,
                jax_features().with_(remat_policy="none"))
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    lm = LM(get_arch(arch).smoke, torch.float32, "cpu")
    for mesh in (DuckMesh((2, 2)), DuckMesh((1, 4)),
                 DuckMesh((2, 2, 2), ("pod", "data", "model"))):
        want = jax_pspecs(jlm, mesh, shapes, ef=ef)
        got = step_mod.train_state_pspecs(lm, mesh, ef=ef)
        assert got.step == tuple(want.step) == ()
        assert got.opt.step == tuple(want.opt.step) == ()
        assert (got.opt.ef is None) == (want.opt.ef is None) == (not ef)
        trees = [(got.params, want.params), (got.opt.m, want.opt.m),
                 (got.opt.v, want.opt.v)]
        if ef:
            trees.append((got.opt.ef, want.opt.ef))
        for port, ref in trees:
            assert set(port) == {n for n, _ in lm.named_parameters()}
            for name, spec in port.items():
                top, rest = name.split(".", 1)
                if top == "blocks":
                    _, mod, leaf = rest.split(".")
                    assert (None,) + spec == tuple(ref[top][mod][leaf]), name
                else:
                    assert spec == tuple(ref[top][rest]), name


def test_state_layout_refuses_a_spec_the_lm_does_not_hold():
    """A spec that cuts a dim on the model axis the rank's LM holds whole
    (here d_model) is refused with both shapes named."""
    mesh_mod.init_process("cpu")
    try:
        mesh = mesh_mod.build_mesh([0], (1, 1), ("data", "model"))
        host = ranks.host_lm("dense")
        specs = step_mod.train_state_pspecs(host, mesh).params
        lm = LM(host.cfg, torch.float32, "cpu",
                tp=mesh_mod.model_axis(mesh), dp=mesh_mod.data_axis(mesh))
        layout = step_mod.StateLayout(lm, specs, mesh,
                                      dict(host.named_parameters()))
        assert layout.gathered == [] and layout.coord == (0, 0)
        shapes = {k: torch.empty(2 * p.shape[0], *p.shape[1:])
                  if k == "final_norm.scale" else p
                  for k, p in host.named_parameters()}
        bad = dict(specs, **{"final_norm.scale": ("model",)})
        with pytest.raises(ValueError, match="final_norm.scale"):
            step_mod.StateLayout(lm, bad, mesh, shapes)
    finally:
        mesh_mod.leave_process_group()


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train-mesh") / "ckpt")
    return mesh_mod.spawn(ranks.train_world, WORLD, (root,),
                          timeout_s=120), root


def _unsharded(fam, accum=1, ef=False):
    """The port's unsharded run on the same global batch: the first
    step's loss and gradients, then the steps."""
    lm = ranks.host_lm(fam).requires_grad_(True)
    adamw, sched = ranks.optim(ef)
    b = ranks.batch(fam)
    loss, _, grads = step_mod._grads(lm, dict(lm.named_parameters()), b)
    state = init_train_state(lm, adamw)
    fn = make_train_step(lm, adamw, sched, accum_steps=accum)
    losses, norms = [], []
    for _ in range(ranks.STEPS):
        state, m = fn(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(loss=float(loss), losses=losses, norms=norms,
                grads={k: v.numpy() for k, v in grads.items()},
                params={k: v.detach().numpy()
                        for k, v in state.params.items()})


def _check_params(got, want, lrs, frac=0.999):
    """Every element within Adam's bound (2 x the summed rate), and all
    but ``1 - frac`` (or one) of each leaf's within 1e-5 relative plus
    1e-5 of the leaf's largest or 1e-3 of the summed rate, whichever is
    larger (Adam's normalised steps move every element by about the rate
    a step, a bias that starts at zero included, and an element whose
    gradient is ~1% of its leaf's largest and changes sign between steps
    turns rounding into a few thousandths of a step);
    the key bias (softmax is invariant to it: its true gradient is zero)
    to the bound alone."""
    bound = 2.0 * sum(lrs) + 1e-6
    for name, w in want.items():
        d = np.abs(got[name] - w)
        assert d.max() <= bound, (name, d.max(), bound)
        if not name.endswith(".bk"):
            _mostly_close(name, got[name], w, frac, 1e-3 * sum(lrs))


def _mostly_close(name, got, want, frac, floor=0.0):
    """All but ``1 - frac`` (or one) of the elements within 1e-5 relative
    plus the larger of 1e-5 of the largest and ``floor``."""
    d = np.abs(got - want)
    tol = 1e-5 * np.abs(want) + max(1e-5 * np.abs(want).max(), floor)
    loose = int((d > tol).sum())
    assert loose <= max(1, int((1.0 - frac) * d.size)), \
        (name, loose, d.size, d.max())


#: leaves every model rank holds whole: their gradients must be whole too
#: (a missing copy_in leaves each rank its share)
REPLICATED = {"dense": ["final_norm.scale", "blocks.0.ln1.scale",
                        "blocks.1.ln2.scale"],
              "moe": ["final_norm.scale", "blocks.0.ln1.scale",
                      "blocks.0.moe.router", "blocks.1.moe.shared_coef"],
              "vlm": ["final_norm.scale", "blocks.1.ln2.scale"]}
REPLICATED.update({fam: REPLICATED["moe"] + ["blocks.0.moe.w_gate"]
                   for fam in ranks.GUARDED})

RUNS = ([(fam, shape) for fam in ranks.ARCHS for shape in ranks.SHAPES]
        + [(fam, kind) for fam in ranks.ARCHS for kind in ("accum", "ef")]
        + [(fam, (1, 4)) for fam in ranks.GUARDED])


@pytest.mark.parametrize("fam,run", RUNS,
                         ids=[f"{f}-{r if isinstance(r, str) else '%dx%d' % r}"
                              for f, r in RUNS])
def test_sharded_training_equals_unsharded(world, fam, run):
    res, _ = world
    want = _unsharded(fam, accum=2 if run == "accum" else 1,
                      ef=run == "ef")
    members = [r["runs"][(fam, run)] for r in res
               if (fam, run) in r["runs"]]
    shape = (2, 2) if isinstance(run, str) else run
    assert len(members) == int(np.prod(shape))
    for got in members:
        if got["loss"] is not None:
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            gmax = max(np.abs(g).max() for g in want["grads"].values())
            assert set(got["grads"]) == set(want["grads"])
            for name in REPLICATED[fam]:
                assert name in got["grads"], name
            for name, g in want["grads"].items():
                np.testing.assert_allclose(got["grads"][name], g, rtol=1e-4,
                                           atol=1e-6 * gmax, err_msg=name)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        # int8 error feedback: a code that flips across a rounding
        # boundary moves the norm by about one scale's worth
        np.testing.assert_allclose(got["norms"], want["norms"],
                                   rtol=1e-4 if run == "ef" else 1e-5)
        _check_params(got["params"], want["params"], got["lrs"],
                      frac=0.99 if run == "ef" else 0.999)
        assert got["ce_gap"] <= 1e-6 * max(1.0, abs(want["loss"]))
        assert got["vocab_split"] == (shape[1] > 1)


def test_the_moe_batch_drops_tokens_and_masks_labels(monkeypatch):
    """The moe case is the hard one: its batch overflows an expert's
    capacity, and two of its rows hold -1 labels."""
    lm = ranks.host_lm("moe")
    b = ranks.batch("moe")
    assert int((b["labels"] < 0).sum()) > b["labels"].shape[0]
    real, kept = moe_mod.route, []

    def route(*args, **kw):
        r = real(*args, **kw)
        kept.append((int(r.keep.sum()), r.keep.numel()))
        return r

    monkeypatch.setattr(moe_mod, "route", route)
    with torch.no_grad():
        lm.loss(b)
    assert len(kept) == lm.cfg.n_layers
    assert any(k < n for k, n in kept), kept


def test_each_rank_keeps_its_slices(world):
    """A rank's state holds its slice of every leaf: model-axis blocks,
    and on a data axis of 2 the d_model halves of the FSDP leaves; the
    rest of each leaf is elsewhere."""
    res, _ = world
    host = ranks.host_lm("moe")
    full = {k: tuple(p.shape) for k, p in host.named_parameters()}
    n_full = sum(int(np.prod(s)) for s in full.values())
    for r in res:
        got = r["runs"][("moe", "ef")]
        spec = step_mod.train_state_pspecs(host, DuckMesh((2, 2))).params
        for k, shape in got["local_shapes"].items():
            want = list(full[k])
            for d, entry in enumerate(spec[k]):
                names = (entry,) if isinstance(entry, str) else (entry or ())
                for a in names:
                    # the router stays whole on the model axis
                    if not (a == "model" and k.endswith(".moe.router")):
                        want[d] //= 2
            assert tuple(want) == shape, (k, shape, want)
        # params and first moments: one slice of each leaf apiece
        mine = sum(int(np.prod(s)) for s in got["local_shapes"].values())
        assert got["held"] == 2 * mine < n_full


def _trainer(lm, ckpt_dir, total, accum=1):
    adamw, sched = ranks.optim()
    return Trainer(lm, DataConfig(seq_len=ranks.TRAIN["seq"],
                                  global_batch=ranks.TRAIN["batch"],
                                  vocab=lm.cfg.vocab),
                   ranks.trainer_cfg(total, ckpt_dir, accum), adamw, sched)


def test_trainer_resumes_across_mesh_shapes(world, tmp_path):
    res, root = world
    plain = _trainer(ranks.host_lm("dense"), None, ranks.TRAIN["steps"])
    state = plain.run()
    want = [r["loss"] for r in plain.history]
    at = ranks.TRAIN["ckpt_at"]
    for r in res:
        np.testing.assert_allclose(r["saved"]["losses"], want[:at],
                                   rtol=1e-5)
    for r in res[:2]:
        assert r["resumed"]["step"] == ranks.TRAIN["steps"]
        np.testing.assert_allclose(r["resumed"]["losses"], want[at:],
                                   rtol=1e-5)
        _check_params(r["resumed"]["params"],
                      {k: v.detach().numpy()
                       for k, v in state.params.items()},
                      [ranks.SCHED["peak_lr"]] * ranks.TRAIN["steps"])
    assert latest_step(root) == ranks.TRAIN["steps"]
    # the unsharded Trainer resumes the (2, 2) run's checkpoint
    import shutil
    cut = tmp_path / "cut"
    cut.mkdir()
    name = f"step_{at:09d}"
    shutil.copytree(os.path.join(root, name), cut / name)
    (cut / f"{name}.COMMITTED").touch()
    again = _trainer(ranks.host_lm("dense"), str(cut), ranks.TRAIN["steps"])
    again.run()
    np.testing.assert_allclose([r["loss"] for r in again.history],
                               want[at:], rtol=1e-5)
    # two microbatches on (2, 1): each data rank reads its rows of each
    acc = _trainer(ranks.host_lm("dense"), None, ranks.TRAIN["steps"],
                   accum=2)
    acc.run()
    for r in res[:2]:
        np.testing.assert_allclose(r["accum"]["losses"],
                                   [h["loss"] for h in acc.history],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["accum"]["norms"],
                                   [h["grad_norm"] for h in acc.history],
                                   rtol=1e-5)


def test_train_launcher_trains_on_the_production_mesh(world, tmp_path):
    """``--mesh single`` and ``--mesh multi`` over the production mesh cut
    to (2, 2) and (1, 2, 2): exit 0, and the checkpoint at step 3 holds
    the unsharded launch's parameters, moments and error-feedback
    residuals (``--compress-grads``), held as the int8 runs above."""
    res, root = world
    d = str(tmp_path / "plain")
    args = ["--arch", ranks.ARCHS["dense"], "--smoke-dims", "--device",
            "cpu", "--dtype", "fp32", "--steps", "3", "--batch", "4",
            "--seq", "8", "--compress-grads", "--ckpt-dir"]
    assert train_launch.main(args + [d]) == 0
    cfg = get_arch(ranks.ARCHS["dense"]).smoke

    def restored(path):
        lm = LM(cfg, torch.float32, "cpu", param_dtype=torch.float32)
        from repro_torch.optim import AdamWConfig
        state = init_train_state(lm, AdamWConfig(grad_compression="int8_ef"))
        restore_checkpoint(path, 3, target=state)
        return state

    want = restored(d)
    for kind in ("single", "multi"):
        assert all(r[("launcher", kind)] == 0 for r in res)
        got = restored(f"{root}-{kind}")
        assert int(got.step) == 3 and int(got.opt.step) == 3
        _check_params({k: v.detach().numpy() for k, v in got.params.items()},
                      {k: v.detach().numpy()
                       for k, v in want.params.items()},
                      [3e-4] * 3, frac=0.99)
        for tree, ref in ((got.opt.m, want.opt.m), (got.opt.v, want.opt.v)):
            for k, v in ref.items():
                _mostly_close(k, tree[k].numpy(), v.numpy(), 0.99)
        # a residual is a gradient less its int8 code: its rounding is the
        # gradient's (amax ~ 254 x the residual's largest), not its own
        for k, v in want.opt.ef.items():
            v = v.numpy()
            _mostly_close(k, got.opt.ef[k].numpy(), v, 0.99,
                          254e-5 * np.abs(v).max())


def test_train_launcher_refuses_a_world_of_the_wrong_size(capsys):
    try:
        with pytest.raises(SystemExit) as e:
            train_launch.main(["--arch", ranks.ARCHS["dense"],
                               "--smoke-dims", "--device", "cpu", "--mesh",
                               "single", "--steps", "1"])
        assert e.value.code == 2
        assert ("the production mesh (16, 16) needs a world of 256 ranks; "
                "this one has 1") in capsys.readouterr().err
    finally:
        mesh_mod.leave_process_group()

