"""The hybrid, xlstm and encdec families on a mesh, on the CPU: the specs
against the JAX package, sharded against unsharded over spawned gloo
ranks.

* ``mamba2_block_specs``, ``mlstm_block_specs``/``slstm_block_specs``,
  the encoder and decoder specs, ``memory_specs`` and ``LM.param_specs``
  / ``param_pspecs`` of zamba2-1.2b, xlstm-350m and seamless-m4t-medium,
  at ``SMOKE`` and at full size, against the JAX functions flattened to
  the port's parameter names, on duck-typed meshes;
* the layout a rank really keeps (``LM.rank_pspecs``): the derived
  spec's block where it applies, and the departures: Mamba2's
  ``in_proj`` and conv by heads with ``B``/``C`` whole, the mLSTM by
  heads (``w_up``'s ``xm`` half whole), the sLSTM's recurrence whole;
* in one spawn of five gloo ranks (``tests/torch_family_mesh_ranks.py``):
  each family's SMOKE config, fp32, served on (1, 2), (2, 1) and (2, 2)
  meshes (the rest of the world as spares): prefill logits within 1e-5
  of max|logit| of the unsharded engine's, ``generate`` tokens (equal-
  length prompts) and, for the hybrid and xlstm, the scheduler's tokens
  equal; each rank's state split by heads; the hybrid (4 layers at
  ``attn_every`` 2: two applications of the shared block) re-meshed
  onto a spare after a kill, its tokens unchanged; seamless on (1, 4)
  with a vocab of 510, which 4 does not divide (the embedding and the
  head stay whole);
* in one spawn of four gloo ranks: one training step of each family on
  (1, 2), (2, 1) and (2, 2), and seamless on (1, 4) at vocab 510, on a
  4 x 12 batch whose rows 1 and 2 hold -1 labels: the loss within 1e-5
  relative, every gradient within 1e-4 relative plus 1e-6 of the largest
  (xlstm-350m at its tolerance in ``tests/test_torch_train_families.py``:
  1e-3 relative plus 3e-4 of the largest, the grad norm within 1e-3),
  the grad norm within 1e-5 relative, the parameters after the update
  within Adam's bound; each rank's slices match its layout.
"""

import os

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_arch as jax_get_arch
from repro.core.features import default_features as jax_features
from repro.models import encdec as jax_encdec
from repro.models import ssm as jax_ssm
from repro.models import xlstm as jax_xlstm
from repro.models.lm import LM as JaxLM
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import encdec, ssm, xlstm
from repro_torch.models.layers import (DEFAULT_RULES, ModelSplit,
                                       contract_split, expand_split,
                                       spec_tree_to_pspecs)
from repro_torch.models.lm import LM
from repro_torch.serve import engine as E
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train import step as step_mod

import torch_family_mesh_ranks as ranks

torch.set_num_threads(1)

ARCH_IDS = tuple(ranks.ARCHS.values())


class DuckMesh:
    def __init__(self, shape, names=("data", "model")):
        self.axis_names = names
        self.devices = np.empty(shape)


class _Axis:
    """A model axis of one process: its size and index, no collective."""

    def __init__(self, size, index):
        self.size, self.index = size, index


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


STACKED = ("mamba", "mlstm", "slstm", "encoder", "decoder")


def _jax_flat(want, names):
    """The JAX spec tree at the port's parameter ``names``: a stacked
    leaf (``mamba.in_proj``, its leading layers axis) serves each layer's
    name (``mamba.{i}.in_proj``) with that axis taken off."""
    flat = dict(_flat(want))
    out = {}
    for name in names:
        top, rest = name.split(".", 1)
        if top in STACKED:
            out[name] = tuple(flat[f"{top}.{rest.split('.', 1)[1]}"])[1:]
        else:
            out[name] = tuple(flat[name])
    return out


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def test_block_specs_match_jax():
    for arch in ARCH_IDS:
        for cfg, jcfg in ((get_arch(arch).config, jax_get_arch(arch).config),
                          (get_arch(arch).smoke, jax_get_arch(arch).smoke)):
            if cfg.family == "hybrid":
                assert ssm.mamba2_block_specs(cfg.mamba_config()) == \
                    jax_ssm.mamba2_block_specs(jcfg.mamba_config())
            elif cfg.family == "xlstm":
                xc, jxc = cfg.xlstm_config(), jcfg.xlstm_config()
                assert xlstm.mlstm_block_specs(xc) == \
                    jax_xlstm.mlstm_block_specs(jxc)
                assert xlstm.slstm_block_specs(xc) == \
                    jax_xlstm.slstm_block_specs(jxc)
            else:
                ec, jec = cfg.encdec_config(), jcfg.encdec_config()
                assert encdec.encoder_block_specs(ec) == \
                    jax_encdec.encoder_block_specs(jec)
                assert encdec.decoder_block_specs(ec) == \
                    jax_encdec.decoder_block_specs(jec)
                assert encdec.memory_specs() == jax_encdec.memory_specs()


@pytest.mark.parametrize("size", ["smoke", "config"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_pspecs_match_jax(arch, size):
    """Every weight's logical axes equal the reference's, and so does its
    derived spec on each mesh (the full configs' on ``meta``: no
    storage, as the reference's ``eval_shape``)."""
    cfg = getattr(get_arch(arch), size)
    jlm = JaxLM(getattr(jax_get_arch(arch), size),
                jax_features().with_(remat_policy="none"))
    lm = LM(cfg, torch.float32, "cpu" if size == "smoke" else "meta")
    got = lm.param_specs()
    assert set(got) == {n for n, _ in lm.named_parameters()}
    assert got == _jax_flat(jlm.param_specs(), got)
    jshapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    for mesh in (DuckMesh((2, 2)), DuckMesh((1, 4)), DuckMesh((16, 16)),
                 DuckMesh((2, 2, 2), ("pod", "data", "model"))):
        assert lm.param_pspecs(mesh) == _jax_flat(
            jlm.param_pspecs(mesh, jshapes), got), mesh.devices.shape


def _rank_blocks(lm_full, m, r, mesh):
    """Rank ``r``'s LM of ``m`` and the blocks the engine cuts for it."""
    from repro_torch.ft.elastic import local_slice
    names, sizes = mesh_mod.mesh_layout(mesh)
    lm = LM(lm_full.cfg, torch.float32, "cpu", tp=_Axis(m, r))
    params = dict(lm_full.named_parameters())
    pspecs = spec_tree_to_pspecs(lm_full.param_specs(), DEFAULT_RULES.replace(
        embed=None), mesh, shapes=params)
    specs = lm.rank_pspecs(pspecs, params)
    blocks = {k: local_slice(v, specs[k], names, sizes,
                             (0,) * (len(names) - 1) + (r,))
              for k, v in lm.expand_splits(params).items()}
    return lm, specs, blocks


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_layout_a_rank_keeps(arch, m):
    """The blocks the engine cuts fit the rank's LM; the derived spec
    holds wherever the layout does not depart from it, and the
    departures are the ones ROADMAP.md records."""
    full = ranks.host_lm({v: k for k, v in ranks.ARCHS.items()}[arch])
    mesh = DuckMesh((1, m))
    derived = spec_tree_to_pspecs(
        full.param_specs(), DEFAULT_RULES.replace(embed=None), mesh,
        shapes=dict(full.named_parameters()))
    parts = []
    for r in range(m):
        lm, specs, blocks = _rank_blocks(full, m, r, mesh)
        local = dict(lm.named_parameters())
        for k, b in blocks.items():
            assert b.shape == local[k].shape, (k, b.shape, local[k].shape)
        splits = lm.model_splits()
        for k, spec in specs.items():
            if k in splits:
                continue
            if spec != derived[k]:          # kept whole: model dropped
                assert local[k].shape == dict(full.named_parameters())[
                    k].shape, k
        parts.append(blocks)
    cfg = full.cfg
    if cfg.family == "hybrid":
        mc = cfg.mamba_config()
        di, gn, h = mc.d_inner, mc.d_state, mc.num_heads
        w = full.mamba[0].in_proj.detach()
        got = parts[1]["mamba.0.in_proj"]
        z = w[:, :di].chunk(m, 1)[1]
        x = w[:, di:2 * di].chunk(m, 1)[1]
        bc = w[:, 2 * di:2 * di + 2 * gn]                 # whole
        dt = w[:, 2 * di + 2 * gn:].chunk(m, 1)[1]
        assert torch.equal(got, torch.cat([z, x, bc, dt], 1))
        assert got.shape[1] == 2 * di // m + 2 * gn + h // m
        assert specs["mamba.0.in_proj"] == derived["mamba.0.in_proj"]
    elif cfg.family == "xlstm":
        assert specs["mlstm.0.wq"] == (None, "model", None)
        assert derived["mlstm.0.wq"] == ("model", None, None)
        di = cfg.xlstm_config().d_inner
        assert torch.equal(parts[1]["mlstm.0.w_up"][:, :di],
                           full.mlstm[0].w_up.detach()[:, :di])
        for k in ("slstm.0.w_gates", "slstm.0.r_gates", "slstm.0.b_gates"):
            assert "model" not in str(specs[k]), k          # whole
        assert specs["slstm.0.w_ff_down"] == derived["slstm.0.w_ff_down"]
    else:
        assert all(specs[k] == derived[k] for k in specs
                   if not k.startswith(("embed", "lm_head")))
    # the ranks' blocks put back together give the whole model
    for k, p in full.named_parameters():
        split = lm.model_splits().get(k)
        spec = specs[k]
        dim = next((d for d, e in enumerate(spec)
                    if "model" in ((e,) if isinstance(e, str)
                                   else (e or ()))), None)
        if dim is None:
            assert all(torch.equal(b[k], p.detach()) for b in parts), k
            continue
        joined = torch.cat([b[k] for b in parts], dim)
        if split is not None:
            joined = contract_split(joined, split, m)
        assert torch.equal(joined, p.detach()), k


def test_rank_configs_carry_the_model_axis_as_a_field():
    # a rank's Mamba2 and xLSTM configs hold the model axis in a field,
    # so _replace keeps it (and the rank's sizes with it)
    from repro_torch.launch.dryrun import CountingAxis
    axis = CountingAxis(2)
    for arch in ("zamba2-1.2b", "xlstm-350m"):
        cfg = get_arch(arch).smoke
        lm = LM(cfg, torch.float32, "meta", tp=axis)
        if cfg.family == "hybrid":
            mc, whole = lm.mamba_config(), cfg.mamba_config()
            assert mc.tp is axis and whole.tp is None
            assert (mc.d_inner, mc.num_heads) == (whole.d_inner // 2,
                                                  whole.num_heads // 2)
            again = mc._replace(chunk_size=mc.chunk_size // 2)
            assert again.tp is axis and again.d_inner == mc.d_inner
        else:
            xc, whole = lm.xlstm_config(), cfg.xlstm_config()
            assert xc.tp is axis and whole.tp is None
            assert xc.local_heads == whole.num_heads // 2
            assert xc.tp_ff is (axis if whole.d_ff % 2 == 0 else None)
            again = xc._replace(chunk_size=xc.chunk_size // 2)
            assert (again.tp, again.tp_ff, again.local_heads) == \
                (xc.tp, xc.tp_ff, xc.local_heads)


def test_expand_and_contract_split_are_inverse():
    full = torch.arange(2 * 23, dtype=torch.float32).reshape(2, 23)
    sp = ModelSplit(1, ((8, True), (8, True), (3, False), (4, True)))
    ex = expand_split(full, sp, 4)
    assert ex.shape == (2, 4 * (2 + 2 + 3 + 1))
    assert torch.equal(contract_split(ex, sp, 4), full)
    assert torch.equal(expand_split(full, sp, 1), full)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """(the unsharded port's results by run key, every rank's)."""
    tmp = tmp_path_factory.mktemp("family-mesh")
    weights, want = {}, {}
    for fam in ranks.ARCHS:
        for change in ((None, ranks.VOCAB4) if fam == "encdec"
                       else (None,)):
            lm = ranks.host_lm(fam, change)
            key = (fam, bool(change))
            weights[key] = os.path.join(tmp, f"{fam}-{bool(change)}.pt")
            torch.save(lm.state_dict(), weights[key])
            plain = LM(lm.cfg, torch.float32, "cpu")
            plain.load_state_dict(lm.state_dict())
            want[key] = ranks.serve(E, plain, fam,
                                    scheduler=fam != "encdec")[:3]
    got = mesh_mod.spawn(ranks.serve_world, 5, args=(weights,),
                         timeout_s=240)
    return want, got


def _logits_close(got, want):
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape", ranks.SHAPES,
                         ids=["%dx%d" % s for s in ranks.SHAPES])
@pytest.mark.parametrize("fam", list(ranks.ARCHS))
def test_sharded_serving_equals_unsharded(serving, fam, shape):
    want, got = serving
    logits, gen, toks = want[(fam, False)]
    assert len({tuple(t) for t in gen}) > 1
    n = int(np.prod(shape))
    for r in got:
        res = r[(fam, shape)]
        assert res["member"] == (r["rank"] < n)
        assert res["generate"] == gen
        assert res["tokens"] == toks
        if res["member"]:
            _logits_close(res["logits"], logits)


@pytest.mark.parametrize("fam", list(ranks.ARCHS))
def test_each_rank_holds_its_heads_of_the_state(serving, fam):
    """On (1, 2) a rank's decode state holds half the heads: the
    hybrid's SSD state and shared-block KV, its conv tail's x channels
    (B and C whole); the mLSTM's C and n (the sLSTM's state whole); the
    encdec's self-attention caches and cross memory."""
    _, got = serving
    cfg = ranks.config(fam)
    full = LM(cfg, torch.float32, "cpu").init_decode_state(
        ranks.SERVE["batch_slots"], ranks.SERVE["max_seq"])
    whole = dict(ranks._named(full))
    for r in got[:2]:
        held = r[(fam, (1, 2))]["held"]["state"]
        assert set(held) == set(whole)
        for k, shape in held.items():
            want = list(whole[k].shape)
            if fam == "hybrid" and k.startswith("mamba.conv"):
                mc = cfg.mamba_config()
                want[-1] = mc.d_inner // 2 + 2 * mc.d_state
            elif fam == "hybrid" and k.startswith("mamba.ssd"):
                want[2] //= 2
            elif fam == "xlstm" and k.startswith("mlstm"):
                want[2] //= 2
            elif len(want) == 5:                    # KV caches, memory
                want[3] //= 2
            assert tuple(want) == shape, (k, shape, want)


def test_hybrid_remeshes_onto_a_spare(serving):
    """Rank 1 dies at segment 1: the spare (rank 2) takes its model index,
    receives its SSD state, conv tail and KV slice from it, and the
    scheduler's tokens stay the unsharded ones."""
    want, got = serving
    for r in got:
        res = r[("hybrid", "kill")]
        assert res["tokens"] == want[("hybrid", False)][2]
        assert res["remeshes"] == 1 and res["device_ids"] == [0, 2]
        assert res["member"] == (r["rank"] in (0, 2))


def test_encdec_on_a_model_axis_its_vocab_does_not_divide(serving):
    want, got = serving
    logits, gen, _ = want[("encdec", True)]
    for r in got:
        res = r[("encdec", (1, 4))]
        assert res["generate"] == gen
        assert res["member"] == (r["rank"] < 4)
        if res["member"]:
            assert res["vocab_rows"] == 510             # whole
            _logits_close(res["logits"], logits)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

#: (gradient rtol, atol over the largest, grad-norm rtol)
TRAIN_TOL = {"xlstm": (1e-3, 3e-4, 1e-3)}


@pytest.fixture(scope="module")
def training():
    return mesh_mod.spawn(ranks.train_world, 4, timeout_s=240)


def _unsharded(fam, change=None):
    lm = ranks.host_lm(fam, change).requires_grad_(True)
    adamw, sched = ranks.optim()
    b = ranks.batch(fam, change)
    loss, _, grads = step_mod._grads(lm, dict(lm.named_parameters()), b)
    state = init_train_state(lm, adamw)
    state, m = make_train_step(lm, adamw, sched)(state, b)
    return dict(loss=float(loss), grads={k: v.numpy()
                                         for k, v in grads.items()},
                step_loss=float(m["loss"]), norm=float(m["grad_norm"]),
                params={k: v.detach().numpy()
                        for k, v in state.params.items()})


RUNS = ([(fam, shape) for fam in ranks.ARCHS for shape in ranks.SHAPES]
        + [("encdec", (1, 4))])


@pytest.mark.parametrize("fam,shape", RUNS,
                         ids=[f"{f}-%dx%d" % s for f, s in RUNS])
def test_sharded_training_equals_unsharded(training, fam, shape):
    change = ranks.VOCAB4 if shape == (1, 4) else None
    want = _unsharded(fam, change)
    rtol, atol, ntol = TRAIN_TOL.get(fam, (1e-4, 1e-6, 1e-5))
    gmax = max(np.abs(g).max() for g in want["grads"].values())
    members = [r["runs"][(fam, shape)] for r in training
               if (fam, shape) in r["runs"]]
    assert len(members) == int(np.prod(shape))
    for got in members:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["step_loss"], want["step_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["norm"], want["norm"], rtol=ntol)
        assert set(got["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g, rtol=rtol,
                                       atol=atol * gmax, err_msg=name)
        bound = 2.0 * got["lr"] + 1e-6
        for name, w in want["params"].items():
            assert np.abs(got["params"][name] - w).max() <= bound, name


def test_each_rank_trains_its_slices(training):
    """On (2, 2) a rank's state holds its layout's slice of each leaf:
    model-axis blocks (Mamba2's in_proj by heads with B and C whole, the
    mLSTM by heads, the sLSTM's recurrence whole) and the d_model halves
    of the FSDP leaves."""
    mesh = DuckMesh((2, 2))
    for fam in ranks.ARCHS:
        host = ranks.host_lm(fam)
        specs = step_mod.train_state_pspecs(host, mesh).params
        lm = LM(host.cfg, torch.float32, "cpu", tp=_Axis(2, 0))
        rank_specs = lm.rank_pspecs(specs, dict(host.named_parameters()))
        local = dict(lm.named_parameters())
        for r in training:
            got = r["runs"][(fam, (2, 2))]["local_shapes"]
            for k, shape in got.items():
                want = list(local[k].shape)
                for d, e in enumerate(rank_specs[k]):
                    if "data" in ((e,) if isinstance(e, str) else (e or ())):
                        want[d] //= 2
                assert tuple(want) == shape, (fam, k, shape, want)
