"""The dry run (a shape-and-count walk of one rank on the ``meta``
device) and its CLIs, on the CPU, against the JAX package where the two
answer the same question.

* ``n_params`` / ``n_active_params`` of every arch's decode_32k record
  equal the JAX ``LM(spec.config).num_params()`` /
  ``num_active_params()`` (``eval_shape``, no allocation);
* every arch x shape's ``skipped`` status and reason follow the JAX
  logic (``get_arch(a).skipped(s)``, or "full-attention arch skips
  long_500k" for an arch that is not sub-quadratic);
* ``input_specs``' shapes and dtypes equal the JAX ``input_specs``';
* on every arch's SMOKE config the meta walk of a train, prefill and
  decode step declares the FLOPs, bytes and launches a real CPU run of
  the same step declares (fp32);
* the counting axis's collectives on a (1, 2) cell equal, kind by kind,
  those two gloo ranks declare running the same step
  (``tests/torch_family_mesh_ranks.py``): the prefill and decode walks
  over a state cut by ``LM.state_pspecs`` (the sequence over the model
  axis), and also a decode under ``kv_shard="headdim"`` and a train
  step under ``act_seq -> model``;
* a sweep without a ``cell_fn`` runs cold, then warm from the cache
  with no walks;
* the CLIs: ``dryrun`` writes records, ``roofline_report`` renders them
  and names the picks (also through ``--sweep``), ``perfctr``'s
  ``--list-groups``, ``--json`` and ``--execute --device cpu``.

Never imports ``repro.launch.dryrun``: it sets ``XLA_FLAGS`` for 512 host
devices at import.
"""

import json

import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs import input_specs as jax_input_specs
from repro.core.features import default_features as jax_features
from repro.models.lm import LM as JaxLM
from repro_torch.configs import ALL_ARCH_IDS, SHAPES, get_arch, input_specs
from repro_torch.configs.base import Shape
from repro_torch.core.session import ProfileSession
from repro_torch.launch import dryrun, perfctr, roofline_report
from repro_torch.launch import mesh as mesh_mod

import torch_family_mesh_ranks as ranks

torch.set_num_threads(1)

#: the JAX dtypes' torch counterparts
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(scope="module")
def decode_records(tmp_path_factory):
    sess = ProfileSession(cache_dir=str(tmp_path_factory.mktemp("dry")))
    return {a: dryrun.run_cell(a, "decode_32k", False, verbose=False,
                               session=sess) for a in ALL_ARCH_IDS}


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_param_counts_match_jax(decode_records, arch):
    rec = decode_records[arch]
    assert rec["status"] == "ok", rec.get("trace")
    jlm = JaxLM(jax_get_arch(arch).config,
                jax_features().with_(remat_policy="none"))
    assert rec["n_params"] == jlm.num_params()
    assert rec["n_active_params"] == jlm.num_active_params()
    assert rec["cell"] == f"{arch}/decode_32k/16x16"
    assert rec["memory_analysis"]["argument_bytes"] > 0
    assert rec["roofline"]["bound"] in ("compute", "memory", "nvlink")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_skips_follow_the_jax_logic(arch, shape):
    spec = jax_get_arch(arch)
    want = spec.skipped(shape)
    if want is None and shape == "long_500k" and \
            not spec.config.sub_quadratic:
        want = "full-attention arch skips long_500k"
    assert dryrun.skip_reason(get_arch(arch), shape) == want
    if want is not None:
        rec = dryrun.run_cell(arch, shape, True, verbose=False)
        assert rec == {"cell": f"{arch}/{shape}/2x16x16",
                       "status": "skipped", "reason": want}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_input_specs_match_jax(arch, shape):
    assert SHAPES[shape] == Shape(**vars(JAX_SHAPES[shape]))
    got = input_specs(get_arch(arch).config, SHAPES[shape])
    want = jax_input_specs(jax_get_arch(arch).config, JAX_SHAPES[shape])
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == DTYPES[w.dtype.type], k


DECLARED = ("FLOPS_TOTAL", "FLOPS_F32", "BYTES_ACCESSED", "HBM_ARG_BYTES",
            "HBM_OUT_BYTES", "LAUNCHES")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_the_walk_declares_what_a_run_declares(arch, kind):
    cfg = get_arch(arch).smoke
    kw = dict(seq_len=16, dtype=torch.float32,
              policy=dryrun.TrainPolicy(accum_steps=2))
    meta = input_specs(cfg, Shape("walk", 16, 2, kind))
    real = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in meta.items()}
    walked = dryrun.walk(cfg, kind, meta, **kw)
    ran = dryrun.walk(cfg, kind, real, device="cpu", **kw)
    for k in DECLARED:
        assert walked["events"][k] == ran["events"][k], k
    assert walked["events"]["FLOPS_TOTAL"] > 0
    assert walked["calls"] == ran["calls"]
    for k in ("argument_bytes", "output_bytes", "state_bytes",
              "n_params"):
        assert walked[k] == ran[k], k


@pytest.fixture(scope="module")
def gloo_collectives():
    return mesh_mod.spawn(ranks.walk_world, 2, timeout_s=240)


@pytest.mark.parametrize("kind", ranks.WALK_KINDS)
@pytest.mark.parametrize("arch", ranks.WALK_ARCHS)
def test_counting_axis_matches_the_gloo_ranks(gloo_collectives, arch,
                                              kind):
    cfg = get_arch(arch).smoke
    walked = dryrun.walk(cfg, kind, ranks.walk_batch(cfg, kind, "meta"),
                         mesh_shape=(1, 2), seq_len=ranks.WALK_SEQ,
                         dtype=torch.float32,
                         policy=dryrun.TrainPolicy(accum_steps=1))
    want = {k: v for k, v in walked["events"].counts.items()
            if k.startswith("ICI_")}
    assert want["ICI_AR_COUNT"] > 0
    for r in gloo_collectives:
        assert r[(arch, kind)] == want


@pytest.mark.parametrize("arch,kind,layout", ranks.WALK_LAYOUTS)
def test_counting_axis_matches_the_gloo_ranks_under_layouts(
        gloo_collectives, arch, kind, layout):
    cfg = get_arch(arch).smoke
    walked = dryrun.walk(cfg, kind, ranks.walk_batch(cfg, kind, "meta"),
                         mesh_shape=(1, 2), seq_len=ranks.WALK_SEQ,
                         dtype=torch.float32,
                         rules=ranks.walk_rules(kind, layout),
                         policy=dryrun.TrainPolicy(accum_steps=1))
    want = {k: v for k, v in walked["events"].counts.items()
            if k.startswith("ICI_")}
    assert want["ICI_AR_COUNT"] > 0
    if layout == "sp":
        assert want["ICI_RS_COUNT"] > 0
    for r in gloo_collectives:
        assert r[(arch, kind, layout)] == want


def test_sweep_runs_cold_then_warm(tmp_path):
    cells = (["zamba2-1.2b", "qwen2-0.5b"], ["decode_32k", "long_500k"])
    cold = ProfileSession(cache_dir=str(tmp_path / "c"))
    first = cold.sweep(*cells, parallel=2)
    assert [r["status"] for r in first] == ["ok", "ok", "ok", "skipped"]
    assert cold.lowerings == 3
    warm = ProfileSession(cache_dir=str(tmp_path / "c"))
    again = warm.sweep(*cells, parallel=2)
    assert warm.lowerings == 0
    for a, b in zip(first, again):
        if a["status"] == "ok":
            assert b.pop("cache") == "hit"
            assert json.loads(json.dumps(a, default=float)) == \
                json.loads(json.dumps(b, default=float))
            assert set(b["derived"]) == {"ROOFLINE"}


def test_dryrun_and_roofline_report_clis(tmp_path, capsys,
                                         monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))
    out = str(tmp_path / "recs")
    assert dryrun.main(["--arch", "zamba2-1.2b", "--shape", "decode_32k",
                        "--out", out, "--json",
                        str(tmp_path / "d.json")]) == 0
    assert json.load(open(tmp_path / "d.json"))["failures"] == 0
    assert roofline_report.main(["--records", out, "--sweep", "--archs",
                                 "xlstm-350m", "--shapes",
                                 "decode_32k,long_500k", "--parallel", "1",
                                 "--json", str(tmp_path / "r.json")]) == 0
    text = capsys.readouterr().out
    assert "Tn ms" in text and "VMEM" not in text and "ICI" not in text
    summary = json.load(open(tmp_path / "r.json"))
    cells = {c["cell"] for c in summary["cells"]}
    assert cells == {"zamba2-1.2b/decode_32k/16x16",
                     "xlstm-350m/decode_32k/16x16",
                     "xlstm-350m/long_500k/16x16"}
    for pick in ("worst_mfu_bound", "most_collective_bound",
                 "most_representative"):
        assert summary["hillclimb"][pick] in cells
        assert f"{pick}: " in text
    assert roofline_report.main(["--records", out, "--mesh",
                                 "2x16x16"]) == 1


def test_perfctr_cli(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))
    assert perfctr.main(["--list-groups"]) == 0
    assert "ROOFLINE" in capsys.readouterr().out
    path = str(tmp_path / "p.json")
    assert perfctr.main(["-g", "ROOFLINE,ICI", "--arch", "zamba2-1.2b",
                         "--shape", "decode_32k", "--execute", "--device",
                         "cpu", "--json", path]) == 0
    text = capsys.readouterr().out
    assert "Measuring group ICI" in text and "[multiplex]" in text
    rec = json.load(open(path))
    assert rec["status"] == "ok" and rec["wall_s"] > 0
    assert rec["events"]["ICI_AR_COUNT"] > 0
    # warm: the record comes from the cache, nothing walked
    assert perfctr.main(["--arch", "zamba2-1.2b", "--shape",
                         "decode_32k"]) == 0
    assert "0 timed probes" in capsys.readouterr().out
    assert perfctr.main(["--arch", "qwen2-0.5b", "--shape",
                         "long_500k"]) == 1
