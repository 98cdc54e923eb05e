"""The port's ``Engine.generate`` against the JAX engine, on the CPU.

qwen2-0.5b ``SMOKE`` in fp32 with the JAX ``LM.init`` parameters bridged
over (the embedding table scaled by 0.1 on both sides, so the random model
does not just echo its last input token): greedy tokens over ragged
prompts must equal the JAX engine's, dense and paged, with one host sync
per call.  The same for zamba2-1.2b ``SMOKE`` (hybrid: Mamba2 plus a
shared block) on equal-length prompts longer than a chunk, with dense KV
only.  Also: eos, ``kv_dtype`` pages, the unported ServeConfig fields and
``extra_batch``, sampled decoding now running, the
no-GPU rule, and that importing the port (the scheduler, the pool, the
launcher and the SSD scan included) never imports JAX or the JAX package.
"""

import dataclasses
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro_torch
from repro.configs.qwen2_0_5b import SMOKE as JAX_SMOKE
from repro.configs.zamba2_1_2b import SMOKE as JAX_ZAMBA_SMOKE
from repro.core.features import default_features
from repro.models.lm import LM as JaxLM
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs.qwen2_0_5b import SMOKE
from repro_torch.configs.zamba2_1_2b import SMOKE as ZAMBA_SMOKE
from repro_torch.models.lm import LM
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(1)

PROMPT_LENS = (10, 3, 1, 6)
MAX_NEW = 8


@pytest.fixture(scope="module")
def models():
    jlm = JaxLM(JAX_SMOKE, default_features().with_(remat_policy="none"),
                dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * 0.1
    lm = LM(SMOKE, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, SMOKE))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, SMOKE.vocab, n).tolist() for n in PROMPT_LENS]
    return jlm, jax.tree.map(jnp.asarray, jparams), lm, prompts


@pytest.mark.parametrize("page_size", [0, 4])
def test_generate_matches_jax_engine(models, page_size):
    jlm, jparams, lm, prompts = models
    want = JaxEngine(jlm, jparams, JaxServeConfig(
        max_seq=64, page_size=page_size)).generate(prompts, MAX_NEW)
    eng = Engine(lm, ServeConfig(max_seq=64, page_size=page_size),
                 device="cpu")
    got = eng.generate(prompts, MAX_NEW)
    assert got == want
    assert eng.host_syncs == 1
    assert len({tuple(t) for t in got}) > 1          # not a degenerate echo
    got2 = eng.generate(prompts, MAX_NEW)            # deterministic, 1 more
    assert got2 == want and eng.host_syncs == 2


def test_paged_equals_dense_and_eos_stops_rows(models):
    jlm, jparams, lm, prompts = models
    dense = Engine(lm, ServeConfig(max_seq=64), device="cpu")
    base = dense.generate(prompts, MAX_NEW)
    assert Engine(lm, ServeConfig(max_seq=64, page_size=8),
                  device="cpu").generate(prompts, MAX_NEW) == base
    eos = base[0][2]                     # row 0 stops after its 3rd token
    sc = dict(max_seq=64, page_size=4, eos_token=eos)
    got = Engine(lm, ServeConfig(**sc), device="cpu").generate(prompts,
                                                               MAX_NEW)
    want = JaxEngine(jlm, jparams, JaxServeConfig(**sc)).generate(prompts,
                                                                  MAX_NEW)
    assert got == want
    assert got[0] == base[0][:base[0].index(eos) + 1]
    for row, full in zip(got, base):
        assert row == (full[:full.index(eos) + 1] if eos in full else full)


def test_unported_serve_options_raise_and_scheduler_fields_pass(models):
    _, _, lm, prompts = models
    # kernel pins are ported: the JAX package's names map onto the port's
    # (the kernels' impls, which run their plain versions on the CPU) and
    # the tokens do not move; a bad name is refused at construction
    want = Engine(lm, ServeConfig(page_size=4), device="cpu").generate(
        prompts[:2], 3)
    for kw in (dict(impls={"attention": "pallas_flash"}),
               dict(attn_impl="pallas_flash")):
        assert Engine(lm, ServeConfig(page_size=4, **kw),
                      device="cpu").generate(prompts[:2], 3) == want
    with pytest.raises(ValueError, match="unknown attention impl"):
        Engine(lm, ServeConfig(page_size=4, impls={"attention": "bogus"}),
               device="cpu")
    eng = Engine(lm, ServeConfig(max_seq=64, prefix_cache=False,
                                 batch_slots=2, admission_chunk=3,
                                 pool_pages=5), device="cpu")
    assert eng.generate(prompts[:1], 2)
    # extra_batch is ported: a key the family does not read is ignored,
    # as the JAX engine ignores it (patch embeddings feed the vlm family)
    assert eng.generate(prompts[:1], 2, extra_batch={
        "patch_embeds": np.zeros((1, 2, SMOKE.d_model), np.float32)}) == \
        eng.generate(prompts[:1], 2)
    # temperature > 0 is ported: sampled top-k / top-p decoding runs
    for kw in (dict(temperature=0.7), dict(temperature=0.7, top_k=5),
               dict(temperature=0.7, top_p=0.9)):
        sampled = Engine(lm, ServeConfig(max_seq=64, page_size=4, **kw),
                         device="cpu").generate(prompts[:2], 3)
        assert [len(t) for t in sampled] == [3, 3]
        assert all(0 <= tok < SMOKE.vocab for t in sampled for tok in t)
    # kv_dtype is ported: paged generate stores fp32 or int8 pages
    for kv in ("fp32", "int8"):
        assert Engine(lm, ServeConfig(max_seq=64, page_size=4, kv_dtype=kv),
                      device="cpu").generate(prompts[:2], 3)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(prompts, 60)
    # field names and defaults follow the JAX ServeConfig
    ours = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxServeConfig)}
    assert ours == theirs


@pytest.fixture(scope="module")
def zamba_models():
    jlm = JaxLM(JAX_ZAMBA_SMOKE, default_features().with_(
        remat_policy="none"), dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * 0.1
    lm = LM(ZAMBA_SMOKE, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, ZAMBA_SMOKE))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, ZAMBA_SMOKE.vocab, 20).tolist()
               for _ in range(3)]
    return jlm, jax.tree.map(jnp.asarray, jparams), lm, prompts


def test_zamba2_generate_matches_jax_engine(zamba_models):
    jlm, jparams, lm, prompts = zamba_models
    want = JaxEngine(jlm, jparams, JaxServeConfig(max_seq=64)).generate(
        prompts, MAX_NEW)
    eng = Engine(lm, ServeConfig(max_seq=64), device="cpu")
    got = eng.generate(prompts, MAX_NEW)
    assert got == want
    assert eng.host_syncs == 1
    assert len({tuple(t) for t in got}) > 1
    # the recurrent family takes no page pool, as in the reference
    for sc in (dict(page_size=4), dict(page_size=4, kv_dtype="int8")):
        with pytest.raises(ValueError, match="attention-cache family"):
            Engine(lm, ServeConfig(max_seq=64, **sc), device="cpu")
        with pytest.raises(ValueError, match="attention-cache family"):
            JaxEngine(jlm, jparams, JaxServeConfig(max_seq=64, **sc))


def test_engine_without_device_raises_on_a_host_without_cuda(models,
                                                              monkeypatch):
    _, _, lm, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(lm, ServeConfig())


def test_importing_the_port_never_imports_jax_or_the_jax_package():
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    for mod in ("repro_torch.serve.engine", "repro_torch.serve.kv_pool",
                "repro_torch.serve.admission", "repro_torch.ft.straggler",
                "repro_torch.launch.cli", "repro_torch.launch.serve",
                "repro_torch.kernels.stream_triad",
                "repro_torch.kernels.jacobi7", "repro_torch.core.hwinfo",
                "repro_torch.core.events", "repro_torch.core.groups",
                "repro_torch.core.perfctr", "repro_torch.core.marker",
                "repro_torch.core.roofline", "repro_torch.core.bandwidth",
                "repro_torch.bench.bench_bandwidth_map",
                "repro_torch.bench.bench_stream_pinning",
                "repro_torch.bench.bench_stencil_pinning",
                "repro_torch.bench.bench_jacobi_traffic",
                "repro_torch.kernels.ssd_scan",
                "repro_torch.models.linear_scan", "repro_torch.models.ssm",
                "repro_torch.configs.zamba2_1_2b"):
        assert mod in names
    assert len(names) >= 39
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    code = ("import importlib, json, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
