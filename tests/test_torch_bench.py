"""The port's serving benches and their runner, on the CPU.

* every bench's ``run(device="cpu")`` at ``--smoke`` holds its claims
  and returns the JAX bench summary's keys where their meaning carries;
* the declared traffic of one qwen2-0.5b SMOKE decode step equals a hand
  count, dense and paged, fp32 and int8 pages, for the CPU's plain impl
  (no launch) and pinned to the kernel's impl (one launch a layer), and
  so does qwen2-moe-a2.7b SMOKE's, its experts counted from the capacity; the
  flash and paged kernels' models equal brute-force counts;
* slice parity: bench_serve's smoke model, built by the JAX ``LM.init``
  and bridged, gives the JAX engine's greedy tokens on the bench's
  prompts (fp32), and so do bench_spec's fp32 legs (its own target and
  drafts, bridged from the JAX bench's ``_build``);
* the runner and each bench exit non-zero on a missed speed bar (the
  bar check itself; no speed is asserted on the CPU);
* the tool layer's benches: the stream pinning bench's placement half
  gives the JAX bench's hop costs and row, the marker-overhead and
  perfctr benches run at ``--smoke`` on the CPU, and
  ``examples/case_study_stream_torch.py`` prints the reference's table.
"""

import dataclasses
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import bench_spec as jax_bench_spec  # noqa: E402
from repro.core.features import default_features  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.models.lm import LMConfig as JaxLMConfig  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve.spec import SpecConfig as JaxSpecConfig  # noqa: E402
from repro_torch.bench import (bench_flash_prefill,  # noqa: E402
                               bench_paged_decode, bench_serve, bench_spec,
                               bench_stream_pinning, common, run)
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.qwen2_0_5b import SMOKE  # noqa: E402
from repro_torch.configs.qwen2_moe_a2_7b import (  # noqa: E402
    SMOKE as MOE_SMOKE)
from repro_torch.core import events  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import flash_traffic  # noqa: E402
from repro_torch.kernels.paged_decode import paged_traffic  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.serve.spec import SpecConfig  # noqa: E402

torch.set_num_threads(1)

BENCHES = {"serve": bench_serve, "paged_decode": bench_paged_decode,
           "flash_prefill": bench_flash_prefill, "spec": bench_spec}

#: the JAX benches' summary keys whose meaning carries to the port
#: (the autotune halves wait for the kernel registry)
JAX_KEYS = {
    "serve": {"fused_tok_s", "reference_tok_s", "speedup",
              "host_syncs_fused", "host_syncs_reference", "continuous_tok_s",
              "ttft_ms", "tokens", "decode_bytes_per_token",
              "paged_prefix_tok_s", "prefix_hit_rate", "pages_shared",
              "cow_copies", "pool_occupancy"},
    "paged_decode": {"page_size", "max_seq", "mixes", "prefix_cache",
                     "int8"},
    "flash_prefill": {"shape", "impl_us", "parity_max_err"},
    "spec": {"k", "n_layers", "max_new", "target_only", "high", "low"},
}


@pytest.fixture(scope="module")
def summaries():
    out = {}
    for name, mod in BENCHES.items():
        csv = []
        out[name] = (mod.run(csv, smoke=True, device="cpu"), csv)
    return out


@pytest.mark.parametrize("name", sorted(BENCHES))
def test_bench_claims_hold_and_summary_keys_carry(summaries, name):
    summary, csv = summaries[name]
    assert JAX_KEYS[name] <= set(summary), JAX_KEYS[name] - set(summary)
    assert csv and all(len(row) == 3 for row in csv)
    for b in summary.get("bars", {}).values():
        assert set(b) == {"value", "bar", "met"}
        assert b["met"] == (b["value"] >= b["bar"])
    if name == "serve":
        assert summary["host_syncs_fused"] == 1
        assert summary["host_syncs_reference"] == 32     # one a token
        assert summary["decode_bytes_per_token"] > 0
        assert summary["bars"]["fused_speedup"]["bar"] == 2.0
    elif name == "paged_decode":
        mixes = summary["mixes"]
        assert set(mixes) == {"short_ctx", "long_ctx", "mixed_ragged"}
        assert mixes["mixed_ragged"]["ratio"] <= 0.5
        assert summary["int8"]["ratio"] <= 0.6
        pc = summary["prefix_cache"]
        assert pc["prefill_flop_drop"] >= 0.5 * pc["prefix_hit_rate"] > 0
    elif name == "flash_prefill":
        assert max(summary["parity_max_err"].values()) < 1e-4
        assert summary["qwen2"]["shape"]["h"] == 14
        assert summary["library_us"] > 0
    else:
        assert summary["high"]["accept_rate"] > 0.95
        assert summary["low"]["accept_rate"] < summary["high"]["accept_rate"]
        assert summary["bars"]["high_speedup"]["bar"] == 1.5


# ---------------------------------------------------------------------------
# declared traffic: one qwen2 SMOKE decode step by hand
# ---------------------------------------------------------------------------

LENGTHS = [5, 17, 0]


def _hand_count(paged: bool, int8: bool, smax: int, ps: int):
    """(flops, arg bytes, out bytes, launches) of one fp32 decode step of
    qwen2 SMOKE over ``LENGTHS``, from the config alone."""
    c = SMOKE
    d, L, H, KVH, V, F = (c.d_model, c.n_layers, c.num_heads,
                          c.num_kv_heads, c.vocab, c.d_ff)
    dh, B, f = d // H, len(LENGTHS), 4
    mat = d * H * dh + 2 * d * KVH * dh + H * dh * d + 3 * d * F
    layer = mat + 2 * d + H * dh + 2 * KVH * dh       # norms and biases
    weights = f * (L * layer + d)                      # + final norm
    head = f * d * V                                   # the tied table
    flops = 2 * B * L * mat + 2 * B * d * V
    arg = weights + head + B * (f * d + 4)             # rows and ids
    page_isz, scale = (1, 4) if int8 else (f, 0)
    out = f * B * V + 2 * L * B * (KVH * dh * (page_isz if paged else f)
                                   + scale)
    launches = 0
    if not paged:
        # the masked dense decode reads the whole K and V buffers
        arg += 2 * L * B * smax * KVH * dh * f
        flops += 4 * L * B * H * smax * dh
    else:
        g = H // KVH
        live = sum(-(-n // ps) for n in LENGTHS)
        per_tok = 2 * KVH * dh * page_isz + (8 if int8 else 0)
        qo = B * KVH * g * dh * f
        arg += L * (qo + 2 * B * KVH * dh * f + 4 * B
                    + live * (ps * per_tok + 4))
        out += L * qo
        flops += L * 4 * dh * KVH * g * sum(n + 1 for n in LENGTHS)
        launches = L
    return flops, arg, out, launches


@pytest.mark.parametrize("kv", ["dense", "fp32", "int8"])
def test_declared_decode_step_equals_hand_count(kv):
    lm = LM(SMOKE, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    smax, ps = 32, 8
    if kv == "dense":
        state = lm.init_decode_state(len(LENGTHS), smax)
    else:
        state = lm.init_decode_state(
            len(LENGTHS), smax, page_size=ps, num_pages=13, table_width=4,
            kv_dtype=torch.int8 if kv == "int8" else None)
        table = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4)
        state["caches"] = state["caches"]._replace(page_table=table)
    state["caches"] = state["caches"]._replace(
        length=torch.tensor(LENGTHS, dtype=torch.int32))
    toks = torch.tensor([[3], [7], [9]], dtype=torch.int32)
    flops, arg, out, launches = _hand_count(kv != "dense", kv == "int8",
                                            smax, ps)
    # the CPU's registry choice is the paged family's plain impl, which
    # declares the same work with no launch; pinned to the kernel's impl,
    # the wrapper runs its plain version and declares one launch a layer
    runs = [({}, 0)]
    if kv != "dense":
        runs.append(({"paged_decode": "cuda_paged_q8" if kv == "int8"
                      else "cuda_paged"}, launches))
    for pin, want_launches in runs:
        with registry.use_impl(**pin), events.collect() as ev:
            lm.decode_step(toks, state)
        assert ev["FLOPS_TOTAL"] == flops
        assert ev["FLOPS_F32"] == flops                 # fp32 model
        assert ev["HBM_ARG_BYTES"] == arg
        assert ev["HBM_OUT_BYTES"] == out
        assert ev["BYTES_ACCESSED"] == arg + out
        assert ev["LAUNCHES"] == want_launches


def _moe_hand_count(paged: bool, int8: bool, smax: int, ps: int):
    """(flops, arg bytes, out bytes) of one fp32 decode step of
    qwen2-moe-a2.7b SMOKE over ``LENGTHS``, from the config alone.  The
    experts' FLOPs follow the capacity: 3 rows route top-2 over 8
    experts, cap = max(ceil(3 * 2 * 1.25 / 8), 2) = 2, so each expert's
    three products run over 2 rows whatever the rows route to."""
    c = MOE_SMOKE
    d, L, H, KVH, V, F = (c.d_model, c.n_layers, c.num_heads,
                          c.num_kv_heads, c.vocab, c.d_ff)
    E, fs = c.moe_experts, c.moe_d_ff_shared
    dh, B, f, cap = d // H, len(LENGTHS), 4, 2
    attn = d * H * dh + 2 * d * KVH * dh + H * dh * d
    moe_w = d * E + 3 * E * d * F + 3 * d * fs + d   # router ... coef
    layer = attn + moe_w + 2 * d + H * dh + 2 * KVH * dh  # norms, biases
    weights = f * (L * layer + d)                      # + final norm
    head = f * d * V                                   # the untied head
    flops = (2 * B * L * attn + 2 * B * d * V
             + L * (2 * 3 * E * cap * d * F            # experts
                    + 2 * 3 * B * d * fs               # shared expert
                    + 2 * B * d * E + 2 * B * d))      # router, coef
    buf = L * E * cap * d * f                          # [E, cap, d]
    arg = weights + head + B * (f * d + 4) + buf
    page_isz, scale = (1, 4) if int8 else (f, 0)
    out = f * B * V + buf + 2 * L * B * (KVH * dh * (page_isz if paged
                                                      else f) + scale)
    if not paged:
        arg += 2 * L * B * smax * KVH * dh * f
        flops += 4 * L * B * H * smax * dh
    else:
        live = sum(-(-n // ps) for n in LENGTHS)
        per_tok = 2 * KVH * dh * page_isz + (8 if int8 else 0)
        qo = B * H * dh * f
        arg += L * (qo + 2 * B * KVH * dh * f + 4 * B
                    + live * (ps * per_tok + 4))
        out += L * qo
        flops += L * 4 * dh * H * sum(n + 1 for n in LENGTHS)
    return flops, arg, out


@pytest.mark.parametrize("kv", ["dense", "fp32", "int8"])
def test_declared_moe_decode_step_equals_hand_count(kv):
    """The moe case of :func:`test_declared_decode_step_equals_hand_count`:
    every weight read once, the experts over E * cap rows, the router and
    shared gate in fp32, the ``[E, cap, d]`` buffers written and read."""
    lm = LM(MOE_SMOKE, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    smax, ps = 32, 8
    if kv == "dense":
        state = lm.init_decode_state(len(LENGTHS), smax)
    else:
        state = lm.init_decode_state(
            len(LENGTHS), smax, page_size=ps, num_pages=13, table_width=4,
            kv_dtype=torch.int8 if kv == "int8" else None)
        table = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4)
        state["caches"] = state["caches"]._replace(page_table=table)
    state["caches"] = state["caches"]._replace(
        length=torch.tensor(LENGTHS, dtype=torch.int32))
    flops, arg, out = _moe_hand_count(kv != "dense", kv == "int8", smax, ps)
    with events.collect() as ev:
        lm.decode_step(torch.tensor([[3], [7], [9]], dtype=torch.int32),
                       state)
    assert ev["FLOPS_TOTAL"] == ev["FLOPS_F32"] == flops
    assert ev["HBM_ARG_BYTES"] == arg
    assert ev["HBM_OUT_BYTES"] == out
    assert ev["LAUNCHES"] == 0
    # a bf16 model: the router and shared gate stay fp32 FLOPs
    lm16 = LM(MOE_SMOKE, torch.bfloat16, "cpu").init(
        torch.Generator().manual_seed(0))
    state = lm16.init_decode_state(len(LENGTHS), smax)
    with events.collect() as ev:
        lm16.decode_step(torch.tensor([[3], [7], [9]], dtype=torch.int32),
                         state)
    c, B = MOE_SMOKE, len(LENGTHS)
    assert ev["FLOPS_F32"] == c.n_layers * (2 * B * c.d_model
                                            * c.moe_experts
                                            + 2 * B * c.d_model)


def test_kernel_models_equal_brute_force_counts():
    rng = np.random.default_rng(3)
    for causal in (True, False):
        b, h, kvh, sq, sk, dh, off = 3, 4, 2, 7, 12, 16, 5
        kv = rng.integers(0, sk + 1, size=b)
        pairs = rows = 0
        for n in kv:
            seen = [min(n, off + i + 1) if causal else n for i in range(sq)]
            pairs += sum(seen)
            rows += max(seen)
        flops, arg, out = flash_traffic(kv, h=h, kvh=kvh, sq=sq, sk=sk,
                                        dh=dh, itemsize=2, causal=causal,
                                        q_offset=off)
        assert flops == 4 * dh * h * pairs
        assert out == 2 * b * h * sq * dh
        assert arg == out + 2 * kvh * dh * 2 * rows + 4 * b
    lens = np.array([0, 1, 16, 17, 40])
    flops, arg, out = paged_traffic(lens, kvh=2, g=3, dh=8, ps=16,
                                    q_itemsize=4, page_itemsize=1,
                                    scales=True)
    live = 0 + 1 + 1 + 2 + 3
    assert flops == 4 * 8 * 2 * 3 * int((lens + 1).sum())
    assert out == 5 * 2 * 3 * 8 * 4
    assert arg == (out + 2 * 5 * 2 * 8 * 4 + 4 * 5
                   + live * (16 * (2 * 2 * 8 + 8) + 4))


def test_events_settle_data_dependent_launches_when_closed():
    kv = torch.tensor([4, 9], dtype=torch.int32)
    seen = []

    def model(host):
        seen.append(host.tolist())
        return 1.0, 2.0, 3.0

    events.record_launch_from(kv, model)              # no collection: no-op
    assert not seen and not events.active()
    with events.collect() as outer:
        with events.collect() as inner:
            assert events.active()
            events.record_launch_from(kv, model)
            events.record_ops(flops=10.0, arg_bytes=20.0, out_bytes=30.0)
    for ev in (outer, inner):
        assert ev["LAUNCHES"] == 1
        assert ev["FLOPS_TOTAL"] == 11 and ev["BYTES_ACCESSED"] == 55
    assert seen == [[4, 9]]                           # one model call


# ---------------------------------------------------------------------------
# slice parity with the JAX package (fp32 greedy)
# ---------------------------------------------------------------------------

def _jax_lm(cfg):
    return JaxLM(JaxLMConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "vocab", "d_model", "n_layers", "num_heads",
        "num_kv_heads", "d_ff")}),
        default_features().with_(remat_policy="none"), dtype=jnp.float32)


def _bridged(np_params, cfg) -> LM:
    lm = LM(cfg, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(np_params, cfg))
    return lm


def test_bench_serve_model_matches_jax_engine():
    cfg = bench_serve.bench_config(smoke=True)
    jlm = _jax_lm(cfg)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    ps = bench_serve.prompts(cfg.vocab, 4, 8)
    want = JaxEngine(jlm, jax.tree.map(jnp.asarray, jparams), JaxServeConfig(
        **bench_serve.SERVE)).generate(ps, max_new_tokens=32)
    eng = Engine(_bridged(jparams, cfg), ServeConfig(**bench_serve.SERVE),
                 device="cpu")
    assert eng.generate(ps, max_new_tokens=32) == want
    assert eng.generate_reference(ps, max_new_tokens=32) == want


def test_bench_spec_legs_match_jax_engine():
    lm, tp, tcfg, dcfg, dp_hi, dp_lo = jax_bench_spec._build(smoke=True)
    ps = jax_bench_spec._prompts(tcfg.vocab, 4, 12)
    assert ps == bench_spec.prompts(tcfg.vocab, 4, 12)
    max_new = 48
    jsc = JaxServeConfig(max_seq=256, batch_slots=4, temperature=0.0,
                         page_size=16)
    want = JaxEngine(lm, tp, jsc).generate(ps, max_new)
    target = bench_spec.target_config(smoke=True)
    assert (target.d_model, target.n_layers, target.d_ff) == (
        tcfg.d_model, tcfg.n_layers, tcfg.d_ff)
    tlm = _bridged(jax.device_get(tp), target)
    dcfg_port = dataclasses.replace(target, name="spec-bench-draft",
                                    n_layers=1)
    for dp in (dp_hi, dp_lo):
        jeng = JaxEngine(lm, tp, jsc, spec=JaxSpecConfig(
            draft_config=dcfg, num_draft_tokens=4), draft_params=dp)
        jtoks = jeng.generate(ps, max_new)
        eng = Engine(tlm, ServeConfig(**vars(bench_spec.SERVE)),
                     device="cpu", draft_lm=_bridged(jax.device_get(dp),
                                                     dcfg_port),
                     spec=SpecConfig(draft_config=dcfg_port,
                                     num_draft_tokens=4))
        got = eng.generate(ps, max_new)
        assert got == jtoks == want
        assert math.isclose(eng.spec_stats["accept_rate"],
                            jeng.spec_stats["accept_rate"])


# ---------------------------------------------------------------------------
# speed bars: recorded, and a miss makes the exit code 1
# ---------------------------------------------------------------------------

def test_bar_records_and_missed_bars():
    assert common.bar(1.2, 3.0) == {"value": 1.2, "bar": 3.0, "met": False}
    assert common.bar(3.0, 3.0)["met"]
    summary = {"bars": {"a": common.bar(2.0, 1.5), "b": common.bar(1.0, 2)}}
    assert common.missed_bars(summary) == ["b"]
    assert common.missed_bars({}) == []
    with pytest.raises(common.ClaimFailed, match="tokens"):
        common.claim(False, "tokens diverged")
    common.claim(True, "never raised")


def _fake(summary=None, exc=None):
    def run_(csv, smoke=False, device="cuda"):
        if exc is not None:
            raise exc
        csv.append(("fake_row", 1.0, "x=1"))
        return summary
    return types.SimpleNamespace(run=run_, __doc__="A fake bench.")


def test_runner_exit_code_follows_bars_and_claims(monkeypatch, tmp_path):
    met = {"bars": {"speed": common.bar(2.0, 1.5)}}
    missed = {"bars": {"speed": common.bar(1.1, 3.0)}}
    cases = [({"ok": _fake(met)}, 0), ({"ok": _fake(met),
                                        "slow": _fake(missed)}, 1),
             ({"bad": _fake(exc=common.ClaimFailed("tokens diverged"))}, 1)]
    for benches, want in cases:
        monkeypatch.setattr(run, "SERVING", benches)
        monkeypatch.setattr(run, "BENCHES", dict(benches))
        out = tmp_path / "run.json"
        rc = run.main(["--device", "cpu", "--smoke", "--json", str(out)])
        assert rc == want
        report = json.loads(out.read_text())
        assert [b["name"] for b in report["benches"]] == list(benches)
    monkeypatch.setattr(run, "BENCHES", {"ok": _fake(met)})
    with pytest.raises(SystemExit):
        run.main(["--device", "cpu", "--only", "nope"])


def test_bench_main_exit_code_follows_its_bar(monkeypatch, tmp_path):
    for summary, want in (({"bars": {"s": common.bar(1.0, 2.0)}}, 1),
                          ({"bars": {"s": common.bar(2.5, 2.0)}}, 0)):
        monkeypatch.setattr(bench_spec, "run",
                            lambda csv, smoke, device, arch, s=summary: s)
        out = tmp_path / "spec.json"
        assert bench_spec.main(["--device", "cpu", "--smoke", "--json",
                                str(out)]) == want
        assert out.exists()


# ---------------------------------------------------------------------------
# the tool layer's benches: stream pinning's placement half, the marker
# overhead and the perfctr listing
# ---------------------------------------------------------------------------

def test_stream_pinning_placement_equals_the_reference_bench(capsys):
    from benchmarks import bench_stream_pinning as jax_pinning
    from repro.core import pin as jax_pin
    from repro.core import topology as jax_topo
    theirs, ours = [], []
    jax_pinning.run(theirs, smoke=True)
    place = bench_stream_pinning.placement(ours, smoke=True)
    assert ours == [row for row in theirs if row[0] == "stream_pin_hops"]
    topo = jax_topo.probe(spec=jax_topo.PRODUCTION_SINGLE_POD)
    for name in ("compact", "scatter", "ring"):
        order = jax_pin.get_strategy(name)(topo).device_ids
        assert place["mesh_cost"][name] == \
            jax_pinning._mesh_hop_cost(topo, order)
        assert place["flat_cost"][name] == \
            jax_pinning._flat_ring_cost(topo, order)
    rng = np.random.default_rng(0)
    meds = [jax_pinning._mesh_hop_cost(topo, rng.permutation(256))
            for _ in range(5)]
    assert place["unpinned_2d"]["median"] == float(np.median(meds))
    out = capsys.readouterr().out
    assert "pin[ring]" in out and "unpinned (random x5)" in out


@pytest.mark.parametrize("name", ["marker_overhead", "perfctr"])
def test_tool_benches_smoke_on_the_cpu(name, tmp_path):
    bench = run.BENCHES[name]
    assert name in run.TOOLS
    out = tmp_path / f"{name}.json"
    res = bench.main(["--smoke", "--device", "cpu", "--json", str(out)])
    got = json.loads(out.read_text())
    assert got["card"] == "cpu (host times)"
    assert {k: v for k, v in got.items() if k != "card"} == \
        json.loads(json.dumps(res))
    if name == "marker_overhead":
        assert abs(res["matmul"]["overhead"]) < res["matmul"]["bound"] == 1.0
        paged = res["paged_decode"]
        assert paged["bare_us"] > 0 and paged["measured_us"] > 0
        # the plain impl on the CPU declares no launch
        assert paged["region_launches"] == 0
    else:
        assert res["benchmark_calls"] == 2 and res["init_calls"] == 1
        assert res["benchmark_flops"] == 2 * 4 * 128 ** 3


def test_case_study_stream_torch_prints_the_reference_table(capsys):
    import runpy
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    ours = runpy.run_path(str(root / "examples" /
                              "case_study_stream_torch.py"))["main"]()
    out = capsys.readouterr().out
    theirs = runpy.run_path(str(root / "examples" / "case_study_stream.py"))
    theirs["main"]()
    jout = capsys.readouterr().out
    assert out.replace("one link", "one ICI link") == jout
    assert [r[0] for r in ours] == [4, 8, 16, 32, 64, 128, 256]
    assert ours[-1][1] == 1.0      # the full snake: one hop a step
