"""The registry's tune half (``repro_torch.kernels.registry``: TuneSpace,
autotune, best, record, the tune table and its persistence) on the CPU,
against the JAX package's ``repro.kernels.registry``.

Held to the reference on the same facts:

* every tune key, neighbour list and ``record_keys`` fan-out, byte for
  byte (dtype names ``float32`` / ``bfloat16``, backend ``cpu`` /
  ``cuda``);
* ``best()``'s resolution — the table, the disk, a neighbour, the
  default — after the same ``record()`` calls (and the same persisted
  tune-choice entries) in both packages;
* the dump's and the sweep entry's field names (``smem_fraction`` in
  place of ``vmem_fraction``, and one field more, ``timer``: the timer
  behind a sweep's scores on the card, None on the CPU).

In the port alone: a cold sweep and a fresh-process warm start (0
sweeps, 0 timed probes), the shared-memory gate and its "no candidate
fits" error, a corrupt entry quarantined and re-swept, a JAX-written
tune entry in the same root never served to the port, the memo of
``best()`` emptied by a put and a clear, the runners reading ``best()``
only when given no tile, the untuned defaults equal to the tiles the
wrappers took before the tuner, and the ``sampling`` family's tokens
equal to ``block_argmax`` and ``sample``.
"""

import json
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import artifact_cache as jax_cache  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.kernels import sampling as jax_sampling  # noqa: E402
from repro_torch.core.artifact_cache import ArtifactCache  # noqa: E402
from repro_torch.core.session import ProfileSession  # noqa: E402
from repro_torch.kernels import registry, sampling  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import jacobi7 as jacobi_mod  # noqa: E402
from repro_torch.kernels import paged_decode as paged_mod  # noqa: E402
from repro_torch.kernels import stream_triad as triad_mod  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16))


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "root"))
    registry.clear_tune_table()
    jax_registry.clear_tune_table()
    yield
    registry.clear_tune_table()
    jax_registry.clear_tune_table()


# ---------------------------------------------------------------------------
# tune keys, neighbours, record_keys: the reference's, byte for byte
# ---------------------------------------------------------------------------

ATTN_FACTS = [dict(b=b, h=h, kvh=kvh, sq=sq, sk=sk, dh=dh, causal=c)
              for b, h, kvh, sq, sk, dh, c in (
                  (1, 4, 2, 128, 192, 32, True), (3, 14, 2, 512, 512, 64,
                                                  True),
                  (8, 32, 32, 512, 512, 64, False), (5, 8, 1, 7, 300, 128,
                                                     True),
                  (8, 32, 32, 512, 512, 80, True),      # stablelm-3b
                  (4, 96, 8, 256, 256, 128, True))]     # mistral-large
PAGED_FACTS = [dict(b=b, kvh=kvh, g=g, dh=dh, page_size=ps, ctx=ctx)
               for b, kvh, g, dh, ps, ctx in (
                   (4, 2, 2, 32, 16, 128), (8, 2, 7, 64, 16, 1024),
                   (3, 1, 32, 128, 8, 700), (1, 4, 1, 16, 32, 1),
                   (8, 32, 1, 80, 16, 1024), (4, 8, 12, 128, 16, 512))]


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("dts", DTYPES, ids=["fp32", "bf16"])
def test_tune_keys_are_the_references(backend, dts):
    ours, theirs = dts
    for f in ATTN_FACTS:
        assert registry.attention_tune_key(dtype=ours, backend=backend,
                                           **f) == \
            jax_registry.attention_tune_key(dtype=theirs, backend=backend,
                                            **f)
        assert registry._attention_neighbors(**f) == \
            jax_registry._attention_neighbors(**f)
    for f in PAGED_FACTS:
        for q in (False, True):
            kw = dict(f, dtype=ours, backend=backend, quantized=q)
            jkw = dict(f, dtype=theirs, backend=backend, quantized=q)
            assert registry.paged_lookup_key(**kw) == \
                jax_registry.paged_lookup_key(**jkw)
            assert registry.paged_sweep_key(**kw) == \
                jax_registry.paged_sweep_key(**jkw)
        assert registry._paged_q8_lookup_key(dtype=ours, backend=backend,
                                             **f) == \
            jax_registry._paged_q8_lookup_key(dtype=theirs,
                                              backend=backend, **f)
        assert registry._paged_neighbors(**f) == \
            jax_registry._paged_neighbors(**f)
    for n in (128, 128 * 512, 1 << 27):
        assert registry.triad_tune_key(n=n, dtype=ours, backend=backend) \
            == jax_registry.triad_tune_key(n=n, dtype=theirs,
                                           backend=backend)
    for shape, t in (((24, 16, 16), 2), ((512, 512, 512), 4)):
        assert registry.jacobi_tune_key(shape=shape, sweeps=t, dtype=ours,
                                        backend=backend) == \
            jax_registry.jacobi_tune_key(shape=shape, sweeps=t,
                                         dtype=theirs, backend=backend)
    for b, s, h, dk, dv, norm in ((2, 128, 2, 16, 16, False),
                                  (8, 512, 64, 64, 64, False),
                                  (1, 300, 4, 512, 512, True)):
        f = dict(b=b, s=s, h=h, dk=dk, dv=dv, normalize=norm)
        assert registry.ssd_tune_key(dtype=ours, backend=backend, **f) == \
            jax_registry.ssd_tune_key(dtype=theirs, backend=backend, **f)
        assert registry._ssd_neighbors(**f) == \
            jax_registry._ssd_neighbors(**f)
    for b, v in ((8, 2048), (3, 151936), (64, 32000)):
        for method in ("greedy", "top_k", "top_p"):
            assert registry.sampling_tune_key(
                b=b, v=v, method=method, dtype=ours, backend=backend) == \
                jax_sampling.sampling_tune_key(
                    b=b, v=v, method=method, dtype=theirs, backend=backend)
    # the dtype spelled as a name keys the same (the card suite's cells)
    assert registry.triad_tune_key(n=128, dtype=str(ours)[6:],
                                   backend=backend) == \
        registry.triad_tune_key(n=128, dtype=ours, backend=backend)


@pytest.mark.parametrize("quantized", [False, True])
def test_record_keys_fan_out_as_the_references(quantized):
    scores = {(16, 1): 3e-5, (16, 2): 2e-5, (32, 1): 1e-5, (32, 4): 1e-5,
              (64, 1): float("inf"), (8, 2): 4e-5}
    facts = dict(b=4, kvh=2, g=2, dh=32, ctx=128, backend="cpu")
    ours = (registry._paged_q8_record_keys if quantized
            else registry._paged_record_keys)(scores, dtype=torch.float32,
                                              **facts)
    theirs = (jax_registry._paged_q8_record_keys if quantized
              else jax_registry._paged_record_keys)(
        scores, dtype=jnp.float32, **facts)
    assert ours == theirs
    assert set(ours) == {registry.paged_lookup_key(
        page_size=ps, dtype=torch.float32, quantized=quantized, **facts)
        for ps in (8, 16, 32)}


# ---------------------------------------------------------------------------
# best(): table, disk, neighbour, default — after the same record() calls
# ---------------------------------------------------------------------------

#: (family, impl, facts, neighbour delta or None, a choice valid in both)
RESOLUTION = [
    ("stream_triad", None, dict(n=128 * 512), None, (16,)),
    ("attention", None, dict(b=3, h=4, kvh=2, sq=128, sk=192, dh=32),
     {"b": 8}, (32, 32)),
    ("paged_decode", None, dict(b=4, kvh=2, g=2, dh=32, page_size=16,
                                ctx=128), {"ctx": 256}, (16, 2)),
    ("paged_decode", "pallas_paged_q8",
     dict(b=4, kvh=2, g=2, dh=32, page_size=16, ctx=128, quantized=True),
     {"ctx": 64}, (16, 4)),
    ("ssd_scan", None, dict(b=2, s=128, h=2, dk=16, dv=16, normalize=False),
     {"b": 4}, (64,)),
    ("jacobi7", None, dict(shape=(24, 16, 16), sweeps=2), None, (8,)),
    ("sampling", "pallas_topk", dict(b=8, v=2048, method="top_k"), None,
     (2,)),
]


def _keys(family, impl, facts):
    ts = registry._tuned_spec(family, impl).tune
    jts = jax_registry._tuned_spec(family, impl).tune
    ours = (ts.lookup_key or ts.key)(dtype=torch.float32, backend="cpu",
                                     **facts)
    theirs = (jts.lookup_key or jts.key)(dtype=jnp.float32, backend="cpu",
                                         **facts)
    return ours, theirs


def _best_both(family, impl, facts):
    return (registry.best(family, impl=impl, backend="cpu",
                          dtype=torch.float32, **facts),
            jax_registry.best(family, impl=impl, backend="cpu",
                              dtype=jnp.float32, **facts))


def _clear():
    registry.clear_tune_table()
    jax_registry.clear_tune_table()


@pytest.mark.parametrize("family,impl,facts,delta,choice", RESOLUTION,
                         ids=[r[0] + ("_q8" if r[1] and "q8" in r[1] else "")
                              for r in RESOLUTION])
def test_best_resolves_as_the_reference(family, impl, facts, delta, choice):
    key, jkey = _keys(family, impl, facts)
    assert key == jkey
    # default: each package's declared default (the port's: today's tile)
    ours, theirs = _best_both(family, impl, facts)
    ts = registry._tuned_spec(family, impl).tune
    assert ours == ts.resolve_default(dtype=torch.float32, backend="cpu",
                                      **facts)
    assert registry.resolve(family, impl=impl, dtype=torch.float32,
                            backend="cpu", **facts)[1] == "default"
    # table: the same record() in both
    _clear()
    registry.record(family, key, choice)
    jax_registry.record(family, jkey, choice)
    assert _best_both(family, impl, facts) == (choice, choice)
    # neighbour: a nearby bucket's record is adopted by both
    if delta is not None:
        _clear()
        nkey, njkey = _keys(family, impl, dict(facts, **delta))
        assert nkey == njkey != key
        registry.record(family, nkey, choice)
        jax_registry.record(family, njkey, choice)
        assert _best_both(family, impl, facts) == (choice, choice)
        assert registry.resolve(family, impl=impl, dtype=torch.float32,
                                backend="cpu", **facts)[1] == "neighbour"
    # disk: a persisted tune-choice entry in the default root, each under
    # its package's own digest; a JAX-written entry is never the port's
    _clear()
    entry = {"kind": "tune-choice", "family": family, "key": key,
             "choice": list(choice), "score_s": 1e-6, "winner_events": {}}
    jax_cache.ArtifactCache(None).put(
        jax_registry._tune_digest("tune-choice", family, jkey), entry)
    ours, theirs = _best_both(family, impl, facts)
    assert theirs == choice                         # never crosses:
    assert ours == ts.resolve_default(dtype=torch.float32, backend="cpu",
                                      **facts) != choice
    _clear()
    ArtifactCache(None).put(registry._tune_digest("tune-choice", family,
                                                  key), entry)
    assert _best_both(family, impl, facts) == (choice, choice)
    rows = registry.dump_tune_table()["records"]
    jrows = jax_registry.dump_tune_table()["records"]
    assert [r.pop("timer") for r in rows] == [None] * len(jrows)
    assert [set(r) for r in rows] == [set(r) for r in jrows]
    assert rows == jrows


def test_sweep_entry_fields_are_the_references():
    rec = registry.TuneRecord(family="stream_triad", key="k", choice=(8,),
                              score_s=1.0, scores={(8,): 1.0}, lowerings=1)
    jrec = jax_registry.TuneRecord(family="stream_triad", key="k",
                                   choice=(8,), score_s=1.0,
                                   scores={(8,): 1.0}, lowerings=1)
    ours = registry._rec_to_entry(rec, [(8,)], 1.0, {"k": ((8,), 1.0)}, {})
    theirs = jax_registry._rec_to_entry(jrec, [(8,)], 0.9,
                                        {"k": ((8,), 1.0)}, {})
    assert ours.pop("timer") is None
    assert set(ours) - {"smem_fraction"} == set(theirs) - {"vmem_fraction"}
    assert {k: v for k, v in ours.items() if k != "smem_fraction"} == \
        {k: v for k, v in theirs.items() if k != "vmem_fraction"}
    assert [f.name for f in __import__("dataclasses").fields(
        registry.TuneRecord)] == [f.name for f in __import__(
            "dataclasses").fields(jax_registry.TuneRecord)] + ["timer"]


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def test_cold_sweep_then_fresh_process_warm(tmp_path):
    from repro_torch.launch.cli import run_tune_suite
    root = str(tmp_path / "tune")
    cold = run_tune_suite(ProfileSession(cache_dir=root), smoke=True,
                          backend="cpu", verbose=False)
    assert all(r["swept"] and r["lowerings"] >= 1 for r in cold.values())
    out = tmp_path / "warm.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_CACHE_DIR=root)
    res = subprocess.run([sys.executable, "-m",
                          "repro_torch.bench.bench_autotune", "--smoke",
                          "--device", "cpu", "--assert-warm", "--json",
                          str(out)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    warm = json.loads(out.read_text())
    assert warm["sweeps"] == 0 and warm["lowerings"] == 0
    assert {c: r["choice"] for c, r in warm["families"].items()} == \
        {c: r["choice"] for c, r in cold.items()}
    assert "0 sweeps, 0 timed probes" in res.stdout


def test_smem_gate_and_no_fit(tmp_path):
    sess = ProfileSession(cache_dir=str(tmp_path / "g"))
    facts = dict(b=1, h=4, kvh=2, sq=64, sk=64, dh=32, dtype=torch.float32,
                 backend="cpu")
    # (256, 256) is not built for fp32: gated before anything runs
    rec = registry.autotune("attention", sess, candidates=((64, 32),
                                                           (256, 256)),
                            **facts)
    assert rec.scores[(256, 256)] == float("inf")
    assert rec.choice == (64, 32) and sess.lowerings == 1
    with pytest.raises(ValueError, match="fits shared memory"):
        registry.autotune("attention", sess, candidates=((64, 32),),
                          smem_fraction=1e-6, **facts)
    # the int8 paged kernel takes no opt-in: 48 KiB a block
    q8 = dict(b=1, kvh=1, g=32, dh=128, ctx=64, quantized=True,
              dtype=torch.float32, backend="cpu")
    assert paged_mod.q8_smem_bytes(32, 128, 32) > paged_mod.Q8_SMEM_LIMIT
    with pytest.raises(ValueError, match="fits shared memory"):
        registry.autotune("paged_decode", sess, impl="cuda_paged_q8",
                          candidates=((32, 1),), **q8)
    assert flash_mod.flash_smem_bytes(128, 128, 128, torch.bfloat16) <= \
        registry.SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_80_passes_every_gate_and_sweeps(tmp_path, dtype):
    """stablelm-3b's head dim: every flash pair the kernel builds fits the
    shared-memory gate (fp32's static tiles under 48 KB, as the build
    needs), so is the paged kernels' at G 1 and mistral-large's G 12 at
    Dh 128, and a sweep at Dh 80 scores every pair."""
    for bq, bk in flash_mod.FLASH_PAIRS[dtype]:
        need = flash_mod.flash_smem_bytes(bq, bk, 80, dtype)
        limit = (48 * 1024 if dtype == torch.float32
                 else registry.SMEM_PER_BLOCK)
        assert need <= limit, (bq, bk)
    for ps in (8, 16, 32):
        for g, dh in ((1, 80), (12, 128)):
            assert paged_mod.q8_smem_bytes(ps, dh, g) <= \
                paged_mod.Q8_SMEM_LIMIT
            assert paged_mod.fp_smem_bytes(ps, dh, g, 4) <= \
                registry.SMEM_PER_BLOCK
    sess = ProfileSession(cache_dir=str(tmp_path / "dh80"))
    cands = flash_mod.FLASH_PAIRS[dtype]
    rec = registry.autotune("attention", sess, candidates=cands, b=2, h=4,
                            kvh=4, sq=40, sk=40, dh=80, dtype=dtype,
                            backend="cpu")
    assert set(rec.scores) == set(cands)
    assert all(np.isfinite(v) for v in rec.scores.values())
    assert "dh80" in rec.key
    q8 = registry.autotune("paged_decode", sess, impl="cuda_paged_q8",
                           candidates=((8, 1), (16, 2)), b=2, kvh=4, g=1,
                           dh=80, ctx=64, quantized=True, dtype=dtype,
                           backend="cpu")
    assert all(np.isfinite(v) for v in q8.scores.values())
    assert "dh80" in q8.key


def test_corrupt_entries_are_quarantined_and_reswept(tmp_path):
    sess = ProfileSession(cache_dir=str(tmp_path / "q"))
    kw = dict(n=128 * 64, candidates=((8,), (16,)), backend="cpu")
    first = registry.autotune("stream_triad", sess, **kw)
    digest = registry._tune_digest("tune-sweep", "stream_triad", first.key)
    # schema-valid JSON, garbage content: warned once, quarantined, swept
    sess.cache.put(digest, {"kind": "tune-sweep", "candidates": [[8], [16]],
                            "smem_fraction": 1.0, "choice": [8],
                            "score_s": "nan?", "scores": "garbage"})
    with pytest.warns(RuntimeWarning, match="quarantined"):
        again = registry.autotune("stream_triad", sess, **kw)
    assert again.swept and again.choice == first.choice
    # torn bytes: the cache itself quarantines, the sweep reruns
    path = os.path.join(sess.cache.tree, digest[:2], f"{digest}.json")
    with open(path, "wb") as f:
        f.write(b"{torn")
    third = registry.autotune("stream_triad", sess, **kw)
    assert third.swept and os.path.exists(path + ".corrupt")
    # then it is warm again
    assert not registry.autotune("stream_triad", sess, **kw).swept


def test_best_memo_is_emptied_by_put_and_clear():
    facts = dict(n=128 * 32, dtype=torch.float32, backend="cpu")
    key = registry.triad_tune_key(**facts)
    assert registry.best("stream_triad", **facts) == (8,)
    table = registry.tune_table()
    assert list(table.memo.values()) == [(8,)]
    gen = table.generation
    registry.record("stream_triad", key, (32,))
    assert table.memo == {} and table.generation > gen
    assert registry.best("stream_triad", **facts) == (32,)
    registry.clear_tune_table("stream_triad")
    assert table.memo == {}
    assert registry.best("stream_triad", **facts) == (8,)
    # a stale resolution is never memoized
    registry.tune_table().memo_put(("x",), (1,), gen)
    assert ("x",) not in registry.tune_table().memo
    # the paged runners' memo (best_at on their shapes) follows the table
    q4 = torch.zeros(2, 1, 3, 16)
    pages = torch.zeros(9, 8, 1, 16)
    table = torch.zeros(2, 4, dtype=torch.int32)
    assert registry._paged_split("cuda_paged", q4, pages, table) == \
        paged_mod.split_plan(2, 1, 4)
    registry.record("paged_decode", registry.paged_lookup_key(
        b=2, kvh=1, g=3, dh=16, page_size=8, ctx=32, dtype=torch.float32,
        backend="cpu"), (8, 3))
    assert registry._paged_split("cuda_paged", q4, pages, table) == 3
    registry.clear_tune_table()
    assert registry._paged_split("cuda_paged", q4, pages, table) == \
        paged_mod.split_plan(2, 1, 4)


def test_runners_read_best_only_without_a_tile(monkeypatch):
    seen = []
    real = triad_mod.stream_triad

    def spy(b, c, **kw):
        seen.append(kw["block_rows"])
        return real(b, c, **kw)

    monkeypatch.setattr(registry.triad_mod, "stream_triad", spy)
    b = torch.ones(128 * 16)
    registry.run("stream_triad", b, b, impl="cuda_triad")
    registry.record("stream_triad", registry.triad_tune_key(
        n=b.shape[0], dtype=b.dtype, backend="cpu"), (4,))
    registry.run("stream_triad", b, b, impl="cuda_triad")
    registry.run("stream_triad", b, b, impl="cuda_triad", block_rows=2)
    assert seen == [8, 4, 2]
    sites = registry.served_sites()
    assert [s[0] for s in sites] == ["stream_triad"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_untuned_defaults_are_todays_tiles(dtype):
    for f in ATTN_FACTS:
        assert registry.best("attention", dtype=dtype, backend="cuda",
                             **f) == flash_mod.default_blocks(dtype)
    assert flash_mod.default_blocks(torch.bfloat16) == (64, 64)
    assert flash_mod.default_blocks(torch.float32) == (64, 32)
    for f in PAGED_FACTS:
        np_w = -(-f["ctx"] // f["page_size"])
        for impl in ("cuda_paged", "cuda_paged_q8"):
            assert registry.best("paged_decode", impl=impl, dtype=dtype,
                                 backend="cuda", **f) == (
                f["page_size"], paged_mod.split_plan(f["b"], f["kvh"],
                                                     np_w))
    for b, v in ((8, 151936), (1, 32000), (64, 130)):
        assert registry.best("sampling", b=b, v=v, method="greedy",
                             dtype=dtype, backend="cuda") == \
            (sampling.argmax_plan(b, v)[0],)
    assert registry.best("stream_triad", n=1 << 20, dtype=dtype,
                         backend="cuda") == (
        triad_mod.default_block_rows(torch.empty((), dtype=dtype)
                                     .element_size()),)
    assert registry.best("jacobi7", shape=(64, 64, 64), sweeps=4,
                         dtype=torch.float32, backend="cuda") == \
        (jacobi_mod.BLOCK_X,)
    assert registry.best("ssd_scan", b=8, s=512, h=64, dk=64, dv=64,
                         dtype=dtype, backend="cuda") == \
        (registry.DEFAULT_SSD_CHUNK,)


def test_wrappers_refuse_tiles_they_do_not_hold():
    q = torch.zeros(1, 2, 8, 32)
    kv = torch.zeros(1, 1, 8, 32)
    with pytest.raises(ValueError, match="builds"):
        flash_mod.flash_attention_bhsd(q, kv, kv, bq=256, bk=256)
    out = flash_mod.flash_attention_bhsd(q, kv, kv, bq=32, bk=32)
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="split"):
        sampling.block_argmax(torch.zeros(2, 16), split=3)
    with pytest.raises(ValueError, match="split"):
        sampling.block_argmax(torch.zeros(2, 16), split=9)
    assert sampling.argmax_chunk(151936, 8) == sampling.argmax_plan(8,
                                                                    151936)
    args = (torch.zeros(1, 1, 2, 16), torch.zeros(3, 4, 1, 16),
            torch.zeros(3, 4, 1, 16), torch.ones(1, 2, dtype=torch.int32),
            torch.tensor([5], dtype=torch.int32), torch.zeros(1, 1, 16),
            torch.zeros(1, 1, 16))
    with pytest.raises(ValueError, match="split"):
        paged_mod.paged_decode_attention_grouped(*args, split=9)


def test_sampling_family_tokens_equal_block_argmax():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 4099), np.float32))
    x[0, [3, 4000]] = 9.0                       # a tie: the lower index
    want = sampling.block_argmax(x)
    for impl in ("cuda_greedy", "torch_greedy", None):
        got = registry.run("sampling", x, impl=impl, method="greedy")
        assert torch.equal(got, want), impl
    assert torch.equal(registry.run("sampling", x, impl="cuda_greedy",
                                    split=2), want)
    for method, kw in (("top_k", dict(k=5)), ("top_p", dict(p=0.8))):
        toks = []
        for impl in ("cuda_" + method.replace("_", ""),
                     "torch_" + method.replace("_", ""), None):
            gen = torch.Generator().manual_seed(11)
            toks.append(registry.run("sampling", x, gen, impl=impl,
                                     method=method, temperature=0.7, **kw))
        gen = torch.Generator().manual_seed(11)
        want = sampling.sample(x, gen, method=method, temperature=0.7, **kw)
        assert all(torch.equal(t, want) for t in toks), method
    with pytest.raises(ValueError, match="unknown sampling method"):
        registry.run("sampling", x, method="beam")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert registry.select("sampling", method="top_p",
                               backend="cuda") == "cuda_topp"


def test_best_and_record_race_without_losing_a_record():
    """Threads resolving (``best``, memoized) while others record: every
    thread sees a valid choice, and once the writers are done every key
    serves its last record — no stale memo survives a put."""
    import threading
    keys = [registry.triad_tune_key(n=128 * (i + 1), dtype=torch.float32,
                                    backend="cpu") for i in range(8)]
    errors = []
    stop = threading.Event()

    def reader(i):
        while not stop.is_set():
            got = registry.best("stream_triad", n=128 * (i % 8 + 1),
                                dtype=torch.float32, backend="cpu")
            if len(got) != 1 or got[0] not in (8, 32, 64):
                errors.append(got)

    def writer(i):
        for rows in (32, 64):
            registry.record("stream_triad", keys[i], (rows,))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        readers = [threading.Thread(target=reader, args=(i,))
                   for i in range(12)]
        writers = [threading.Thread(target=writer, args=(i,))
                   for i in range(8)]
        for t in readers + writers:
            t.start()
        for t in writers:
            t.join(timeout=30)
        stop.set()
        for t in readers:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in readers + writers)
    assert errors == []
    for i in range(8):
        assert registry.best("stream_triad", n=128 * (i + 1),
                             dtype=torch.float32, backend="cpu") == (64,)


def test_bench_autotune_halves_are_warm_on_rerun(tmp_path, capsys):
    """The autotune halves of bench_flash_prefill and bench_paged_decode
    (``--tune``) on the CPU: a cold sweep, then a fresh session over the
    same cache that times nothing."""
    from repro_torch.bench import bench_flash_prefill, bench_paged_decode
    cpu = torch.device("cpu")
    csv = []
    flash = bench_flash_prefill.autotune_half(
        csv, bench_flash_prefill.shapes(True), True, cpu,
        ProfileSession(cache_dir=str(tmp_path / "f")))
    assert flash["lowerings_cold"] == 2 and flash["lowerings_warm"] == 0
    assert (flash["bq"], flash["bk"]) in ((64, 32), (32, 32))
    paged = bench_paged_decode.autotune_half(
        csv, True, cpu, 512, ProfileSession(cache_dir=str(tmp_path / "p")))
    assert paged["lowerings_cold"] == 4 and paged["lowerings_warm"] == 0
    assert [row[0] for row in csv] == ["flash_autotune_warm_s",
                                       "paged_autotune_warm_s"]
    assert "<- chosen" in capsys.readouterr().out


def test_benches_persist_winners_only_in_a_named_root(tmp_path,
                                                      monkeypatch):
    """Without ``--cache-dir`` or ``$REPRO_CACHE_DIR`` the autotune
    benches sweep in a temporary root: nothing lands in the default root
    and the in-process table is left empty, so a runner's autotune
    changes no later run's tiles; ``--assert-warm`` refuses to run."""
    from repro_torch.bench import bench_autotune, bench_flash_prefill
    monkeypatch.delenv("REPRO_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    cpu = torch.device("cpu")
    summary = bench_autotune.run([], smoke=True, device=cpu)
    assert summary["sweeps"] == len(summary["families"]) > 0
    half = bench_flash_prefill.autotune_half(
        [], bench_flash_prefill.shapes(True), True, cpu)
    assert half["lowerings_cold"] == 2 and half["lowerings_warm"] == 0
    assert len(registry.tune_table()) == 0
    assert not (tmp_path / "home").exists()
    with pytest.raises(SystemExit):
        bench_autotune.main(["--smoke", "--device", "cpu", "--assert-warm"])


class _TimedSession(ProfileSession):
    """A CPU session that reports device seconds as the card would: under
    ``timer="auto"`` each probe's timer is taken from ``auto_timers`` in
    turn, under ``"events"`` every probe is event-timed."""

    def __init__(self, auto_timers, **kw):
        super().__init__(**kw)
        self.auto_timers = list(auto_timers)
        self.asked = []

    def measure(self, fn, *args, timer="auto", **kw):
        m = super().measure(fn, *args, timer=timer, **kw)
        self.asked.append(timer)
        used = (self.auto_timers[(len(self.asked) - 1) % len(
            self.auto_timers)] if timer == "auto" else "events")
        return __import__("dataclasses").replace(
            m, device_s=1e-6 * len(self.asked), timer=used)


@pytest.mark.parametrize("auto_timers,want", [
    (("profiler",), "profiler"),
    (("profiler", "events"), "events"),
    (("events",), "events"),
])
def test_a_sweep_scores_every_candidate_under_one_timer(tmp_path,
                                                        auto_timers, want):
    sess = _TimedSession(auto_timers, cache_dir=str(tmp_path / "t"))
    cands = [(4,), (8,), (16,)]
    rec = registry.autotune("stream_triad", sess, n=128 * 64,
                            dtype=torch.float32, backend="cpu",
                            candidates=cands)
    mixed = len(set(auto_timers)) > 1
    assert sess.asked == ["auto"] * 3 + (["events"] * 3 if mixed else [])
    assert rec.timer == want
    assert [r["timer"] for r in registry.dump_tune_table()["records"]] == \
        [want]
    registry.clear_tune_table()
    warm = registry.autotune("stream_triad", _TimedSession(
        auto_timers, cache_dir=str(tmp_path / "t")), n=128 * 64,
        dtype=torch.float32, backend="cpu", candidates=cands)
    assert not warm.swept and warm.timer == want
