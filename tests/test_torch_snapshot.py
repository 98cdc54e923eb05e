"""The port's serving snapshots against the JAX package's, on the CPU.

``repro_torch.checkpoint.store`` writes the JAX package's format byte for
byte (magic, version, header line, CRC32, length, the ``__nd__`` array
encoding), so a snapshot either package writes restores on the other:

* the store round-trips, refuses a truncated, CRC-flipped or bad-magic
  file with ``SnapshotCorrupt``, and writes the same bytes as the JAX
  store for the same payload; bf16 arrays go through both packages bit
  for bit, the port's loader run in a subprocess where ``ml_dtypes``
  cannot be imported;
* a run killed after one segment (qwen2-0.5b ``SMOKE``, fp32, JAX
  ``LM.init`` parameters bridged over, the prefix cache on) restores on a
  FRESH engine to the JAX uninterrupted run's greedy tokens, with the page
  index in use: JAX writes and the port restores, and the port writes and
  JAX restores, over fp32 and int8 pages;
* retention, the config checks (``max_seq``, ``seed``, ``spec`` raise; a
  pool-size mismatch drops the index and replays), a spec engine's
  snapshot, zamba2's restore by replay, and the host-sync rule: with
  snapshots on, host syncs = segments + snapshots that carry an index.

Mirrors ``tests/test_robustness.py``'s snapshot tests (``:157``,
``:180``, ``:309``, ``:331``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.checkpoint import store as jax_store
from repro.configs.qwen2_0_5b import SMOKE as JAX_SMOKE
from repro.configs.zamba2_1_2b import SMOKE as JAX_ZAMBA_SMOKE
from repro.core.features import default_features
from repro.models.lm import LM as JaxLM
from repro.models.lm import LMConfig as JaxLMConfig
from repro.serve import engine as jax_engine
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import store
from repro_torch.configs.qwen2_0_5b import SMOKE
from repro_torch.configs.zamba2_1_2b import SMOKE as ZAMBA_SMOKE
from repro_torch.models.lm import LM, LMConfig
from repro_torch.serve import engine
from repro_torch.serve.spec import SpecConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SC = dict(max_seq=64, batch_slots=3, admission_chunk=4, page_size=8)


def _pair(jcfg, cfg, seed, embed_scale=1.0):
    jlm = JaxLM(jcfg, default_features().with_(remat_policy="none"),
                dtype=jnp.float32)
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.PRNGKey(seed)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * embed_scale
    lm = LM(cfg, torch.float32, device="cpu")
    lm.load_state_dict(params_from_jax(jparams, cfg))
    return jlm, jax.tree.map(jnp.asarray, jparams), lm


@pytest.fixture(scope="module")
def smoke():
    return _pair(JAX_SMOKE, SMOKE, 0, embed_scale=0.1)


def _workload(vocab=SMOKE.vocab, seed=5):
    """(prompt, budget) per rid: a 12-token shared prefix behind four of
    six prompts (full-page hits and in-page forks at page size 8), ragged
    budgets long enough that a kill after one segment leaves work."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, 12).tolist()

    def tail(n):
        return rng.integers(1, vocab, n).tolist()

    prompts = [shared + tail(5), shared + tail(3), tail(7),
               shared[:10] + tail(4), shared + tail(6), tail(4)]
    return list(zip(prompts, [9, 6, 11, 5, 8, 7]))


def _submit(mod, sched, work, spec_rows=False):
    for rid, (prompt, budget) in enumerate(work):
        sched.submit(mod.Request(rid=rid, prompt=list(prompt),
                                 max_new_tokens=budget,
                                 spec=spec_rows and rid % 2 == 0))
    return sched


def _tokens(sched):
    return {rid: list(r.generated) for rid, r in sched.completed.items()}


def _uninterrupted(mod, eng, work, **kw):
    sched = _submit(mod, mod.BatchScheduler(eng, **kw), work)
    sched.run()
    return _tokens(sched)


def _killed(mod, eng, work, snapdir, segments=1, **kw):
    """Run ``segments`` segments with a snapshot after each, then exit
    (the early-exit snapshot is the newest); returns the scheduler."""
    sched = _submit(mod, mod.BatchScheduler(
        eng, snapshot_dir=str(snapdir), snapshot_every=1, **kw), work)
    sched.run(max_segments=segments)
    assert len(sched.completed) < len(work), "nothing left to restore"
    return sched


def _restore_event(sched):
    (ev,) = [e for e in sched.ft_events if e["type"] == "restore"]
    return ev


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------

def test_snapshot_roundtrip_and_corruption(tmp_path):
    payload = {"a": 1, "arr": np.arange(6, dtype=np.float32).reshape(2, 3),
               "nested": [{"b": np.int64(7)}],
               "t": torch.arange(4, dtype=torch.int8)}
    p = str(tmp_path / "s.snap")
    store.save_serving_snapshot(p, payload)
    back = store.load_serving_snapshot(p)
    assert back["a"] == 1 and back["nested"][0]["b"] == 7
    np.testing.assert_array_equal(back["arr"], payload["arr"])
    np.testing.assert_array_equal(back["t"], np.arange(4, dtype=np.int8))
    assert back["t"].dtype == np.int8
    blob = bytearray(open(p, "rb").read())
    blob[-3] ^= 0x01
    open(p, "wb").write(bytes(blob))
    with pytest.raises(store.SnapshotCorrupt):
        store.load_serving_snapshot(p)
    open(p, "wb").write(bytes(blob[: len(blob) // 2]))
    with pytest.raises(store.SnapshotCorrupt):
        store.load_serving_snapshot(p)
    with pytest.raises(FileNotFoundError):
        store.load_serving_snapshot(str(tmp_path / "missing.snap"))
    assert store.list_snapshots(str(tmp_path / "nowhere")) == []
    assert store.latest_snapshot(str(tmp_path / "nowhere")) is None


def _damage(kind, blob: bytes) -> bytes:
    head, _, body = blob.partition(b"\n")
    if kind == "truncated":
        return blob[:-7]
    if kind == "crc_flipped":
        b = bytearray(blob)
        b[len(head) + 1 + len(body) // 2] ^= 0xFF
        return bytes(b)
    if kind == "bad_magic":
        return head.replace(b"repro-serving-snapshot",
                            b"repro-serving-snapshoT") + b"\n" + body
    if kind == "bad_version":
        return head.replace(b'"version": 1', b'"version": 2') + b"\n" + body
    if kind == "no_header":
        return body
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["truncated", "crc_flipped", "bad_magic",
                                  "bad_version", "no_header"])
def test_damaged_snapshot_raises_in_both_packages(kind, smoke, tmp_path):
    """A damaged snapshot is detected by both loaders and by
    ``Engine.restore``, never restored."""
    _, _, lm = smoke
    eng = engine.Engine(lm, engine.ServeConfig(**SC), device="cpu")
    sched = _killed(engine, eng, _workload(), tmp_path / "s")
    path = store.latest_snapshot(str(tmp_path / "s"))
    bad = str(tmp_path / "bad.snap")
    open(bad, "wb").write(_damage(kind, open(path, "rb").read()))
    with pytest.raises(store.SnapshotCorrupt):
        store.load_serving_snapshot(bad)
    with pytest.raises(jax_store.SnapshotCorrupt):
        jax_store.load_serving_snapshot(bad)
    with pytest.raises(store.SnapshotCorrupt):
        engine.Engine(lm, eng.cfg, device="cpu").restore(bad)
    assert sched.metrics["snapshots"] == 2     # interval + early exit


def test_store_writes_the_jax_stores_bytes(tmp_path):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 16, (2, 3, 4), dtype=np.uint16)
    common = dict(cfg={"seed": 0, "spec": None, "temperature": 0.0},
                  i8=rng.integers(-128, 128, (3, 5), dtype=np.int8),
                  f32=rng.standard_normal((2, 4)).astype(np.float32),
                  ids=[3, 1, 2], events=[{"wall_s": 0.125, "rid": 7}])
    pj, pt = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    jax_store.save_serving_snapshot(
        pj, dict(common, bf16=bits.view(ml_dtypes.bfloat16)))
    store.save_serving_snapshot(
        pt, dict(common, bf16=torch.from_numpy(bits.view(np.int16).copy())
                 .view(torch.bfloat16)))
    assert open(pj, "rb").read() == open(pt, "rb").read()
    back = store.load_serving_snapshot(pj)
    assert back["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back["bf16"].view(torch.int16).numpy().view(np.uint16), bits)
    jback = jax_store.load_serving_snapshot(pt)
    np.testing.assert_array_equal(jback["bf16"].view(np.uint16), bits)
    np.testing.assert_array_equal(jback["i8"], common["i8"])


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None          # importing it now raises
import numpy as np
import torch
from repro_torch.checkpoint import store
src, dst, want = sys.argv[1:4]
snap = store.load_serving_snapshot(src)
pages = snap["index"]["pages"]
for key in ("k", "v"):
    assert pages[key].dtype == torch.bfloat16, pages[key].dtype
    got = pages[key].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, np.load(want)[key])
store.save_serving_snapshot(dst, snap)
assert "jax" not in sys.modules and "repro" not in sys.modules
print("ok")
"""


def _bits(pages):
    return {k: (pages[k].view(torch.int16).numpy().view(np.uint16)
                if isinstance(pages[k], torch.Tensor)
                else pages[k].view(np.uint16)) for k in ("k", "v")}


def test_bf16_pages_cross_both_packages_bit_for_bit(smoke, tmp_path):
    """bf16 pages, both ways: the JAX engine's snapshot loads in the port
    without ``ml_dtypes`` (a subprocess) into ``torch.bfloat16`` with the
    JAX loader's bits and re-saves to the same bytes; the port engine's
    snapshot loads in the JAX package with the port loader's bits and
    re-saves to the same bytes; and the port restores its own bf16
    snapshot to its uninterrupted tokens."""
    jlm, jparams, lm = smoke
    sc = dict(SC, kv_dtype="bf16")
    work = _workload()
    _killed(jax_engine, jax_engine.Engine(
        jlm, jparams, jax_engine.ServeConfig(**sc)), work, tmp_path / "j")
    src = jax_store.latest_snapshot(str(tmp_path / "j"))
    jpages = jax_store.load_serving_snapshot(src)["index"]["pages"]
    assert jpages["k"].dtype == ml_dtypes.bfloat16
    want = str(tmp_path / "want.npz")
    np.savez(want, **_bits(jpages))
    dst = str(tmp_path / "resaved.snap")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, src, dst,
                          want], capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    assert open(dst, "rb").read() == open(src, "rb").read()

    cfg = engine.ServeConfig(**sc)
    _killed(engine, engine.Engine(lm, cfg, device="cpu"), work,
            tmp_path / "t")
    tsrc = store.latest_snapshot(str(tmp_path / "t"))
    tsnap = store.load_serving_snapshot(tsrc)
    jsnap = jax_store.load_serving_snapshot(tsrc)
    assert jsnap["index"]["pages"]["k"].dtype == ml_dtypes.bfloat16
    for key, bits in _bits(jsnap["index"]["pages"]).items():
        np.testing.assert_array_equal(bits,
                                      _bits(tsnap["index"]["pages"])[key])
    tdst = str(tmp_path / "t_resaved.snap")
    jax_store.save_serving_snapshot(tdst, jsnap)
    assert open(tdst, "rb").read() == open(tsrc, "rb").read()
    sched = engine.Engine(lm, cfg, device="cpu").restore(tsrc)
    assert _restore_event(sched)["index_pages"] > 0
    sched.run()
    assert _tokens(sched) == _uninterrupted(
        engine, engine.Engine(lm, cfg, device="cpu"), work)


# ---------------------------------------------------------------------------
# kill and restore
# ---------------------------------------------------------------------------

def test_kill_and_restore_token_parity(smoke, tmp_path):
    """Restore on a FRESH port engine equals the uninterrupted run; with
    snapshots on, host syncs = segments + snapshots carrying an index."""
    _, _, lm = smoke
    work = _workload()
    cfg = engine.ServeConfig(**SC)
    want = _uninterrupted(engine, engine.Engine(lm, cfg, device="cpu"), work)
    eng = engine.Engine(lm, cfg, device="cpu")
    sched = _killed(engine, eng, work, tmp_path)
    indexed = [e for e in sched.ft_events
               if e["type"] == "snapshot" and e["index_pages"]]
    assert len(indexed) == 2
    assert eng.host_syncs == sched.metrics["segments"] + len(indexed)
    eng2 = engine.Engine(lm, cfg, device="cpu")
    sched2 = eng2.restore(store.latest_snapshot(str(tmp_path)))
    assert sched2.metrics["restores"] == 1
    assert _restore_event(sched2)["index_pages"] > 0
    sched2.run()
    assert _tokens(sched2) == want
    sched2.check()
    snaps2 = [e for e in sched2.ft_events
              if e["type"] == "snapshot" and e["index_pages"]]
    assert eng2.host_syncs == sched2.metrics["segments"] + len(snaps2)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_package_restore_gives_the_jax_tokens(smoke, tmp_path, writer,
                                                    kv_dtype):
    """One package is killed after a segment and writes; a fresh engine of
    the other restores and finishes; every request's greedy tokens equal
    the JAX uninterrupted run's, with the page index in use."""
    jlm, jparams, lm = smoke
    sc = dict(SC, kv_dtype=kv_dtype)
    work = _workload()

    def jax_eng():
        return jax_engine.Engine(jlm, jparams, jax_engine.ServeConfig(**sc))

    def torch_eng():
        return engine.Engine(lm, engine.ServeConfig(**sc), device="cpu")

    want = _uninterrupted(jax_engine, jax_eng(), work)
    if writer == "jax":
        _killed(jax_engine, jax_eng(), work, tmp_path)
        sched = torch_eng().restore(jax_store.latest_snapshot(str(tmp_path)))
    else:
        _killed(engine, torch_eng(), work, tmp_path)
        sched = jax_eng().restore(store.latest_snapshot(str(tmp_path)))
    assert _restore_event(sched)["index_pages"] > 0
    sched.run()
    assert _tokens(sched) == want
    assert sched.metrics["prefix_hits"] > 0


def test_snapshot_retention(smoke, tmp_path):
    _, _, lm = smoke
    eng = engine.Engine(lm, engine.ServeConfig(**SC), device="cpu")
    sched = engine.BatchScheduler(eng, snapshot_dir=str(tmp_path),
                                  snapshot_every=1, snapshot_keep=2)
    _submit(engine, sched, _workload())
    sched.run()
    snaps = store.list_snapshots(str(tmp_path))
    assert 0 < len(snaps) <= 2
    assert sched.metrics["snapshots"] >= 3
    assert snaps[-1].endswith(f"snap_{int(sched.metrics['segments']):08d}"
                              ".snap")
    assert store.load_serving_snapshot(snaps[-1])["reason"] == "exit"


def test_restore_checks_the_engine_config(smoke, tmp_path):
    """``max_seq``, ``seed`` and ``spec`` mismatches raise; a pool of
    another size drops the page index and replays to the same tokens."""
    _, _, lm = smoke
    work = _workload()
    cfg = engine.ServeConfig(**SC)
    want = _uninterrupted(engine, engine.Engine(lm, cfg, device="cpu"), work)
    _killed(engine, engine.Engine(lm, cfg, device="cpu"), work, tmp_path)
    snap = store.latest_snapshot(str(tmp_path))
    for kw, key in ((dict(max_seq=96), "max_seq"), (dict(seed=1), "seed")):
        other = engine.Engine(lm, engine.ServeConfig(**dict(SC, **kw)),
                              device="cpu")
        with pytest.raises(ValueError, match=f"config mismatch on '{key}'"):
            other.restore(snap)
    spec_eng = engine.Engine(lm, cfg, device="cpu", draft_lm=lm,
                             spec=SpecConfig(draft_config=lm.cfg,
                                             num_draft_tokens=2))
    with pytest.raises(ValueError, match="config mismatch on 'spec'"):
        spec_eng.restore(snap)
    pool_pages = engine.Engine(lm, cfg, device="cpu").pool_pages
    bigger = engine.Engine(lm, engine.ServeConfig(**dict(
        SC, pool_pages=pool_pages + 8)), device="cpu")
    sched = bigger.restore(snap)
    assert _restore_event(sched)["index_pages"] == 0
    sched.run()
    assert _tokens(sched) == want


TKW = dict(name="snap-spec-t", family="dense", vocab=256, d_model=64,
           n_layers=2, num_heads=8, num_kv_heads=4, d_ff=128)
DKW = dict(name="snap-spec-d", family="dense", vocab=256, d_model=32,
           n_layers=1, num_heads=4, num_kv_heads=2, d_ff=64)


def test_spec_engine_snapshot_restores_to_the_same_tokens(tmp_path):
    """A mixed spec / non-spec batch killed after one round restores on a
    fresh spec engine: its draft twins replay from the prompt, and fp32
    greedy tokens equal the uninterrupted spec run's and target-only's."""
    _, _, lm = _pair(JaxLMConfig(**TKW), LMConfig(**TKW), 0)
    _, _, dlm = _pair(JaxLMConfig(**DKW), LMConfig(**DKW), 1)
    sc = engine.ServeConfig(max_seq=64, batch_slots=3, page_size=8,
                            admission_chunk=4)
    spec = SpecConfig(draft_config=dlm.cfg, num_draft_tokens=3)

    def spec_eng():
        return engine.Engine(lm, sc, device="cpu", spec=spec, draft_lm=dlm)

    work = _workload(vocab=256, seed=9)
    base = _uninterrupted(engine, engine.Engine(lm, sc, device="cpu"), work)
    sched = _submit(engine, engine.BatchScheduler(spec_eng()), work,
                    spec_rows=True)
    sched.run()
    assert _tokens(sched) == base
    killed = _submit(engine, engine.BatchScheduler(
        spec_eng(), snapshot_dir=str(tmp_path), snapshot_every=1), work,
        spec_rows=True)
    killed.run(max_segments=2)
    snap = store.load_serving_snapshot(store.latest_snapshot(str(tmp_path)))
    assert any(d["spec"] for d in snap["pending"])
    assert snap["config"]["spec"] == list(spec.signature())
    sched2 = spec_eng().restore(store.latest_snapshot(str(tmp_path)))
    assert _restore_event(sched2)["index_pages"] > 0
    sched2.run()
    assert _tokens(sched2) == base
    sched2.check()


def test_zamba2_restores_by_replay(tmp_path):
    """Dense KV holds no page index: every pending request replays
    ``prompt + generated`` through prefill (SSD state, conv tail and the
    shared block's KV rebuilt) to the uninterrupted run's tokens."""
    _, _, lm = _pair(JAX_ZAMBA_SMOKE, ZAMBA_SMOKE, 0, embed_scale=0.1)
    rng = np.random.default_rng(6)
    work = [(rng.integers(1, ZAMBA_SMOKE.vocab, n).tolist(), budget)
            for n, budget in zip((19, 5, 23, 11), (9, 6, 7, 5))]
    cfg = engine.ServeConfig(max_seq=64, batch_slots=2, admission_chunk=4)
    want = _uninterrupted(engine, engine.Engine(lm, cfg, device="cpu"), work)
    eng = engine.Engine(lm, cfg, device="cpu")
    sched = _killed(engine, eng, work, tmp_path)
    assert eng.host_syncs == sched.metrics["segments"]      # no index
    sched2 = engine.Engine(lm, cfg, device="cpu").restore(
        store.latest_snapshot(str(tmp_path)))
    assert _restore_event(sched2)["index_pages"] == 0
    sched2.run()
    assert _tokens(sched2) == want
    assert any(r.generated for r in sched.requests.values()
               if not r.finished), "the kill left no partial progress"
