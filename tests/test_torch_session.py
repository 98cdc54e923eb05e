"""The port's ProfileSession (``repro_torch.core.session``) on the CPU,
against the JAX package's ``repro.core.session`` where the two share
code.

* ``fingerprint_callable`` is the reference's for the same callables
  (functions, closures, ``functools.partial`` unwrapped);
* ``describe_abstract`` describes tensors by shape, dtype, strides and
  device;
* ``measure`` runs a probe once into an event collection and caches it:
  a hit runs nothing (``lowerings`` unchanged), a new shape misses, a
  fresh process hits the first one's entry, a corrupt entry re-measures;
  on the CPU there is no device time;
* the toolchain names torch, CUDA, the card, nvcc, the backend and a
  digest of every ``.py`` / ``.cu`` / ``.cuh`` under ``src/repro_torch``;
* ``sweep`` needs a ``cell_fn`` (its default is item 14's dry run).
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.core import session as jax_session  # noqa: E402
from repro_torch.core import hwinfo, session  # noqa: E402
from repro_torch.core.session import ProfileSession  # noqa: E402
from repro_torch.kernels.stream_triad import stream_triad  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _root(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "root"))


def _triad(b, c, *, s=2.5, block_rows=8):
    return stream_triad(b, c, s=s, block_rows=block_rows)


def _make_closure(scale):
    def inner(x):
        return x * scale
    return inner


@pytest.mark.parametrize("fn", [
    _triad,
    functools.partial(_triad, s=3.0, block_rows=16),
    functools.partial(functools.partial(_triad, block_rows=4), s=1.0),
    _make_closure(2.5),
    _make_closure(_triad),
])
def test_fingerprint_is_the_references(fn):
    assert session.fingerprint_callable(fn) == \
        jax_session.fingerprint_callable(fn)
    # stable and address-free across calls
    assert "0x" not in session.fingerprint_callable(fn)


def test_partials_with_other_arguments_differ():
    a = functools.partial(_triad, block_rows=8)
    b = functools.partial(_triad, block_rows=16)
    assert session.fingerprint_callable(a) != session.fingerprint_callable(b)


def test_describe_abstract_covers_shape_dtype_stride_device():
    x = torch.zeros(4, 6)
    d = session.describe_abstract((x, x.t(), {"k": 3}))
    assert d["treedef"] == "(*,*,{'k':*})"
    assert d["leaves"][0] == {"shape": [4, 6], "dtype": "torch.float32",
                              "stride": [6, 1], "device": "cpu"}
    assert d["leaves"][1]["stride"] == [1, 6]
    assert d["leaves"][2] == {"py": "3"}


def test_toolchain_fields_and_source_digest():
    tc = session._toolchain()
    assert set(tc) == {"torch", "cuda", "device", "nvcc", "backend",
                       "repro_src"}
    assert tc["torch"] == torch.__version__
    assert tc["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    # the digest covers the CUDA sources too
    src = os.path.join(ROOT, "src", "repro_torch")
    names = [n for _d, _s, files in os.walk(src) for n in files]
    assert any(n.endswith(".cu") for n in names)
    assert len(tc["repro_src"]) == 16


def test_measure_caches_the_run(tmp_path):
    sess = ProfileSession(cache_dir=str(tmp_path / "c"))
    b = torch.ones(128 * 64)
    fn = functools.partial(_triad, block_rows=8)
    m = sess.measure(fn, b, b, region="triad")
    assert sess.lowerings == 1 and m.device_s is None
    assert m.events["LAUNCHES"] == 1          # the wrapper's plain twin
    assert m.events["BYTES_ACCESSED"] == 3 * 4 * b.numel()
    assert m.region == "triad" and m.chip.name == "host-cpu"
    m2 = sess.measure(fn, b, b)
    assert sess.lowerings == 1                # a hit runs nothing
    assert m2.events.counts == m.events.counts
    assert sess.cache.stats.hits == 1
    sess.measure(fn, torch.ones(128 * 32), torch.ones(128 * 32))
    assert sess.lowerings == 2                # a new shape misses
    assert "timed probes" in sess.stats()


def test_measure_hits_across_processes_and_heals(tmp_path):
    root = str(tmp_path / "c")
    code = textwrap.dedent(f"""
        import functools, json, sys, torch
        sys.path.insert(0, {os.path.join(ROOT, "tests")!r})
        from test_torch_session import _triad
        from repro_torch.core.session import ProfileSession
        s = ProfileSession(cache_dir={root!r})
        b = torch.ones(128 * 64)
        m = s.measure(functools.partial(_triad, block_rows=8), b, b)
        print(json.dumps([s.lowerings, m.events["BYTES_ACCESSED"]]))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = [json.loads(subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, check=True, timeout=300).stdout.strip().splitlines()[-1])
        for _ in range(2)]
    assert runs[0] == [1, 3 * 4 * 128 * 64]
    assert runs[1] == [0, 3 * 4 * 128 * 64]      # the fresh process hit
    # a schema-valid entry with garbage content re-measures
    sess = ProfileSession(cache_dir=root)
    (digest,) = list(sess.cache.entries())
    sess.cache.put(digest, {"kind": "measure", "events": "garbage"})
    b = torch.ones(128 * 64)
    sess.measure(functools.partial(_triad, block_rows=8), b, b)
    assert sess.lowerings == 1 and sess.cache.stats.quarantined == 1


def test_no_cache_always_runs(tmp_path):
    sess = ProfileSession(cache_dir=str(tmp_path / "c"), enabled=False)
    b = torch.ones(128)
    for _ in range(2):
        sess.measure(functools.partial(_triad, block_rows=8), b, b)
    assert sess.lowerings == 2 and len(sess.cache) == 0


def test_sweep_needs_a_cell_fn_until_item_14(tmp_path):
    # without a cell_fn a sweep runs the dry run (launch/dryrun.run_cell,
    # its walk cached whole: tests/test_torch_dryrun.py)
    sess = ProfileSession(cache_dir=str(tmp_path / "dry"))
    (rec,) = sess.sweep(["zamba2-1.2b"], ["decode_32k"], parallel=1)
    assert rec["status"] == "ok"
    assert rec["cell"] == "zamba2-1.2b/decode_32k/16x16"
    assert set(rec["derived"]) == {"ROOFLINE"} and sess.lowerings == 1
    sess = ProfileSession(cache_dir=str(tmp_path / "c"))

    def cell(arch, shape):
        if shape == "bad":
            raise RuntimeError("boom")
        return {"cell": f"{arch}/{shape}", "status": "ok",
                "events": {"FLOPS_TOTAL": 1e9, "BYTES_ACCESSED": 1e9},
                "time_s": 1e-3}

    recs = sess.sweep(["a", "b"], ["s", "bad"], cell_fn=cell, parallel=2)
    assert [r["cell"] for r in recs] == ["a/s", "a/bad", "b/s", "b/bad"]
    assert recs[1]["status"] == "FAILED" and "boom" in recs[1]["error"]
    assert set(recs[0]["derived"]) == {"ROOFLINE"}


class _Avg:
    def __init__(self, key, count, us):
        self.key, self.count, self.self_device_time_total = key, count, us
        self.device_type = torch.autograd.DeviceType.CUDA


@pytest.mark.parametrize("recorded,launches,want", [
    # every call's kernel and every flush's fill: the profiler's sum
    ((("kern", 10, 50.0), ("at::native::FillFunctor", 10, 99.0)), 1,
     (5.0, "profiler")),
    # two kernels a call, and the call's own fill beside the flush's
    ((("a", 10, 50.0), ("b", 20, 30.0), ("at::native::FillFunctor", 20,
                                         99.0)), 2, (8.0, "profiler")),
    # records dropped (a late, long process): CUDA events instead
    ((("kern", 3, 15.0), ("at::native::FillFunctor", 10, 99.0)), 1,
     (7.0, "events")),
    ((("kern", 10, 50.0), ("at::native::FillFunctor", 4, 40.0)), 1,
     (7.0, "events")),
    ((), 1, (7.0, "events")),
    # a partial drop of a call that launches several kernels
    ((("a", 10, 50.0), ("b", 7, 21.0), ("at::native::FillFunctor", 10,
                                        99.0)), 2, (7.0, "events")),
    # fewer kernels than the call declares launches
    ((("kern", 10, 50.0), ("at::native::FillFunctor", 10, 99.0)), 3,
     (7.0, "events")),
])
def test_device_reader_falls_back_when_the_profiler_drops_kernels(
        monkeypatch, recorded, launches, want):
    from repro_torch.core import devtime

    class _Prof:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [_Avg(*r) for r in recorded]

    monkeypatch.setattr(devtime.torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(devtime.torch.profiler, "profile",
                        lambda **kw: _Prof())
    monkeypatch.setattr(devtime, "event_us_per_call",
                        lambda fn, n, flush: 7.0)
    flush = torch.zeros(4)
    assert devtime.device_us_per_call(lambda: None, n=10, flush=flush,
                                      launches=launches) == want


def test_measure_keys_the_timer_asked_for(tmp_path):
    sess = ProfileSession(cache_dir=str(tmp_path / "k"))
    x = torch.ones(8)
    a = sess.measure_digest(torch.add, (x, x), {}, hwinfo.H100_SXM)[0]
    e = sess.measure_digest(torch.add, (x, x), {}, hwinfo.H100_SXM,
                            "events")[0]
    assert a != e
    m = sess.measure(torch.add, x, x, timer="events")
    assert m.timer is None and m.device_s is None       # the CPU times not
    assert sess.measure(torch.add, x, x, timer="events").timer is None
    assert sess.lowerings == 1
    with pytest.raises(ValueError, match="timer"):
        sess.measure(torch.add, x, x, timer="wall")
