"""The port's perf report (``repro_torch.core.perf_report``) against the
JAX package's ``repro.core.perf_report``, on the CPU.

* the suite cells: ``FAMILY_SUITE`` is the reference's, byte for byte,
  and splits as it does; the smoke candidates are the port's tiles;
  every ``CARD_SUITE`` cell sweeps its own default tile;
* ingest, ``build_report``, the renderers and ``compare`` give the
  reference's rows, table and verdicts over the same fixture (each
  package's own toolchain fields, ``FINGERPRINT_KEYS``);
* ``seed_tune_table`` pins records that ``best()`` serves;
  ``suite_inputs`` joins the keys the runners resolve, and
  ``measure_walls`` times a real ``registry.run`` on the CPU.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from repro.core import perf_report as jax_pr  # noqa: E402
from repro_torch.core import perf_report as pr  # noqa: E402
from repro_torch.core import hwinfo  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402

torch.set_num_threads(1)

RECORDS = [
    {"family": "stream_triad", "key": "triad-n65536-float32-cpu",
     "choice": [8], "score_s": 9e-6, "swept": True, "interpolated": False,
     "winner_events": {"FLOPS_TOTAL": 131072.0, "BYTES_ACCESSED": 786432.0}},
    {"family": "attention", "key": "b2h4kvh2sq128sk192dh32-float32-causal-cpu",
     "choice": [64, 32], "score_s": 5e-5, "swept": False,
     "interpolated": True,
     "winner_events": {"FLOPS_TOTAL": 2.5e7, "BYTES_ACCESSED": 2.9e7}},
    {"family": "jacobi7", "key": "jacobi7-x24y16z16t2-float32-cpu",
     "choice": [4], "score_s": 2e-7, "swept": False, "interpolated": False,
     "winner_events": {}},
    {"family": "paged_decode", "key": "pagedq8-b4kvh2g2dh32ps16ctx128-"
     "float32-cuda", "choice": [16, 2], "score_s": 1.2e-5, "swept": True,
     "winner_events": {"FLOPS_TOTAL": 1e6, "BYTES_ACCESSED": 1e9}},
]
TOOLCHAIN = {"torch": "2.11.0+cu128", "cuda": "12.8",
             "device": "NVIDIA H100 80GB HBM3", "nvcc": "V12.8.93",
             "backend": "cuda", "repro_src": "aaaa1111"}
JAX_TOOLCHAIN = {"jax": "0.4.x", "backend": "cpu", "xla_flags": "",
                 "repro_src": "aaaa1111"}
WALLS = {"stream_triad": {"key": RECORDS[0]["key"], "impl": "cuda_triad",
                          "wall_s": 4.5e-4},
         "paged_decode_q8": {"key": RECORDS[3]["key"],
                             "impl": "cuda_paged_q8", "wall_s": 2e-5}}
CHIP = hwinfo.H100_SXM


def _reports(walls=WALLS):
    return (pr.build_report(RECORDS, walls=walls, chip=CHIP,
                            toolchain=dict(TOOLCHAIN)),
            jax_pr.build_report(RECORDS, walls=walls, chip=CHIP,
                                toolchain=dict(JAX_TOOLCHAIN)))


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "root"))
    registry.clear_tune_table()
    yield
    registry.clear_tune_table()


def test_suites():
    assert pr.FAMILY_SUITE == jax_pr.FAMILY_SUITE
    assert set(pr._SMOKE_CANDIDATES) == set(jax_pr._SMOKE_CANDIDATES)
    for cell in pr.FAMILY_SUITE:
        assert pr.suite_family(cell) == jax_pr.suite_family(cell)
    assert pr.suite_candidates(False) == jax_pr.suite_candidates(False)
    assert pr.suite_candidates(True) == pr._SMOKE_CANDIDATES
    assert pr.suite_candidates(True, pr.CARD_SUITE) == pr.CARD_CANDIDATES
    # every card cell sweeps its default tile, and tunes a real knob
    for cell in pr.CARD_SUITE:
        family, impl, facts = pr.suite_family(cell, pr.CARD_SUITE)
        ts = registry._tuned_spec(family, impl).tune
        full = dict(facts, backend="cuda")
        if family == "paged_decode":
            full["page_size"] = 16
        assert ts.resolve_default(**full) in pr.CARD_CANDIDATES[cell], cell
        assert len(pr.CARD_CANDIDATES[cell]) >= 4


def test_ingest_is_the_references(tmp_path):
    assert pr.load_artifacts(str(tmp_path)) == {}
    (tmp_path / "BENCH_x.json").write_text("{not json")
    (tmp_path / "TUNE_TABLE.json").write_text(
        json.dumps({"records": RECORDS}))
    (tmp_path / "BENCH_autotune.json").write_text(
        json.dumps({"table": {"records": RECORDS[:1]}, "sweeps": 5,
                    "lowerings": 0}))
    (tmp_path / "BENCH_serve.json").write_text(
        json.dumps({"speedup": 1.5, "other": 2}))
    arts = pr.load_artifacts(str(tmp_path))
    assert arts == jax_pr.load_artifacts(str(tmp_path))
    assert "BENCH_x" not in arts
    assert pr.tune_records(arts) == jax_pr.tune_records(arts) == RECORDS
    assert pr.summarize_benches(arts) == jax_pr.summarize_benches(arts)


def test_report_rows_and_renderings_are_the_references():
    ours, theirs = _reports()
    assert ours["rows"] == theirs["rows"]
    assert ours["chip"] == theirs["chip"]
    assert pr.render_table(ours) == jax_pr.render_table(theirs)
    rows = {r["key"]: r for r in ours["rows"]}
    q8 = rows[RECORDS[3]["key"]]
    assert q8["impl"] == "cuda_paged_q8" and q8["bound"] == "memory"
    assert q8["achieved_frac"] == pytest.approx(1.2e-5 / 2e-5)
    md = pr.render_markdown(ours, failures=["f"], notes=["n"])
    jmd = jax_pr.render_markdown(theirs, failures=["f"], notes=["n"])
    assert md.splitlines()[3:] == jmd.splitlines()[3:]
    assert "torch 2.11.0+cu128 / CUDA 12.8" in md
    empty = pr.build_report([], chip=CHIP, toolchain=TOOLCHAIN)
    assert "perf report: 0 rows" in pr.render_table(empty)


def _degrade(rep, factor):
    rep = json.loads(json.dumps(rep))
    for r in rep["rows"]:
        if "achieved_frac" in r:
            r["achieved_frac"] *= factor
    return rep


def test_compare_is_the_references():
    ours, theirs = _reports()
    assert pr.compare(ours, ours) == jax_pr.compare(theirs, theirs) \
        == ([], [])
    for factor in (0.5, 0.9):
        for floor in (pr.WALL_FLOOR_S, 0.0):
            assert pr.compare(_degrade(ours, factor), ours,
                              wall_floor_s=floor) == \
                jax_pr.compare(_degrade(theirs, factor), theirs,
                               wall_floor_s=floor)
    # a winner flip fails unless the port's toolchain fingerprint moved
    flip = json.loads(json.dumps(ours))
    flip["rows"][0]["choice"] = [999]
    failures, _ = pr.compare(flip, ours)
    assert any("winner flipped" in f for f in failures)
    for field in pr.FINGERPRINT_KEYS:
        moved = json.loads(json.dumps(flip))
        moved["toolchain"][field] = "changed"
        failures, notes = pr.compare(moved, ours)
        assert failures == [] and any("exempt" in n for n in notes), field
    assert set(pr.FINGERPRINT_KEYS) == set(TOOLCHAIN)
    # new and missing rows are notes
    cur = json.loads(json.dumps(ours))
    cur["rows"] = cur["rows"][:-1] + [dict(cur["rows"][0],
                                           family="ssd_scan", key="k")]
    failures, notes = pr.compare(cur, ours)
    assert failures == [] and any("new row" in n for n in notes)
    assert any("missing" in n for n in notes)


def test_seeded_records_and_measured_walls_join():
    cells = ("stream_triad", "ssd_scan", "jacobi7")
    keys = {c: pr.suite_inputs(c, device="cpu")[2] for c in cells}
    records = [{"family": c, "key": keys[c], "choice": ch, "score_s": 1e-6,
                "swept": True, "winner_events": {"FLOPS_TOTAL": 1e5,
                                                 "BYTES_ACCESSED": 1e6}}
               for c, ch in zip(cells, ([16], [64], [8]))]
    assert pr.seed_tune_table(records) == 3
    assert registry.best("stream_triad", n=pr.FAMILY_SUITE["stream_triad"]
                         ["n"], backend="cpu") == (16,)
    walls = pr.measure_walls(records, families=cells, device="cpu",
                             repeats=1, calls_per_round=2)
    rep = pr.build_report(records, walls=walls, chip=CHIP,
                          toolchain=TOOLCHAIN)
    assert all(r.get("achieved_frac", 0) > 0 for r in rep["rows"])
    assert {r["family"]: r["impl"] for r in rep["rows"]} == {
        "stream_triad": "torch_triad", "ssd_scan": "torch_scan",
        "jacobi7": "wavefront"}                 # the CPU's choices


@pytest.mark.parametrize("suite", ["family", "card"])
def test_suite_inputs_join_the_runners_keys(suite):
    cells = pr.FAMILY_SUITE if suite == "family" else pr.CARD_SUITE
    for cell in cells:
        if suite == "card" and cell in ("stream_triad", "jacobi7",
                                        "ssd_scan", "attention"):
            continue                 # card-sized tensors: keys below
        _, _, key = pr.suite_inputs(cell, suite=cells, device="cpu")
        family, impl, cfacts = pr.suite_family(cell, cells)
        ts = registry._tuned_spec(family, impl).tune
        facts = dict(cfacts, backend="cpu")
        facts.setdefault("dtype", "float32")
        if family == "paged_decode":
            facts["page_size"] = pr._suite_page_size(
                (), cell, cells, quantized=facts.get("quantized", False))
        assert key == (ts.lookup_key or ts.key)(**facts), cell
