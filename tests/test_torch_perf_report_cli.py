"""The port's perf-report CLI (``repro_torch.launch.perf_report``) on the
CPU, beside the JAX package's (``repro.launch.perf_report``).

* ``--check`` with ``--gate`` re-gates a written report: exit 0 against
  its own baseline, exit 2 on a flipped tune winner, as the reference's
  CLI does on the same files;
* no baseline: a warning, exit 0; ``--update-baseline`` writes one
  (under ``tmp_path``) that the next run gates against;
* a baseline of another chip (the committed ``PERF_BASELINE.json`` is
  the JAX package's, on TPU ceilings) is printed as not comparable and
  never gated, and ``--update-baseline`` refuses to overwrite it;
* ``--device cpu --no-measure`` and ``--device cpu`` build a report from
  a cold tune of the family suite;
* the committed ``PERF_BASELINE.json`` is byte-for-byte unchanged;
* ``cli.resolve_impls`` / ``cli.impl_context`` pin what ``--impl`` and
  ``--attn-impl`` name.
"""

import argparse
import hashlib
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch import perf_report as jax_cli  # noqa: E402
from repro_torch.core import hwinfo  # noqa: E402
from repro_torch.core import perf_report as pr  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import cli  # noqa: E402
from repro_torch.launch import perf_report as cli_main  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "PERF_BASELINE.json"

RECORDS = [
    {"family": "stream_triad", "key": "triad-n65536-float32-cpu",
     "choice": [8], "score_s": 9e-6, "swept": True,
     "winner_events": {"FLOPS_TOTAL": 131072.0, "BYTES_ACCESSED": 786432.0}},
    {"family": "jacobi7", "key": "jacobi7-x24y16z16t2-float32-cpu",
     "choice": [4], "score_s": 2e-7, "swept": False, "winner_events": {}},
]
TOOLCHAIN = {"torch": "2.11.0+cu128", "cuda": "12.8",
             "device": "NVIDIA H100 80GB HBM3", "nvcc": "V12.8.93",
             "backend": "cuda", "repro_src": "aaaa1111"}
WALLS = {"stream_triad": {"key": RECORDS[0]["key"], "impl": "cuda_triad",
                          "wall_s": 4.5e-4}}


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture(autouse=True)
def committed_baseline_untouched(tmp_path, monkeypatch):
    """Every test runs in ``tmp_path`` with its own cache root, and leaves
    the committed baseline as it found it."""
    before = _digest(COMMITTED)
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.chdir(tmp_path)
    registry.clear_tune_table()
    yield
    registry.clear_tune_table()
    assert _digest(COMMITTED) == before


def _write(path: Path, doc) -> str:
    path.write_text(json.dumps(doc))
    return str(path)


def _report(**kw):
    return pr.build_report(RECORDS, walls=WALLS, chip=hwinfo.H100_SXM,
                           toolchain=dict(TOOLCHAIN), **kw)


@pytest.mark.parametrize("main", [cli_main.main, jax_cli.main],
                         ids=["port", "reference"])
def test_check_gates_a_written_report_exit_0_and_2(tmp_path, main, capsys):
    report = _report()
    rpath = _write(tmp_path / "report.json", report)
    base = _write(tmp_path / "base.json", report)
    assert main(["--check", rpath, "--baseline", base, "--gate"]) == 0
    assert "[gate] ok" in capsys.readouterr().out
    flipped = json.loads(json.dumps(report))
    flipped["rows"][1]["choice"] = [16]                # same toolchain
    fpath = _write(tmp_path / "flipped.json", flipped)
    assert main(["--check", fpath, "--baseline", base, "--gate"]) == 2
    out = capsys.readouterr().out
    assert "tune winner flipped" in out and "exiting non-zero" in out
    # without --gate the same verdict is printed and the exit is 0
    assert main(["--check", fpath, "--baseline", base]) == 0


def test_no_baseline_warns_and_update_writes_one(tmp_path, capsys):
    rpath = _write(tmp_path / "report.json", _report())
    base = tmp_path / "new_base.json"
    assert cli_main.main(["--check", rpath, "--baseline", str(base),
                          "--gate", "--update-baseline"]) == 0
    out = capsys.readouterr().out
    assert "no baseline at" in out and f"wrote {base}" in out
    assert json.loads(base.read_text()) == json.loads(
        Path(rpath).read_text())
    assert cli_main.main(["--check", rpath, "--baseline", str(base),
                          "--gate"]) == 0
    assert "[gate] ok" in capsys.readouterr().out


def test_default_baseline_is_the_ports_own(tmp_path, capsys):
    """Run where the JAX package's baseline lies: the default reads the
    port's own file, which is not there, and leaves the other alone."""
    (tmp_path / "PERF_BASELINE.json").write_bytes(COMMITTED.read_bytes())
    flipped = _report()
    flipped["rows"][1]["choice"] = [16]
    rpath = _write(tmp_path / "report.json", flipped)
    assert cli_main.main(["--check", rpath, "--gate"]) == 0
    out = capsys.readouterr().out
    assert "no baseline at PERF_BASELINE_TORCH.json" in out
    assert "tpu-v5e" not in out and "FAIL" not in out
    assert cli_main.main(["--check", rpath, "--update-baseline"]) == 0
    assert (tmp_path / "PERF_BASELINE_TORCH.json").exists()
    assert (tmp_path / "PERF_BASELINE.json").read_bytes() == \
        COMMITTED.read_bytes()


def test_another_chips_baseline_is_not_gated_nor_overwritten(tmp_path,
                                                             capsys):
    committed = json.loads(COMMITTED.read_text())
    assert committed["chip"]["name"] == "tpu-v5e"
    flipped = _report()
    flipped["rows"][1]["choice"] = [16]
    rpath = _write(tmp_path / "report.json", flipped)
    # the committed file itself, and a copy with a row the report flips
    tpu = json.loads(json.dumps(_report()))
    tpu["chip"] = committed["chip"]
    tpath = _write(tmp_path / "tpu.json", tpu)
    for base in (str(COMMITTED), tpath):
        assert cli_main.main(["--check", rpath, "--baseline", base,
                              "--gate"]) == 0
        out = capsys.readouterr().out
        assert "not comparable, not gated" in out
        assert "FAIL" not in out
        with pytest.raises(SystemExit) as e:
            cli_main.main(["--check", rpath, "--baseline", base,
                           "--update-baseline"])
        assert e.value.code == 2
    assert json.loads(Path(tpath).read_text()) == tpu


def test_device_cpu_builds_a_report_cold_then_warm(tmp_path, capsys):
    out_json = tmp_path / "r.json"
    md = tmp_path / "r.md"
    assert cli_main.main(["--device", "cpu", "--no-measure", "--json",
                          str(out_json), "--md", str(md)]) == 0
    report = json.loads(out_json.read_text())
    assert report["chip"]["name"] == hwinfo.H100_SXM.name
    fams = {r["family"] for r in report["rows"]}
    assert {"attention", "paged_decode", "stream_triad", "jacobi7",
            "ssd_scan", "sampling"} <= fams
    assert all(r["key"].endswith("-cpu") for r in report["rows"])
    assert not any("wall_s" in r for r in report["rows"])
    assert md.read_text().startswith("# Perf report")
    out = capsys.readouterr().out
    assert "swept" in out and "no baseline" not in out
    # measured, gated against the baseline it writes: the second run
    # resolves every cell from the warm cache and passes its own gate
    base = tmp_path / "b.json"
    assert cli_main.main(["--device", "cpu", "--update-baseline",
                          "--baseline", str(base)]) == 0
    capsys.readouterr()
    registry.clear_tune_table()
    assert cli_main.main(["--device", "cpu", "--baseline", str(base),
                          "--gate", "--wall-floor", "1e9"]) == 0
    out = capsys.readouterr().out
    assert "tune table (warm)" in out and "[gate] ok" in out
    rows = json.loads(base.read_text())["rows"]
    assert any(r.get("wall_s") for r in rows)


def test_resolve_impls_and_impl_context():
    ap = argparse.ArgumentParser()
    cli.add_impl_args(ap, legacy_attn=True)
    assert cli.resolve_impls(ap.parse_args([])) == {}
    args = ap.parse_args(["--impl", "attention=jnp_flash"])
    assert cli.resolve_impls(args) == {"attention": "torch_flash"}
    with pytest.warns(DeprecationWarning):
        got = cli.resolve_impls(ap.parse_args(
            ["--attn-impl", "pallas_flash", "--impl",
             "paged_decode=torch_paged"]))
    assert got == {"attention": "cuda_flash", "paged_decode": "torch_paged"}
    with cli.impl_context(args):
        assert registry.select("attention", sq=16, sk=16, dh=32,
                               backend="cpu") == "torch_flash"
    assert registry.select("attention", sq=16, sk=16, dh=32,
                           backend="cpu") == "full"
