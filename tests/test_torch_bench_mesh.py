"""``python -m repro_torch.bench.bench_mesh`` on five spawned gloo ranks,
twice, as ``tests/test_mesh_serve.py`` runs the JAX bench: token parity
across (1, 2) and (1, 4), a killed rank degrading onto the hot spare with
parity intact, and the second (fresh) process reading every per-sharding
tune record back with 0 sweeps and 0 timed probes."""

import json
import os
import subprocess
import sys

import pytest
torch = pytest.importorskip("torch")

torch.set_num_threads(1)


def test_bench_mesh_cold_then_warm(tmp_path):
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = (os.path.join(root, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env["REPRO_CACHE_DIR"] = str(tmp_path / "cache")

    def run(tag):
        out = tmp_path / f"BENCH_mesh.{tag}.json"
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.bench.bench_mesh",
             "--device", "cpu", "--ranks", "5", "--smoke", "--timeout",
             "200", "--json", str(out)],
            capture_output=True, text=True, env=env, cwd=root, timeout=240)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        with open(out) as fh:
            return json.load(fh)

    first = run("cold")
    assert first["ranks"] == 5 and first["parity"] is True
    assert [s["shape"] for s in first["shapes"]] == [[1, 2], [1, 4]]
    assert [s["per_device_heads"] for s in first["shapes"]] == [2, 1]
    assert all(rec["swept"] for rec in first["tune"])
    deg = first["degradation"]
    assert deg["remeshes"] == 1 and deg["token_parity_after"] is True
    ev = [e for e in deg["events"] if e["type"] == "remesh"][0]
    assert ev["remesh_latency_s"] > 0
    assert deg["killed"] not in ev["device_ids"]

    second = run("warm")
    assert second["parity"] is True
    assert second["tune"], "per-sharding tune records missing"
    for rec in second["tune"]:
        assert rec["swept"] is False and rec["timed_probes"] == 0, rec
    # distinct shardings persisted under distinct keys, each tagged
    keys = [rec["key"] for rec in second["tune"]]
    assert len(set(keys)) == len(keys) == 2
    assert keys[0].endswith("-mesh1x2.model.pdh2")
    assert keys[1].endswith("-mesh1x4.model.pdh1")
