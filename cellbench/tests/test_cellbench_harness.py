"""The harness as a whole, on the CPU: a cell, configuration, mix, limits
and metric added from new files alone are found and run; no module it
runs loads JAX or the package the port was made from; every fault the
cells can have, and the float8 control, come out as not correct; and
the real cell on the card (marked ``card``)."""

import ast
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from cellbench import bench
from cellbench.bench import Cell, forbidden_modules
from cellbench.run import run_cell

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CPU = torch.device("cpu")


def _quiet(msg):
    pass


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "cellbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_mix_and_metric_from_new_files_only(tiny_root):
    before = _digests(ROOT)
    new = {k: v for k, v in _digests(tiny_root).items()}
    # the tiny cells changed no file the benchmark had: each is new
    for rel, digest in before.items():
        if rel.parts[1] != "tests":
            assert new[rel] == digest, rel
    metric = tiny_root / "cellbench" / "metrics" / "tiny.steps_seen.py"
    metric.write_text('"""Steps the window ran."""\n\n\n'
                      'def read(ctx):\n'
                      '    return float(ctx["steps"]) if ctx["kind"] == '
                      '"train" else None\n')
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["per_layer"].append(dict(
        name="tiny.steps_seen", unit="steps", better="higher",
        source="program_counter", layer="trainer",
        moves="train_tokens_per_s", workloads=["tiny-dense.train.tiny"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = Cell("tiny-dense.train.tiny", tiny_root)
    res = run_cell(cell, 2**31 + 101, 0.5, True, CPU, time.perf_counter(),
                   _quiet)
    assert res["metrics"]["tiny.steps_seen"]["value"] >= 1
    assert res["correct"], res["compared"]
    res0 = run_cell(cell, 2**31 + 101, 0.5, False, CPU, time.perf_counter(),
                    _quiet)
    assert set(res0["metrics"]) == {"setup_s", "train_tokens_per_s"}


#: a kind of traffic this benchmark does not have, as a new kind file:
#: a seeded product timed in a window and checked against float64
NEW_KIND = '''"""A seeded matrix product, timed and checked."""

import time

import torch

from cellbench.bench import device_info, reset_peak


def run(cell, seed, seconds, traced, device, t_start, log):
    n = int(cell.traffic["n"])
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(n, n, generator=gen, device=device)
    reset_peak(device)
    done, t_open = 0, time.perf_counter()
    while True:
        c = a @ a
        done += 1
        if time.perf_counter() - t_open >= seconds:
            break
    window_s = time.perf_counter() - t_open
    return dict(e2e={"setup_s": t_open - t_start,
                     "products_per_s": done / window_s},
                ctx=dict(kind="tiny_matmul", steps=done, window_s=window_s),
                device=device_info(device, cell.chips), attempted=done,
                failed=0, a=a, c=c)


def check(cell, seed, out, device, log):
    ref = out["a"].double() @ out["a"].double()
    gap = (out["c"].double() - ref).abs().max() / ref.abs().max()
    return {"product_gap": float(gap)}
'''


def test_a_new_kind_of_traffic_from_new_files_only(tiny_root):
    before = _digests(tiny_root)
    cb = tiny_root / "cellbench"
    (cb / "kinds" / "tiny_matmul.py").write_text(NEW_KIND)
    (cb / "traffic" / "matmul.tiny.json").write_text(
        json.dumps({"kind": "tiny_matmul", "n": 48}))
    (cb / "limits" / "tiny-dense.matmul.tiny.json").write_text(
        json.dumps({"limits": {"product_gap": {"limit": 1e-5}}}))
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["workloads"].append(dict(name="tiny-dense.matmul.tiny",
                               config="tiny-dense", traffic="matmul.tiny",
                               chips=1, why="a tiny test cell"))
    b["end_to_end"].append(dict(name="products_per_s", unit="1/s",
                                better="higher", bound=0.25,
                                source="host_clock",
                                workloads=["tiny-dense.matmul.tiny"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    after = _digests(tiny_root)
    assert all(after[rel] == d for rel, d in before.items())
    cell = Cell("tiny-dense.matmul.tiny", tiny_root)
    res = run_cell(cell, 2**33 + 3, 0.2, False, CPU, time.perf_counter(),
                   _quiet)
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {"setup_s", "products_per_s"}


def test_a_new_family_from_new_files_only(tiny_root):
    # the dense family again under a new name: its own file, found by the
    # configuration's ``family``
    before = _digests(tiny_root)
    cb = tiny_root / "cellbench"
    src = (cb / "reference" / "dense.py").read_text()
    (cb / "reference" / "dense_again.py").write_text(
        src + "\n\n_lm_kwargs = lm_kwargs\n\n\n"
        "def lm_kwargs(cfg, base):\n"
        "    return dict(_lm_kwargs(cfg, base), family=\"dense\")\n")
    cfg = json.loads((cb / "configs" / "tiny-dense.json").read_text())
    cfg["family"] = "dense_again"
    (cb / "configs" / "tiny-again.json").write_text(json.dumps(cfg))
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(name="tiny-again",
                             source="https://example.org/tiny",
                             file="cellbench/configs/tiny-again.json",
                             reduced=[], why="a tiny test configuration"))
    b["workloads"].append(dict(name="tiny-again.train.tiny",
                               config="tiny-again", traffic="train.tiny",
                               chips=1, why="a tiny test cell"))
    for m in b["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny-again.train.tiny")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    (cb / "limits" / "tiny-again.train.tiny.json").write_text(
        (cb / "limits" / "tiny-dense.train.tiny.json").read_text())
    after = _digests(tiny_root)
    assert all(after[rel] == d for rel, d in before.items())
    cell = Cell("tiny-again.train.tiny", tiny_root)
    assert bench.family(cell.cfg).__file__.endswith("dense_again.py")
    res = run_cell(cell, 2**31 + 5, 0.3, False, CPU, time.perf_counter(),
                   _quiet)
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {"setup_s", "train_tokens_per_s"}


@pytest.mark.parametrize("name", ["tiny-moe.serve.tiny",
                                  "tiny-dense.serve.tiny-reask"])
def test_a_tiny_serving_cell_runs_and_is_correct(tiny_root, name):
    cell = Cell(name, tiny_root)
    res = run_cell(cell, 2**32 + 7, 1.0, False, CPU, time.perf_counter(),
                   _quiet)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "serve_tokens_per_s",
                                   "ttft_p95_ms"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_x", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert forbidden_modules() == ["repro.models"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_original():
    for path in HERE.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in bench.FORBIDDEN, (path, mod)


def test_the_yardstick_imports_nothing_of_the_program():
    yardstick = [HERE / "weights.py", HERE / "traffic.py",
                 HERE / "flops.py", HERE / "bench.py",
                 *(HERE / "reference").glob("*.py"),
                 *(HERE / "metrics").glob("*.py")]
    for path in yardstick:
        for mod in _imports(path):
            assert mod.split(".")[0] != "repro_torch", (path, mod)


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import sys, time, torch; from pathlib import Path\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from cellbench.bench import Cell, forbidden_modules\n"
        "from cellbench.run import run_cell\n"
        f"root = Path({str(tiny_root)!r})\n"
        "for name in ('tiny-dense.train.tiny', 'tiny-moe.serve.tiny'):\n"
        "    run_cell(Cell(name, root), 3, 0.3, True, torch.device('cpu'),\n"
        "             time.perf_counter(), lambda m: None)\n"
        "print('FORBIDDEN', forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_without_a_card_the_run_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "cellbench.run", "--workload",
         "qwen2-0.5b.train.seq2048", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_in_a_directory_of_the_benchmark_alone_the_run_fails(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-m", "cellbench.run", "--workload",
         "qwen2-0.5b.train.seq2048", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# ------------------------------------------------------------ the faults

def _train_fault(monkeypatch, wrap):
    import repro_torch.train.step as step_mod
    real = step_mod.make_train_step

    def make(*a, **kw):
        return wrap(real(*a, **kw))
    monkeypatch.setattr(step_mod, "make_train_step", make)


def test_a_step_that_returns_its_state_unchanged_is_not_correct(
        tiny_root, monkeypatch):
    def frozen(step):
        def run(st, batch):
            # the step runs, and the state handed back is as it was given
            keep = [{k: v.detach().clone() for k, v in t.items()}
                    for t in (st.params, st.opt.m, st.opt.v)]
            steps = (st.opt.step.clone(), st.step.clone())
            metrics = step(st, batch)[1]
            with torch.no_grad():
                for t, saved in zip((st.params, st.opt.m, st.opt.v), keep):
                    for k, v in saved.items():
                        t[k].copy_(v)
                st.opt.step.copy_(steps[0])
                st.step.copy_(steps[1])
            return st, metrics
        return run
    _train_fault(monkeypatch, frozen)
    cell = Cell("tiny-dense.train.tiny", tiny_root)
    res = run_cell(cell, 41, 0.3, False, CPU, time.perf_counter(), _quiet)
    assert not res["correct"]
    assert res["compared"]["grad_leaf"]["value"] > 0.5


def test_half_the_batch_left_out_is_not_correct(tiny_root, monkeypatch):
    def half(step):
        def run(st, batch):
            n = batch["tokens"].shape[0] // 2
            return step(st, {k: v[:n] for k, v in batch.items()})
        return run
    _train_fault(monkeypatch, half)
    cell = Cell("tiny-dense.train.tiny", tiny_root)
    res = run_cell(cell, 41, 0.3, False, CPU, time.perf_counter(), _quiet)
    assert not res["correct"]
    assert res["compared"]["grad_norm_rel"]["value"] > 0.05


@pytest.mark.parametrize("name", ["tiny-moe.serve.tiny",
                                  "tiny-dense.serve.tiny-reask"])
def test_a_token_altered_where_it_is_produced_is_not_correct(
        tiny_root, monkeypatch, name):
    from repro_torch.serve.engine import Engine
    real = Engine.decode_segment

    def altered(self, state, logits, steps, generator=None):
        toks, lg, st = real(self, state, logits, steps, generator)
        toks = toks.clone()
        toks[:, ::2] = (toks[:, ::2] + 1) % self.lm.cfg.vocab
        return toks, lg, st
    monkeypatch.setattr(Engine, "decode_segment", altered)
    cell = Cell(name, tiny_root)
    res = run_cell(cell, 43, 1.0, False, CPU, time.perf_counter(), _quiet)
    assert not res["correct"]


def test_the_float8_control_is_not_correct(tiny_root):
    # the reference in float8 put in the program's place, against the
    # tiny training cell's limits: it fails one of them where the
    # program, on the same seed, passes every one
    cell = Cell("tiny-dense.train.tiny", tiny_root)
    r = cell.kind.readings(cell, 11, 0.3, CPU)
    passes = {k: r["program"][k] <= lim for k, lim in cell.limits.items()}
    assert all(passes.values()), r["program"]
    for control in ("control_fp8_gemm", "control_fp8"):
        fails = {k: r[control][k] > lim for k, lim in cell.limits.items()}
        assert any(fails.values()), (control, r[control])
    assert r["half_batch"]["grad_norm_rel"] > cell.limits["grad_norm_rel"]


@pytest.mark.card
def test_the_cell_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "cellbench.run", "--workload",
         "qwen2-0.5b.train.seq2048", "--seed", "2024", "--seconds", "5"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu"
