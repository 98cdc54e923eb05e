"""The benchmark's own tests: ``python -m pytest cellbench/tests`` from the
root of the repository.  On the CPU they drive whole runs of tiny cells
(configurations, mixes and limits written into a copy of the benchmark
under ``tmp_path``); tests marked ``card`` run a real cell and skip
without a CUDA device."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: tiny cells: a configuration, a mix and limits each, added as files
TINY_CONFIGS = {
    "tiny-dense": dict(base="qwen2-0.5b", hidden_size=56,
                       num_attention_heads=7, num_key_value_heads=1,
                       num_hidden_layers=2, vocab_size=256,
                       intermediate_size=128),
    "tiny-moe": dict(base="qwen2-moe-a2.7b", hidden_size=64,
                     num_attention_heads=4, num_key_value_heads=2,
                     num_hidden_layers=2, vocab_size=256, num_experts=8,
                     num_experts_per_tok=2, moe_intermediate_size=32,
                     shared_expert_intermediate_size=64,
                     intermediate_size=128),
}
TINY_MIXES = {
    "serve.tiny": dict(base="serve.docqa", clients=3, slots=3, max_seq=160,
                       page_size=8, pool=8, check_requests=4,
                       document={"dist": "loguniform", "min": 16, "max": 96},
                       output={"dist": "uniform", "min": 4, "max": 12}),
    "serve.tiny-reask": dict(base="serve.longdoc-reask", clients=3, slots=3,
                             max_seq=200, page_size=8, pool=8,
                             check_requests=4,
                             document={"dist": "loguniform", "min": 32,
                                       "max": 96},
                             question={"dist": "uniform", "min": 4,
                                       "max": 16},
                             output={"dist": "uniform", "min": 4,
                                     "max": 12}),
    "train.tiny": dict(base="train.seq2048", batch=4, seq=32),
}
#: (cell, config, mix, limits): the limits are tiny-size ones, set from the
#: readings of these cells on the CPU
TINY_CELLS = [
    ("tiny-moe.serve.tiny", "tiny-moe", "serve.tiny",
     {"prefill_gap": 0.02, "served_gap": 0.05}),
    ("tiny-dense.serve.tiny-reask", "tiny-dense", "serve.tiny-reask",
     {"served_gap": 0.05}),
    ("tiny-dense.train.tiny", "tiny-dense", "train.tiny",
     {"grad_norm_rel": 0.05, "grad_leaf": 0.03, "change_leaf": 0.1,
      "grad_diff": 0.04}),
]


#: the serving metrics a serving cell reports (the files under
#: ``cellbench/metrics`` read the per-layer ones), as ``BENCHMARK.json``
#: entries a benchmark that enters a serving cell carries
SERVE_E2E = [("serve_tokens_per_s", "tokens/s", "higher"),
             ("ttft_p95_ms", "ms", "lower")]
SERVE_LAYER = [
    ("scheduler.host_share", "%", "lower", "program_span", "scheduler",
     "serve_tokens_per_s"),
    ("scheduler.prefix_hit_share", "%", "higher", "program_counter",
     "scheduler", "ttft_p95_ms"),
    ("engine.decode_step_ms", "ms", "lower", "program_span", "engine",
     "serve_tokens_per_s"),
    ("engine.prefill_ms_per_ktok", "ms", "lower", "program_span", "engine",
     "ttft_p95_ms"),
    ("model.mfu.serve", "%", "higher", "program_counter", "model",
     "serve_tokens_per_s"),
    ("flash_attention_roofline", "%", "higher", "device_trace", "kernels",
     "serve_tokens_per_s"),
    ("paged_decode_roofline", "%", "higher", "device_trace", "kernels",
     "serve_tokens_per_s"),
    ("device.idle.serve", "%", "lower", "device_trace", "device",
     "serve_tokens_per_s"),
]


def add_tiny_cells(root: Path) -> None:
    """Write the tiny cells' files into the benchmark at ``root`` and add
    their entries to its ``BENCHMARK.json``: new files and new entries
    only."""
    cb = root / "cellbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, kw in TINY_CONFIGS.items():
        kw = dict(kw)
        cfg = json.loads((cb / "configs" / f"{kw.pop('base')}.json")
                         .read_text())
        cfg.update(kw)
        (cb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append(dict(
            name=name, source="https://example.org/tiny",
            file=f"cellbench/configs/{name}.json", reduced=sorted(kw),
            why="a tiny test configuration"))
    for name, kw in TINY_MIXES.items():
        kw = dict(kw)
        mix = json.loads((cb / "traffic" / f"{kw.pop('base')}.json")
                         .read_text())
        mix.update(kw)
        (cb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    names = []
    for cell, cfg, mix, limits in TINY_CELLS:
        bench["workloads"].append(dict(name=cell, config=cfg, traffic=mix,
                                       chips=1, why="a tiny test cell"))
        (cb / "limits" / f"{cell}.json").write_text(json.dumps(
            {"limits": {k: {"limit": v} for k, v in limits.items()}}))
        names.append(cell)
    serving = [c for c, _, mix, _ in TINY_CELLS if mix.startswith("serve")]
    have = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name, unit, better in SERVE_E2E:
        if name not in have:
            bench["end_to_end"].append(dict(
                name=name, unit=unit, better=better, bound=0.25,
                source="host_clock", workloads=[]))
    for name, unit, better, source, layer, moves in SERVE_LAYER:
        if name not in have:
            bench["per_layer"].append(dict(
                name=name, unit=unit, better=better, source=source,
                layer=layer, moves=moves, workloads=[]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = ("serve" if m["name"] in dict(
                [(e[0], 0) for e in SERVE_E2E + SERVE_LAYER]) else "train")
            m["workloads"] = m["workloads"] + [
                c for c in names if (c in serving) == (kind == "serve")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and ``cellbench/``)
    with the tiny cells added."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "cellbench", root / "cellbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    add_tiny_cells(root)
    return root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (an H100); skips without one")
