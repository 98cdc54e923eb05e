"""What a run reads from ``BENCHMARK.json`` and the files it names, and
the result line it prints.

Everything that belongs to one cell is found by name: the configuration
``configs/<config>.json``, the mix ``traffic/<traffic>.json``, the
correctness limits ``limits/<cell>.json`` and each per-layer metric's
reader ``metrics/<name>.py``, which exports ``read(ctx)`` returning the
value or None.  Code is found by name too: the mix's ``kind`` names the
module ``kinds/<kind>.py`` (its loop, window and check), and the
configuration's ``family`` names ``reference/<family>.py`` (the family's
leaves, plain forward and sizes as the port names them).  A later cell,
configuration, mix, metric, kind of traffic or family is new files and
new entries, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["ROOT", "HERE", "Cell", "metric_reader", "plugin", "family",
           "p95", "forbidden_modules", "result_line",
           "FORBIDDEN", "sync", "reset_peak", "device_info"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names no run may hold: JAX and the package the port
#: was made from (``repro``; ``repro_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell:
    """One entry of ``workloads`` with everything it names, read from
    ``root`` (the checkout, or a directory a test builds)."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"cells: {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.cfg = json.loads(
            (self.root / self.config_entry["file"]).read_text())
        self.cfg.setdefault("name", self.entry["config"])
        # where the configuration's family is found (see :func:`family`)
        self.cfg["_root"] = str(self.root)
        from cellbench import traffic
        self.traffic = traffic.load(
            self.root / "cellbench" / "traffic" / f"{self.entry['traffic']}.json")
        self.kind = plugin(self.root, "kinds", self.traffic["kind"])
        lim = self.root / "cellbench" / "limits" / f"{name}.json"
        self.limits: Dict[str, float] = (
            {k: float(v["limit"]) for k, v in
             json.loads(lim.read_text())["limits"].items()}
            if lim.exists() else {})

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    @property
    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    @property
    def per_layer(self) -> List[dict]:
        return [m for m in self.bench["per_layer"] if self._applies(m)]


def plugin(root: Path, folder: str, name: str):
    """The module ``cellbench/<folder>/<name>.py`` under ``root``, loaded
    from its file once."""
    path = (Path(root) / "cellbench" / folder / f"{name}.py").resolve()
    if not path.is_file():
        raise KeyError(f"no {folder} file {path}")
    key = f"cellbench_{folder}:{path}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def metric_reader(root: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return plugin(root, "metrics", name).read


def family(cfg: dict):
    """The module of the configuration's family, ``reference/<family>.py``
    of the benchmark the configuration was read from."""
    return plugin(Path(cfg.get("_root", ROOT)), "reference", cfg["family"])


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of every value (linear between order
    statistics, numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = 0.95 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Any], device: Dict[str, Any],
                compared: Dict[str, Dict[str, float]],
                breakdown: Optional[dict] = None) -> str:
    """The last line of standard output: the contract's keys, then the
    numbers compared with their limits under a key of their own, last."""
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return json.dumps(out)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def device_info(device, count: int) -> Dict[str, Any]:
    """The result line's ``device``: the card's name and the peak memory
    allocated since the last :func:`reset_peak` (a CPU run, in tests, says
    ``cpu``)."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
