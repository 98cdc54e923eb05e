"""Collection without PyTorch: the JAX package's tests must still run.

CI installs the package's ``test`` extra, which has no torch.  Every
``tests/test_torch_*.py`` module therefore takes torch through
``pytest.importorskip`` before any torch or ``repro_torch`` import, so
with torch missing those modules skip and the rest of the suite is
collected.  This test (which imports no torch itself) blocks torch with a
``sitecustomize`` on a temporary path and collects the suite in a
subprocess, as CI's test job does.
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BLOCK_TORCH = '''\
import importlib.abc
import sys


class _NoTorch(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "torch" or name.startswith("torch."):
            raise ImportError(f"No module named {name!r} (blocked)")
        return None


sys.meta_path.insert(0, _NoTorch())
'''


def test_suite_collects_without_torch(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(BLOCK_TORCH)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "PYTHONPATH"))}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(ROOT / "src")])
    env["JAX_PLATFORMS"] = "cpu"
    probe = subprocess.run([sys.executable, "-c", "import torch"], env=env,
                           capture_output=True, text=True, timeout=120)
    assert probe.returncode != 0, "the sitecustomize did not block torch"
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-m", "not slow", "-p", "no:cacheprovider", "tests"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "error" not in out.splitlines()[-1].lower(), out[-4000:]
    collected = [line for line in res.stdout.splitlines() if "::" in line]
    assert any(line.startswith("tests/test_kernels.py::")
               for line in collected), out[-4000:]
    assert any(line.startswith("tests/test_serve_decode.py::")
               for line in collected), out[-4000:]
    # the port's modules skipped at import, none was collected
    assert not any(line.startswith("tests/test_torch_")
                   and not line.startswith("tests/test_torch_collect.py")
                   for line in collected), out[-4000:]
