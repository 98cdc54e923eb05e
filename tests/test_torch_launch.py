"""The launcher's single-device fault-tolerance flags and the torch
stencil case study, on the CPU.

* ``--straggler-threshold`` / ``--straggler-min-ratio`` parse as in the
  JAX launcher (same defaults) and reach ``BatchScheduler``'s straggler
  detector; the mesh half (``--ft-timeout-steps``, ``--ft-confirm``) is
  refused with ROADMAP item 14's citation, never ignored;
* ``examples/case_study_stencil_torch.py`` holds the Jacobi kernel's
  plain version to the oracle and reports the declared Table I traffic at
  a small lattice.
"""

import argparse
import json
import runpy
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch import cli as jax_cli  # noqa: E402
from repro_torch.kernels.jacobi7 import kernel_bytes  # noqa: E402
from repro_torch.launch import cli  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _parse(add, argv):
    ap = argparse.ArgumentParser()
    add(ap)
    return ap, ap.parse_args(argv)


@pytest.mark.parametrize("argv", [[], ["--straggler-threshold", "2.5",
                                       "--straggler-min-ratio", "1.2"]])
def test_straggler_flags_match_the_jax_launcher(argv):
    ap, args = _parse(cli.add_ft_args, argv)
    _, jargs = _parse(jax_cli.add_ft_args, argv)
    kw = cli.ft_kwargs(args, ap)
    jkw = jax_cli.ft_kwargs(jargs)
    assert kw == {k: jkw[k] for k in ("straggler_threshold",
                                      "straggler_min_ratio")}


@pytest.mark.parametrize("flag", ["--ft-timeout-steps", "--ft-confirm"])
def test_mesh_ft_flags_are_refused_with_item_14(flag, capsys):
    ap, args = _parse(cli.add_ft_args, [flag, "3"])
    with pytest.raises(NotImplementedError, match="item 14"):
        cli.ft_kwargs(args)
    with pytest.raises(SystemExit):
        cli.ft_kwargs(args, ap)
    assert "item 14" in capsys.readouterr().err


def test_serve_launcher_wires_the_straggler_flags(tmp_path, monkeypatch):
    seen = {}
    real = engine.BatchScheduler.__init__

    def spy(self, eng, **kw):
        seen.update(kw)
        real(self, eng, **kw)

    monkeypatch.setattr(engine.BatchScheduler, "__init__", spy)
    out = tmp_path / "s.json"
    assert serve_launcher.main([
        "--arch", "qwen2-0.5b", "--smoke-dims", "--device", "cpu",
        "--requests", "2", "--max-new", "3", "--straggler-threshold", "2.5",
        "--straggler-min-ratio", "1.25", "--json", str(out)]) == 0
    assert seen["straggler_threshold"] == 2.5
    assert seen["straggler_min_ratio"] == 1.25
    assert json.loads(out.read_text())["requests"] == 2
    with pytest.raises(SystemExit):
        serve_launcher.main(["--arch", "qwen2-0.5b", "--smoke-dims",
                             "--device", "cpu", "--ft-confirm", "2"])


def test_stencil_case_study_runs_on_the_host(capsys):
    path = ROOT / "examples" / "case_study_stencil_torch.py"
    mod = runpy.run_path(str(path))            # defines main, runs nothing
    res = mod["main"](["--device", "cpu", "--shape", "16,18,40"])
    out = capsys.readouterr().out
    assert "allclose OK" in out and "REFUSED" in out
    assert res["shape"] == (16, 18, 40)
    tile = (128, 32, 64)
    naive = sum(kernel_bytes((16 - 2 * s, 18 - 2 * s, 40 - 2 * s), 1, tile)
                for s in range(4))
    assert res["threaded_bytes"] == naive
    assert res["wavefront_bytes"] == kernel_bytes((16, 18, 40), 4, tile)
    assert res["wavefront_bytes"] < res["threaded_bytes"]
