"""The launcher's fault-tolerance flags and the torch stencil case
study, on the CPU.

* ``--straggler-threshold`` / ``--straggler-min-ratio`` and the mesh
  half, ``--ft-timeout-steps`` / ``--ft-confirm``, parse as in the JAX
  launcher (same defaults) and reach ``BatchScheduler``: its straggler
  detector, and the heartbeat governor of a ``ServeMesh`` engine (item
  14a ported them; a threshold below 1 is refused);
* ``examples/case_study_stencil_torch.py`` holds the Jacobi kernel's
  plain version to the oracle and reports the declared Table I traffic at
  a small lattice;
* ``--impl`` pins kernel impls through the registry (the port's names or
  the JAX package's) without moving fp32 tokens, ``--attn-impl`` prints
  the shared deprecation line and expands as the JAX launcher's does, a
  bad spec exits non-zero, and the topology CLI refuses a ``--mesh``
  larger than the devices its pin leaves;
* the serving launcher's ``--mesh 1x1`` serves a world of one through a
  ``ServeMesh`` (heartbeats armed) with the unsharded launch's tokens.
"""

import argparse
import contextlib
import json
import runpy
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch import cli as jax_cli  # noqa: E402
from repro_torch.kernels.jacobi7 import kernel_bytes  # noqa: E402
from repro_torch.launch import cli  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
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
    assert kw == jkw


@pytest.mark.parametrize("flag", ["--ft-timeout-steps", "--ft-confirm"])
def test_mesh_ft_flags_are_refused_with_item_14(flag, capsys):
    """Item 14a ported the mesh's ft flags: once refused citing item 14,
    they now reach the scheduler's kwargs as the JAX launcher's do; only a
    threshold below 1 is refused."""
    ap, args = _parse(cli.add_ft_args, [flag, "5"])
    _, jargs = _parse(jax_cli.add_ft_args, [flag, "5"])
    kw = cli.ft_kwargs(args, ap)
    assert kw == jax_cli.ft_kwargs(jargs)
    assert kw[flag[2:].replace("-", "_")] == 5
    ap, args = _parse(cli.add_ft_args, [flag, "0"])
    with pytest.raises(ValueError, match="at least 1"):
        cli.ft_kwargs(args)
    with pytest.raises(SystemExit):
        cli.ft_kwargs(args, ap)
    assert "at least 1" in capsys.readouterr().err


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
    # the mesh half reaches the scheduler too (item 14a), at the JAX
    # launcher's defaults; a confirm window below 1 is refused
    assert (seen["ft_timeout_steps"], seen["ft_confirm"]) == (3, 2)
    assert json.loads(out.read_text())["requests"] == 2
    with pytest.raises(SystemExit):
        serve_launcher.main(["--arch", "qwen2-0.5b", "--smoke-dims",
                             "--device", "cpu", "--ft-confirm", "0"])


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


def test_serve_batched_example_runs_on_the_host(capsys):
    path = ROOT / "examples" / "serve_batched_torch.py"
    mod = runpy.run_path(str(path))            # defines main, runs nothing
    outs, done = mod["main"](["--device", "cpu"])
    out = capsys.readouterr().out
    assert "pins {'attention': 'torch_flash'}" in out
    assert "would pick 'full' on cpu" in out
    assert [len(o) for o in outs] == [16, 16, 16]
    assert sorted(done) == list(range(10))
    assert all(len(t) == 8 for t in done.values())


# ---------------------------------------------------------------------------
# kernel pins: --impl / --attn-impl, and the tool CLIs' refusals
# ---------------------------------------------------------------------------

def _serve(tmp_path, *extra):
    out = tmp_path / "s.json"
    assert serve_launcher.main([
        "--arch", "qwen2-0.5b", "--smoke-dims", "--device", "cpu",
        "--dtype", "fp32", "--requests", "3", "--max-new", "4",
        "--page-size", "4", "--json", str(out), *extra]) == 0
    return json.loads(out.read_text())


def test_serve_launcher_pins_impls_and_keeps_the_tokens(tmp_path, capsys):
    base = _serve(tmp_path)
    assert base["impls"] == {} and base["dtype"] == "fp32"
    pinned = _serve(tmp_path, "--impl",
                    "attention=torch_flash,paged_decode=torch_paged")
    assert pinned["impls"] == {"attention": "torch_flash",
                               "paged_decode": "torch_paged"}
    assert "[serve] kernel impls pinned:" in capsys.readouterr().out
    assert pinned["tokens"] == base["tokens"]
    assert sorted(pinned["tokens"]) == ["0", "1", "2"]
    # the JAX package's spelling maps onto the port's names
    ref = _serve(tmp_path, "--impl", "attention=pallas_flash")
    assert ref["impls"] == {"attention": "cuda_flash"}
    assert ref["tokens"] == base["tokens"]


def test_serve_launcher_attn_impl_is_deprecated_and_expands(tmp_path,
                                                            capsys):
    with pytest.warns(DeprecationWarning, match="--attn-impl full"):
        got = _serve(tmp_path, "--attn-impl", "full")
    assert "[cli] --attn-impl full is deprecated" in capsys.readouterr().out
    assert got["impls"] == {"attention": "full",
                            "paged_decode": "torch_paged"}


@pytest.mark.parametrize("bad", [["--impl", "attention=bogus"],
                                 ["--impl", "attention"],
                                 ["--impl", "nofamily=full"],
                                 ["--attn-impl", "bogus"]])
def test_serve_launcher_refuses_a_bad_impl_spec(bad, capsys):
    with pytest.raises(SystemExit) as exc:
        serve_launcher.main(["--arch", "qwen2-0.5b", "--smoke-dims",
                             "--device", "cpu", *bad])
    assert exc.value.code not in (0, None)
    assert "error" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--attn-impl", "pallas_flash", "--impl", "ssd_scan=jnp_scan"],
    ["--attn-impl", "paged_decode"],
    ["--attn-impl", "full", "--impl", "paged_decode=jnp_paged"],
    ["--impl", "attention=jnp_flash,paged_decode=pallas_paged"]])
def test_impl_helpers_match_the_jax_launcher(argv):
    """The flags the serving launcher hands to ServeConfig resolve, on the
    port's engine, to the pins the JAX launcher's ``resolve_impls`` gives
    (in the port's names)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import registry
    from repro_torch.models.lm import LM
    _, args = _parse(lambda a: cli.add_impl_args(a, legacy_attn=True),
                     argv)
    _, jargs = _parse(lambda a: jax_cli.add_impl_args(
        a, tune=False, legacy_attn=True), argv)
    assert (args.impl, args.attn_impl) == (jargs.impl, jargs.attn_impl)
    with pytest.warns(DeprecationWarning) if jargs.attn_impl else \
            contextlib.nullcontext():
        theirs = jax_cli.resolve_impls(jargs)
    lm = LM(get_arch("qwen2-0.5b").smoke, torch.float32, "cpu")
    eng = engine.Engine(lm, engine.ServeConfig(
        page_size=4, max_seq=32, attn_impl=args.attn_impl,
        impls=registry.parse_impl_spec(args.impl) if args.impl else None),
        device="cpu")
    assert eng.impl_pins == {f: registry.REFERENCE_NAMES[f][n]
                             for f, n in theirs.items()}
    _, none = _parse(cli.add_impl_args, [])
    assert none.impl is None and not hasattr(none, "attn_impl")


def test_topology_cli_refuses_the_mesh_with_item_14(capsys):
    """``--mesh`` is ported (item 14a); what it still refuses is a mesh
    larger than the devices the pin leaves: one synthetic card holds no
    2x4 mesh."""
    from repro_torch.launch import topology as topo_cli
    with pytest.raises(SystemExit) as exc:
        topo_cli.main(["--device", "cpu", "--mesh", "2x4"])
    assert exc.value.code == 2
    assert "mesh 2x4 needs 8" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        topo_cli.main(["--device", "cpu", "--mesh", "2xx"])
    assert exc.value.code == 2


@pytest.fixture
def left_group():
    """Leave the process group a launcher formed, after the test: later
    tests see no group and no rank device."""
    yield
    mesh_mod.leave_process_group()


def test_serve_launcher_mesh_1x1_serves_a_world_of_one(tmp_path,
                                                       left_group):
    common = ["--arch", "qwen2-0.5b", "--smoke-dims", "--device", "cpu",
              "--dtype", "fp32", "--requests", "3", "--slots", "2",
              "--max-new", "4", "--page-size", "8"]
    plain, mesh = tmp_path / "plain.json", tmp_path / "mesh.json"
    assert serve_launcher.main(common + ["--json", str(plain)]) == 0
    assert serve_launcher.main(common + ["--mesh", "1x1", "--ft-confirm",
                                         "3", "--json", str(mesh)]) == 0
    p, m = json.loads(plain.read_text()), json.loads(mesh.read_text())
    assert m["tokens"] == p["tokens"] and p["mesh"] is None
    assert m["mesh"] == {"device_ids": [0], "world": 1, "remeshes": 0,
                         "facts": {"mesh_shape": [1, 1],
                                   "mesh_axis": "model",
                                   "per_device_heads": 1}}
    with pytest.raises(SystemExit):             # a world of one holds 1
        serve_launcher.main(common + ["--mesh", "1x2"])
