"""likwid-topology on the port (``repro_torch.core.topology``) against the
JAX package's ``repro.core.topology``, on the CPU.

Both packages' ``synthesize`` of both production specs give the same
chips; ``ici_hops`` and ``same_host`` agree on a seeded sample of pairs;
``probe`` synthesizes on the CPU as the reference's does on host devices;
the renderers hold the same device rows and grid.  The port's own parts:
the GPU memory table, the probe of a CUDA device (on the card), and the
CLI (``--json``, ``--production``, ``--mesh``'s axis -> link map
against the JAX package's, and a mesh too large refused).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import topology as jax_topo  # noqa: E402
from repro_torch.core import hwinfo  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.launch import topology as topo_cli  # noqa: E402

torch.set_num_threads(1)

SPECS = {"single": (topology.PRODUCTION_SINGLE_POD,
                    jax_topo.PRODUCTION_SINGLE_POD),
         "multi": (topology.PRODUCTION_MULTI_POD,
                   jax_topo.PRODUCTION_MULTI_POD)}


def _chip_rows(topo):
    """Each chip's placement, without the per-chip core count (TensorCores
    there, SMs here)."""
    return [(c.device_id, c.pod, c.host, tuple(c.coords)) for c in topo.chips]


@pytest.mark.parametrize("name", SPECS)
def test_synthesize_gives_the_reference_chips(name):
    ours, theirs = (topology.synthesize(SPECS[name][0]),
                    jax_topo.synthesize(SPECS[name][1]))
    assert _chip_rows(ours) == _chip_rows(theirs)
    for attr in ("pod_grid", "num_pods", "chips_per_host", "synthetic",
                 "total_chips", "chips_per_pod", "num_hosts"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert {c.core_count for c in ours.chips} == {hwinfo.H100_SXM.sm_count}
    assert ours.chip_spec is hwinfo.H100_SXM
    for c, jc in zip(ours.chips[:40], theirs.chips[:40]):
        assert c.ici_neighbors(ours.pod_grid) == \
            jc.ici_neighbors(theirs.pod_grid)


@pytest.mark.parametrize("name", SPECS)
def test_hops_and_hosts_agree_on_a_seeded_sample(name):
    ours, theirs = (topology.synthesize(SPECS[name][0]),
                    jax_topo.synthesize(SPECS[name][1]))
    rng = np.random.default_rng(11)
    n = ours.total_chips
    pairs = rng.integers(0, n, size=(400, 2))
    for a, b in pairs.tolist():
        assert ours.ici_hops(a, b) == theirs.ici_hops(a, b), (a, b)
        assert ours.same_host(a, b) == theirs.same_host(a, b), (a, b)
    if name == "multi":
        assert ours.ici_hops(0, 256) == -1


@pytest.mark.parametrize("n_devices", [1, 4, 6, 16])
def test_probe_on_the_cpu_synthesizes_like_the_reference(n_devices):
    class HostDevice:                   # a jax CPU device's metadata
        device_kind = "cpu"

    theirs = jax_topo.probe([HostDevice()] * n_devices)
    spec = topology.TopoSpec(num_pods=1,
                             pod_grid=jax_topo._grid_for_count(n_devices),
                             chips_per_host=min(4, n_devices))
    ours = topology.probe("cpu", spec=spec)
    assert ours.synthetic and theirs.synthetic
    assert _chip_rows(ours) == _chip_rows(theirs)
    assert ours.pod_grid == theirs.pod_grid
    # with no spec: one synthetic card
    one = topology.probe("cpu")
    assert one.synthetic and one.total_chips == 1
    assert "[synthetic probe]" in one.summary_table()


def test_renderers_hold_the_reference_rows():
    ours = topology.synthesize(topology.PRODUCTION_MULTI_POD)
    theirs = jax_topo.synthesize(jax_topo.PRODUCTION_MULTI_POD)

    def device_rows(text):
        rows = []
        for line in text.splitlines():
            parts = line.split()
            if parts and parts[0].isdigit():
                rows.append(" ".join(parts[:-1]))    # drop the core column
        return rows

    assert device_rows(ours.summary_table()) == \
        device_rows(theirs.summary_table())
    assert "(504 more GPUs)" in ours.summary_table()

    def grid_rows(text):
        return [line for line in text.splitlines() if "HBM" not in line]

    assert grid_rows(ours.ascii_art()) == grid_rows(theirs.ascii_art())
    mem = ours.memory_table()
    for level in ("HBM", "L2", "SMEM", "REG"):
        assert any(line.startswith(level) for line in mem.splitlines())
    assert "50 MiB" in mem and "228 KiB" in mem and "256 KiB" in mem
    assert "989 TFLOP/s" in mem and "NVLink" in mem
    full = ours.render(graphical=True)
    assert "Pod 1" in full and "Memory Hierarchy" in full


def test_summary_lists_data_sheet_disagreements():
    topo = topology.NodeTopology(
        chip_spec=hwinfo.H100_SXM,
        chips=(topology.Chip(0, 0, 0, (0, 0, 0), 114),),
        pod_grid=(1, 1, 1), num_pods=1, chips_per_host=1, synthetic=False,
        check_device=("device 0: SMs: device 114, data sheet 132",))
    text = topo.summary_table()
    assert "[synthetic probe]" not in text
    assert "device 0: SMs: device 114, data sheet 132" in text


def test_probe_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        topology.probe()


def test_topology_cli_json_and_the_mesh_refusal(tmp_path, capsys):
    out = tmp_path / "t.json"
    assert topo_cli.main(["--device", "cpu", "-g", "--json",
                          str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["chips"] == 1 and got["synthetic"] is True
    assert got["sm_count"] == [132] and got["check_device"] == []
    assert topo_cli.main(["--production", "--multi-pod", "--pin", "ring",
                          "--skip", "0-1", "--json", str(out)]) == 0
    got = json.loads(out.read_text())
    assert (got["chips"], got["pods"], got["hosts"]) == (512, 2, 128)
    assert got["pin"]["strategy"] == "ring"
    assert got["pin"]["skipped"] == [0, 1]
    assert len(got["pin"]["device_ids"]) == 510
    assert "pin[ring] 510 devices" in capsys.readouterr().out
    # --mesh (item 14a): the axis -> link map of the JAX CLI, and a mesh
    # larger than the pin's devices refused
    from repro.core import pin as jax_pin
    from repro.launch import mesh as jax_mesh
    assert topo_cli.main(["--production", "--mesh", "16x16", "--pin",
                          "ring", "--skip", "", "--json", str(out)]) == 0
    got = json.loads(out.read_text())["mesh"]
    jtopo = jax_topo.probe(spec=jax_topo.PRODUCTION_SINGLE_POD)
    ids = jax_pin.get_strategy("ring")(jtopo).device_ids
    assert got["device_ids"] == list(ids)
    assert got["axis_ici_map"] == jax_mesh.axis_ici_map(
        jtopo, ids, (16, 16), ("data", "model"))
    assert "axis model  size  16  ring" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        topo_cli.main(["--device", "cpu", "--mesh", "2x2"])
    assert "mesh 2x2 needs 4" in capsys.readouterr().err
