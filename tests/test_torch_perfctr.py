"""The port's tool layer (``repro_torch.core``) against the JAX package's.

Groups, the roofline, region accumulation and the bandwidth-map rendering
are pure functions of counts, a data sheet and times, so they are held to
the JAX modules exactly on the same inputs.  The JAX side gets a
``dataclasses.replace`` of its default chip that carries the port's H100
numbers (the ICI links stand in for NVLink: 18 x 50 GB/s).  Then the
port's own parts: declared events collected by ``measure`` and
``region_timer`` on the CPU, the data-sheet lookup, and the four case-study
benches end to end at their smoke size on the CPU.
"""

import dataclasses
import json
import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import bandwidth as jax_bandwidth
from repro.core import groups as jax_groups
from repro.core import hwinfo as jax_hwinfo
from repro.core import perfctr as jax_perfctr
from repro.core import roofline as jax_roofline
from repro.core.events import EventCounts as JaxEventCounts
from repro_torch.bench import (bench_bandwidth_map, bench_jacobi_traffic,
                               bench_stencil_pinning, bench_stream_pinning)
from repro_torch.core import bandwidth, groups, hwinfo, marker, perfctr, \
    roofline
from repro_torch.core.events import EventCounts, collect
from repro_torch.kernels.jacobi7 import jacobi7_wavefront, kernel_bytes
from repro_torch.kernels.stream_triad import stream_triad, triad_bytes

torch.set_num_threads(1)

H100 = hwinfo.H100_SXM


def _jax_chip(peak=H100.peak_bf16_flops):
    return dataclasses.replace(
        jax_hwinfo.DEFAULT_CHIP, peak_bf16_flops=peak,
        peak_f32_flops=H100.peak_f32_flops, peak_int8_ops=H100.peak_int8_ops,
        hbm_bytes=H100.hbm_bytes, hbm_bw=H100.hbm_bw,
        ici_links=H100.nvlink_links,
        ici_bw_per_link=H100.nvlink_bw_per_link)


def _counts(seed, *, ici=True):
    rng = np.random.default_rng(seed)
    c = {e: float(rng.integers(1, 10**9)) for e in (
        "FLOPS_TOTAL", "TRANSCENDENTALS", "BYTES_ACCESSED", "HBM_ARG_BYTES",
        "HBM_OUT_BYTES", "HBM_TEMP_BYTES", "HBM_PEAK_BYTES", "DOT_COUNT",
        "FUSION_COUNT", "REMAT_DUP_OPS", "HLO_LINES")}
    for k in ("AG", "AR", "RS", "A2A", "CP"):
        c[f"ICI_{k}_BYTES"] = float(rng.integers(0, 10**8)) if ici else 0.0
        c[f"ICI_{k}_COUNT"] = float(rng.integers(0, 50)) if ici else 0.0
    c["ICI_TOTAL_BYTES"] = sum(c[f"ICI_{k}_BYTES"]
                               for k in ("AG", "AR", "RS", "A2A", "CP"))
    c["ICI_ASYNC_COUNT"] = float(rng.integers(0, 10)) if ici else 0.0
    return c


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if math.isnan(b[k]):
            assert math.isnan(a[k]), k
        else:
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=0.0), k


# ---------------------------------------------------------------------------
# groups and roofline
# ---------------------------------------------------------------------------

def test_the_catalogue_is_the_references():
    assert list(groups.GROUPS) == list(jax_groups.GROUPS)
    for name, g in groups.GROUPS.items():
        jg = jax_groups.GROUPS[name]
        assert [m.name for m in g.metrics] == [m.name for m in jg.metrics]
        assert [m.unit for m in g.metrics] == [m.unit for m in jg.metrics]
        assert set(jg.events) <= set(g.events)


@pytest.mark.parametrize("name", sorted(jax_groups.GROUPS))
@pytest.mark.parametrize("time_s", [None, 1.7e-3])
@pytest.mark.parametrize("seed,ici", [(0, True), (1, False)])
def test_group_derive_equals_reference(name, time_s, seed, ici):
    c = _counts(seed, ici=ici)
    got = groups.get_group(name).derive(EventCounts(dict(c)), H100, time_s)
    want = jax_groups.get_group(name).derive(JaxEventCounts(dict(c)),
                                             _jax_chip(), time_s)
    _same(got, want)


@pytest.mark.parametrize("name", ["FLOPS_BF16", "ROOFLINE"])
def test_fp32_flops_take_the_fp32_peak(name):
    # all FLOPs on fp32 CUDA cores: the reference with its bf16 peak set
    # to the fp32 one gives the same numbers
    c = _counts(2, ici=False)
    c["FLOPS_F32"] = c["FLOPS_TOTAL"]
    got = groups.get_group(name).derive(EventCounts(dict(c)), H100, 2e-3)
    want = jax_groups.get_group(name).derive(
        JaxEventCounts(dict(c)), _jax_chip(peak=H100.peak_f32_flops), 2e-3)
    _same(got, want)
    assert groups.t_compute(EventCounts(dict(c)), H100) == \
        c["FLOPS_TOTAL"] / 67e12


def test_an_event_the_port_cannot_produce_reads_zero():
    ev = EventCounts({"FLOPS_TOTAL": 10.0})
    assert ev["ICI_TOTAL_BYTES"] == 0.0 and ev.get("REMAT_DUP_OPS") == 0.0
    out = groups.get_group("ICI").derive(ev, H100, 1.0)
    assert out["T_ici"] == 0.0 and out["Wire volume (per device)"] == 0.0


@pytest.mark.parametrize("seed,links", [(0, None), (3, 4), (4, None)])
def test_roofline_terms_equal_reference(seed, links):
    c = _counts(seed, ici=seed != 4)
    kw = dict(cell="case", model_flops_total=3e12, num_devices=2)
    got = roofline.analyze(EventCounts(dict(c)), chip=H100,
                           nvlink_links_used=links, **kw)
    want = jax_roofline.analyze(JaxEventCounts(dict(c)), chip=_jax_chip(),
                                ici_links_used=links, **kw)
    assert got.t_compute == pytest.approx(want.t_compute, rel=1e-12)
    assert got.t_memory == pytest.approx(want.t_memory, rel=1e-12)
    assert got.t_nvlink == pytest.approx(want.t_ici, rel=1e-12)
    assert got.bound == {"ici": "nvlink"}.get(want.bound, want.bound)
    for p in ("efficiency_overlap", "mfu_bound", "useful_flops_ratio"):
        assert getattr(got, p) == pytest.approx(getattr(want, p), rel=1e-12)
    assert roofline.model_flops(10, 7, training=False) == \
        jax_roofline.model_flops(10, 7, training=False)


def test_event_table_and_round_trip_match_reference():
    c = _counts(5)
    ev = EventCounts(dict(c))
    lines = ev.table().splitlines()
    assert lines[:-1] == JaxEventCounts(dict(c)).table().splitlines()
    assert "declared" in lines[-1]
    assert EventCounts.from_dict(json.loads(json.dumps(ev.to_dict()))) == ev


# ---------------------------------------------------------------------------
# regions: accumulation, markers, threads
# ---------------------------------------------------------------------------

def _measurements(mod, ec, chip, seed):
    rng = np.random.default_rng(seed)
    return [mod.Measurement(
        region=f"r{int(rng.integers(0, 3))}",
        events=ec({"FLOPS_TOTAL": float(rng.integers(1, 100)),
                   "BYTES_ACCESSED": float(rng.integers(1, 100))}),
        chip=chip, num_devices=1, calls=int(rng.integers(1, 4)),
        wall_times=list(rng.uniform(0, 1, 2))) for _ in range(12)]


def test_record_accumulates_like_reference():
    ours = perfctr.PerfCtr(chip=H100, device="cpu")
    theirs = jax_perfctr.PerfCtr(chip=_jax_chip())
    for m in _measurements(perfctr, EventCounts, H100, 0):
        ours.record(m)
    for m in _measurements(jax_perfctr, JaxEventCounts, _jax_chip(), 0):
        theirs.record(m)
    assert ours.regions.keys() == theirs.regions.keys()
    for k, m in ours.regions.items():
        t = theirs.regions[k]
        assert m.events.counts == t.events.counts
        assert (m.calls, m.wall_times) == (t.calls, t.wall_times)
        assert m.mean_time == t.mean_time


def test_markers_nest_per_thread_like_reference():
    def drive(ctr, probe_fn, arg):
        def worker(i):
            with ctr.marker(f"outer{i}"):
                ctr.probe(probe_fn, arg)
                with ctr.marker(f"inner{i}"):
                    ctr.probe(probe_fn, arg)
                    ctr.probe(probe_fn, arg)
                ctr.probe(probe_fn, arg)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        return {k: m.calls for k, m in ctr.regions.items()}

    ours = drive(perfctr.PerfCtr(chip=H100, device="cpu"),
                 lambda b: stream_triad(b, b), torch.ones(256))
    theirs = drive(jax_perfctr.PerfCtr(chip=_jax_chip()),
                   lambda b: b * 2.0, jnp.ones(256))
    # the reference counts one call per probe; the port counts its
    # `repeats` timed calls per probe (10 by default)
    assert ours == {k: 10 * v for k, v in theirs.items()}
    assert theirs == {f"outer{i}": 2 for i in range(3)} | \
        {f"inner{i}": 2 for i in range(3)}


# ---------------------------------------------------------------------------
# the port's own measurement: declared events of executed code
# ---------------------------------------------------------------------------

def test_measure_on_the_cpu_records_every_wrapper_call():
    b = torch.ones(128 * 4)
    x = torch.zeros(12, 20, 70)

    def step():
        stream_triad(b, b)
        jacobi7_wavefront(x, sweeps=2)

    m = perfctr.measure(step, device="cpu", repeats=3)
    assert m.calls == 3 and len(m.wall_times) == 3
    assert m.chip is hwinfo.HOST_CPU
    assert m.events["LAUNCHES"] == 6
    assert m.events["BYTES_ACCESSED"] == 3 * (
        triad_bytes(512) + kernel_bytes(x.shape, 2, (8, 16, 64)))
    assert m.events["HBM_PEAK_BYTES"] == 0.0
    # outside any collection a wrapper call records nothing
    with collect() as ev:
        pass
    stream_triad(b, b)
    assert ev["LAUNCHES"] == 0


def test_region_timer_and_report():
    ctr = perfctr.PerfCtr(chip=H100, groups=("HBM", "ROOFLINE"),
                          device="cpu")
    b = torch.ones(1024)
    for _ in range(2):
        with ctr.region_timer("triad"):
            stream_triad(b, b)
            stream_triad(b, b)
    m = ctr.regions["triad"]
    assert m.calls == 2 and m.events["LAUNCHES"] == 4
    assert m.time_s == pytest.approx(sum(m.wall_times))
    rates = groups.get_group("HBM").derive(m.events, H100, m.time_s)
    assert rates["Bandwidth (measured)"] == pytest.approx(
        4 * triad_bytes(1024) / m.time_s / 1e9)
    text = ctr.report()
    assert "Region: triad" in text and "Measuring group ROOFLINE" in text
    ctr.reset_regions()
    assert ctr.regions == {} and ctr.chip is H100


def test_multiplex_derives_from_the_regions_events():
    ctr = perfctr.PerfCtr(chip=H100, device="cpu")
    b = torch.ones(1024)
    with ctr.region_timer("step"):
        stream_triad(b, b)
    out = ctr.multiplex(lambda: stream_triad(b, b), groups=["HBM", "ROOFLINE"],
                        steps_per_group=2, region="step")
    assert set(out) == {"HBM", "ROOFLINE"}
    assert out["HBM"]["wall_s"] > 0
    with pytest.raises(ValueError):
        ctr.multiplex(lambda: None, groups=["HBM"], steps_per_group=0)


def test_global_marker_convenience(monkeypatch):
    monkeypatch.setattr(marker, "_GLOBAL",
                        perfctr.PerfCtr(chip=H100, device="cpu"))
    b = torch.ones(256)
    with marker.region("g"):
        marker.probe(stream_triad, b, b, repeats=2)
    assert marker.global_perfctr().regions["g"].events["LAUNCHES"] == 2
    assert "Region: g" in marker.report(["HBM"])
    marker.reset()
    assert marker.global_perfctr().regions == {}


def test_measuring_without_a_gpu_raises_unless_asked_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        perfctr.PerfCtr()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bandwidth.measure_map([1 << 14])


# ---------------------------------------------------------------------------
# data sheets and the bandwidth map
# ---------------------------------------------------------------------------

def test_lookup_chip_by_device_name():
    assert hwinfo.lookup_chip("NVIDIA H100 80GB HBM3") is hwinfo.H100_SXM
    assert hwinfo.lookup_chip("NVIDIA H100 PCIe") is hwinfo.H100_PCIE
    assert hwinfo.lookup_chip("cpu") is hwinfo.HOST_CPU
    for unknown in ("NVIDIA A100-SXM4-80GB", "TPU v5 lite", "NVIDIA H100"):
        with pytest.raises(ValueError, match="no data sheet"):
            hwinfo.lookup_chip(unknown)
    assert H100.nvlink_bw == 900e9
    assert H100.flops_for_dtype("bfloat16") == 989e12
    assert H100.flops_for_dtype("float32") == 67e12
    assert H100.flops_for_dtype("int8") == 1979e12


def test_check_device_against_reported_properties():
    props = type("P", (), dict(multi_processor_count=132,
                               L2_cache_size=50 * 2**20,
                               total_memory=85_030_000_000))
    assert hwinfo.check_device(H100, props) == []
    props.multi_processor_count = 114
    assert "SMs" in hwinfo.check_device(H100, props)[0]


def test_render_map_equals_reference_on_the_same_points():
    rng = np.random.default_rng(0)
    pts = [(2**k, float(rng.uniform(1e9, 4e12)), lvl, True,
            float(rng.uniform(1e9, 4e12)))
           for k, lvl in zip(range(14, 32, 3), ["L2"] * 3 + ["HBM"] * 3)]
    for best in (True, False):
        ours = [bandwidth.BandwidthPoint(*p[:4], p[4] if best else 0.0)
                for p in pts]
        theirs = [jax_bandwidth.BandwidthPoint(*p[:4], p[4] if best else 0.0)
                  for p in pts]
        assert bandwidth.render_map(ours, title="t") == \
            jax_bandwidth.render_map(theirs, title="t")


def test_model_map_prints_na_where_the_data_sheet_has_no_number():
    pts = bandwidth.model_map(H100)
    assert [p.level for p in pts] == ["REG", "SMEM", "L2", "HBM"]
    assert pts[-1].bandwidth == 3.35e12
    assert all(math.isnan(p.bandwidth) for p in pts[:-1])
    text = bandwidth.render_map(pts, title="sheet")
    assert text.count("n/a") == 3 and "3350.00 GB/s" in text


def test_measure_map_on_the_cpu():
    pts = bandwidth.measure_map([1 << 14, 1 << 16], repeats=2, device="cpu")
    assert [p.measured for p in pts] == [True, True]
    assert all(p.bandwidth > 0 and p.bandwidth_best >= p.bandwidth
               for p in pts)
    assert pts[0].working_set_bytes == triad_bytes(
        (1 << 14) // 12 // 128 * 128)


# ---------------------------------------------------------------------------
# the four case-study benches, smoke size, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bench", [bench_bandwidth_map, bench_stream_pinning,
                                   bench_stencil_pinning,
                                   bench_jacobi_traffic])
def test_bench_smoke_on_the_cpu(bench, tmp_path, capsys):
    out = tmp_path / "r.json"
    res = bench.main(["--smoke", "--device", "cpu", "--json", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert capsys.readouterr().out
    if bench is bench_jacobi_traffic:
        naive, wave = res["rows"].values()
        assert naive["launches_per_call"] == 2
        assert wave["launches_per_call"] == 1
        assert wave["declared_bytes"] < naive["declared_bytes"]
    if bench is bench_stencil_pinning:
        fits = [r["fits"] for r in res["rows"]]
        assert True in fits and False in fits
        assert all("wrong placement" in r["refused"]
                   for r in res["rows"] if not r["fits"])
