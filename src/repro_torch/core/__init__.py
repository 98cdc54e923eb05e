"""repro_torch.core — the LIKWID tool layer, retargeted at one GPU.

==================  ========================================================
paper tool          module
==================  ========================================================
data sheets         :mod:`repro_torch.core.hwinfo`
likwid-topology     :mod:`repro_torch.core.topology` (the card and its SMs
                    from ``torch.cuda``; a synthesized pod for placement)
likwid-pin          :mod:`repro_torch.core.pin` (device orders over a
                    topology)
likwid-perfCtr      :mod:`repro_torch.core.perfctr` (events / groups /
                    marker); events are the kernels' declared models,
                    times come from CUDA events
likwid-features     :mod:`repro_torch.core.features` (the switchable
                    state and the PyTorch settings it implies)
==================  ========================================================

plus the §VI future-plan deliverables: :mod:`repro_torch.core.roofline`
and :mod:`repro_torch.core.bandwidth` (the "bandwidth map").  Their CLIs
are ``python -m repro_torch.launch.{topology,pin,features}``; the kernel
registry that pins and tunes an implementation per family is
:mod:`repro_torch.kernels.registry`, whose sweeps go through
:mod:`repro_torch.core.session` (``ProfileSession``: measured runs, cached
in :mod:`repro_torch.core.artifact_cache`; device time from
:mod:`repro_torch.core.devtime`), and :mod:`repro_torch.core.perf_report`
renders their tune tables.  Not ported yet (``ROADMAP.md``): the perf
report's and the perfctr tool's CLIs.
"""

from repro_torch.core import hwinfo, events, groups, perfctr, marker, \
    roofline, bandwidth, topology, pin, features, artifact_cache, \
    devtime, session, perf_report  # noqa: F401

__all__ = ["hwinfo", "events", "groups", "perfctr", "marker", "roofline",
           "bandwidth", "topology", "pin", "features", "artifact_cache",
           "devtime", "session", "perf_report"]
