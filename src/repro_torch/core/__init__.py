"""repro_torch.core — the LIKWID tool layer, retargeted at one GPU.

Ported so far (the rest of ``repro/core`` — topology, pin, features, the
compile-artifact session and the perf report — waits for a later slice):

==================  ========================================================
paper tool          module
==================  ========================================================
data sheets         :mod:`repro_torch.core.hwinfo`
likwid-perfCtr      :mod:`repro_torch.core.perfctr` (events / groups /
                    marker); events are the kernels' declared models,
                    times come from CUDA events
==================  ========================================================

plus the §VI future-plan deliverables: :mod:`repro_torch.core.roofline`
and :mod:`repro_torch.core.bandwidth` (the "bandwidth map").
"""

from repro_torch.core import hwinfo, events, groups, perfctr, marker, \
    roofline, bandwidth  # noqa: F401

__all__ = ["hwinfo", "events", "groups", "perfctr", "marker", "roofline",
           "bandwidth"]
