"""Fault-tolerance substrate: the straggler detector the scheduler feeds,
the seeded chaos harness (``chaos.py``) it ticks, and the mesh's
heartbeats (``heartbeat.py``) and elastic re-mesh (``elastic.py``)."""

from repro_torch.ft.straggler import (StragglerDetector,  # noqa: F401
                                      StragglerVerdict)
