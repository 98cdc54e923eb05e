"""Fault-tolerance substrate: the straggler detector the scheduler feeds
and the seeded chaos harness (``chaos.py``) it ticks."""

from repro_torch.ft.straggler import (StragglerDetector,  # noqa: F401
                                      StragglerVerdict)
