"""Fault-tolerance substrate: the straggler detector the scheduler feeds."""

from repro_torch.ft.straggler import (StragglerDetector,  # noqa: F401
                                      StragglerVerdict)
