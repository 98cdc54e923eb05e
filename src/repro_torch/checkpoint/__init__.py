"""Training checkpoints and serving snapshots (``store.py``)."""

from repro_torch.checkpoint.store import (SnapshotCorrupt,  # noqa: F401
                                          latest_snapshot, latest_step,
                                          list_snapshots, list_steps,
                                          load_serving_snapshot,
                                          restore_checkpoint,
                                          save_checkpoint,
                                          save_serving_snapshot,
                                          wait_pending)
