"""Serving snapshots (``store.py``); the pytree checkpoints of the JAX
package's ``repro.checkpoint`` go with training (``ROADMAP.md``, queue 1
item 13)."""

from repro_torch.checkpoint.store import (SnapshotCorrupt,  # noqa: F401
                                          latest_snapshot, list_snapshots,
                                          load_serving_snapshot,
                                          save_serving_snapshot)
