"""Paper case study 1 (§III): thread topology vs STREAM triad, placement half.

The PyTorch port's counterpart of ``examples/case_study_stream.py``: the
ring-collective hop cost of pinned (the snake ``Ring`` order) against
random (unpinned) device orders, at mesh widths 4 .. 256, over the
modelled 16x16 production pod (:func:`repro_torch.core.topology.
synthesize`, the H100 data sheet on each chip), with the reference's
widths and ``default_rng(7)``, so it prints the reference's table.  It
reads no device: on the card :func:`repro_torch.core.topology.probe`
would return the one real H100, so the pod is synthesized explicitly.

    PYTHONPATH=src python examples/case_study_stream_torch.py
"""

import numpy as np

from repro_torch.core import pin, topology


def ring_cost(topo, ids):
    n = len(ids)
    return float(np.mean([topo.ici_hops(ids[i], ids[(i + 1) % n])
                          for i in range(n)]))


def main():
    topo = topology.synthesize(topology.PRODUCTION_SINGLE_POD)
    rng = np.random.default_rng(7)
    widths = [4, 8, 16, 32, 64, 128, 256]
    rows = []

    print("ring-collective hop cost vs device count "
          "(1.0 = every step is one link)")
    print(f"{'devices':>8} {'pinned(ring)':>13} "
          f"{'unpinned median':>16} {'unpinned q1-q3':>18}")
    for w in widths:
        ring_ids = list(pin.Ring()(topo).device_ids[:w])
        pinned = ring_cost(topo, ring_ids)
        rand = [ring_cost(topo, list(rng.permutation(256)[:w]))
                for _ in range(25)]
        q1, med, q3 = np.percentile(rand, [25, 50, 75])
        bar = "#" * int(med * 4)
        print(f"{w:>8} {pinned:>13.2f} {med:>16.2f} "
              f"{f'[{q1:.2f},{q3:.2f}]':>18}  {bar}")
        rows.append((w, pinned, float(med), float(q1), float(q3)))

    print("\npaper's Fig 4/5 conclusion, reproduced structurally:")
    print("  - unpinned placement cost varies run to run (the box plots);")
    print("  - pinned cost is deterministic and ~8x lower at full width.")
    return rows


if __name__ == "__main__":
    main()
