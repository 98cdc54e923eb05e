"""Quickstart: the LIKWID-analogue tools of the PyTorch port in one minute.

The port's counterpart of ``examples/quickstart.py``:

    PYTHONPATH=src python examples/quickstart_torch.py              # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

1. repro-topology  — probe the card (``--device cpu``: a synthetic one)
   and render the modelled pod's topology
2. repro-pin       — choose a physical device order for the mesh
3. repro-perfctr   — marker mode over executed functions: declared
   events, times from CUDA events
4. repro-features  — view/toggle the switchable features
5. kernel registry — one named, overridable surface over every Hopper
   kernel family, with measured (and disk-persisted) autotuning through
   a ProfileSession: the second run of this script times nothing
"""

import argparse

import torch

from repro_torch.core import pin, topology
from repro_torch.core.features import default_features, render_state
from repro_torch.core.perfctr import PerfCtr
from repro_torch.core.session import ProfileSession
from repro_torch.kernels import registry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # -- 1. topology (likwid-topology) ------------------------------------
    print(topology.probe(dev).render())
    pod = topology.synthesize(topology.PRODUCTION_SINGLE_POD)
    print(pod.memory_table())

    # -- 2. pin (likwid-pin) ----------------------------------------------
    for name in ("compact", "scatter", "ring"):
        print(pin.get_strategy(name)(pod).describe())
    print(pin.get_strategy("0-7,12-15")(pod, skip=(13,)).describe())

    # -- 3. perfctr (likwid-perfctr): marker mode over executed code ------
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(256, 256, generator=gen, device=dev)
    b = torch.randn(128 * 512, generator=gen, device=dev)
    ctr = PerfCtr(groups=("HBM", "ROOFLINE"), device=dev)
    with ctr.marker("Triad"):
        ctr.probe(registry.run, "stream_triad", b, b)
    with ctr.marker("Benchmark"):
        ctr.probe(lambda x: torch.tanh(x @ x), a)
    print(ctr.report())

    # -- 4. features (likwid-features) ------------------------------------
    feats = default_features()
    print(render_state(feats))
    print("\nflip remat off ->")
    print(render_state(feats.with_(remat_policy="none")))

    # -- 5. the kernel registry -------------------------------------------
    # every Hopper kernel is a named impl in a family; selection is
    # overridable from ONE ladder (use_impl context,
    # REPRO_IMPL="attention=cuda_flash,...", the family heuristics)
    print("\nregistered kernel families:")
    print(registry.describe())
    q = torch.randn(1, 32, 4, 16, generator=gen, device=dev)
    k = torch.randn(1, 32, 2, 16, generator=gen, device=dev)
    v = torch.randn(1, 32, 2, 16, generator=gen, device=dev)
    picked = registry.select("attention", sq=32, sk=32, dh=16,
                             backend=dev.type)
    out = registry.run("attention", q, k, v, causal=True)   # self-selects
    print(f"\nattention heuristics picked {picked!r} "
          f"(out {tuple(out.shape)})")
    with registry.use_impl(attention="torch_flash"):
        forced = registry.select("attention", sq=32, sk=32, dh=16,
                                 backend=dev.type)
        print(f"inside use_impl(attention='torch_flash'): {forced!r}")

    # autotune a family through the session: candidates are gated on
    # shared memory, timed on the card (the roofline over declared events
    # on the CPU), and the winner persists in the artifact cache — a
    # fresh process resolves best() from disk with ZERO sweeps and ZERO
    # timed probes
    session = ProfileSession()           # $REPRO_CACHE_DIR or ~/.cache
    n = 128 * 512
    rec = registry.autotune("stream_triad", session, n=n,
                            candidates=((8,), (16,)), backend=dev.type)
    src = "swept" if rec.swept else "warm from the persisted tune table"
    print(f"stream_triad tuned: block_rows={rec.choice[0]} "
          f"({src}, {rec.lowerings} timed probes)")
    print(f"best() now serves "
          f"{registry.best('stream_triad', n=n, backend=dev.type)} to "
          f"every call of that shape")
    print(f"[{session.stats()}]")


if __name__ == "__main__":
    main()
