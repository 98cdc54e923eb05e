"""repro-features CLI (likwid-features): view/toggle switchable features.

    python -m repro_torch.launch.features                  # view state
    python -m repro_torch.launch.features --set remat_policy=full scan_unroll=2
    python -m repro_torch.launch.features --torch-settings # implied settings

Port of ``repro/launch/features.py``; ``--torch-settings`` takes the
place of ``--xla-flags``.  Settings persist for child runs through
``REPRO_FEATURE_*`` environment exports (``--export`` prints eval-able
shell lines), which the JAX package reads too.  It reads no device.
"""

from __future__ import annotations

import argparse

from repro_torch.core.features import (default_features, from_env,
                                       render_state, torch_settings_for)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--set", nargs="*", default=[],
                    metavar="NAME=VALUE",
                    help="toggle features, e.g. remat_policy=full")
    ap.add_argument("--torch-settings", action="store_true",
                    help="print the PyTorch settings the state implies "
                         "(reported, not applied)")
    ap.add_argument("--export", action="store_true",
                    help="print shell export lines for --set values")
    args = ap.parse_args(argv)

    fs = from_env(default_features())
    overrides = {}
    for item in args.set:
        if "=" not in item:
            ap.error(f"--set needs NAME=VALUE, got {item!r}")
        k, v = item.split("=", 1)
        cur = getattr(fs, k, None)
        if cur is None:
            ap.error(f"unknown feature {k!r}")
        if isinstance(cur, bool):
            overrides[k] = v.lower() in ("1", "true", "on", "yes")
        elif isinstance(cur, int):
            overrides[k] = int(v)
        else:
            overrides[k] = v
    if overrides:
        fs = fs.with_(**overrides)

    print(render_state(fs))
    if args.torch_settings:
        print("\nImplied PyTorch settings (reported, not applied):")
        for s in torch_settings_for(fs):
            print(f"  {s}")
    if args.export:
        print()
        for k, v in overrides.items():
            print(f"export REPRO_FEATURE_{k.upper()}={v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
