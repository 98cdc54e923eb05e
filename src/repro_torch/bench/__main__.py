"""``python -m repro_torch.bench``: the port's bench runner
(:mod:`repro_torch.bench.run`)."""

from repro_torch.bench.run import main

if __name__ == "__main__":
    raise SystemExit(main())
