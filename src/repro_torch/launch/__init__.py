"""Launchers: ``python -m repro_torch.launch.<name>`` for ``serve``,
``train``, ``dryrun``, ``roofline_report``, ``perfctr``, ``perf_report``,
``topology``, ``pin`` and ``features``."""
