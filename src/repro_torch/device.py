"""Device resolution for the port's entry points.

``LM`` and ``Engine`` run on ``cuda`` unless the caller asks for the CPU.
With no GPU and no explicit request they raise: a silent CPU fallback would
measure PyTorch's CPU kernels under the GPU's name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is visible); otherwise the
    given device, which must be ``cpu``, an available ``cuda`` device or
    ``meta``: the dry run's walk (:mod:`repro_torch.launch.dryrun`),
    which builds models of shapes alone, allocating and launching
    nothing.  ``meta`` is only ever taken when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu' "
                         f"('meta' for the dry run)")
    return dev
