"""Per-architecture configs (one module per ported arch)."""

from repro_torch.configs.base import (ALL_ARCH_IDS, ArchSpec,  # noqa: F401
                                      get_arch)
