"""Per-architecture configs (one module per ported arch) and the dry
run's shape catalogue."""

from repro_torch.configs.base import (ALL_ARCH_IDS, SHAPES,  # noqa: F401
                                      ArchSpec, Shape, get_arch,
                                      input_specs, list_archs)
