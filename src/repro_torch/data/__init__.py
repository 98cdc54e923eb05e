from repro_torch.data.pipeline import (DataConfig, MemmapTokens,  # noqa: F401
                                       SyntheticTokens, make_source)
