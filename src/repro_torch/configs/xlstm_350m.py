"""xlstm-350m [xlstm]: 24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.

sLSTM + mLSTM alternating blocks (arXiv:2405.04517; unverified tier).
d_ff=0: the projections live inside the xLSTM blocks (mLSTM proj-factor
2, head dim 512; sLSTM post-FFN factor 4/3, rounded up to 1408).
Sub-quadratic: O(1) recurrent state in sequence length.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="xlstm-350m", family="xlstm",
    vocab=50304, d_model=1024, n_layers=24,
    num_heads=4, num_kv_heads=4, d_ff=0,
    chunk_size=256,
)

SMOKE = LMConfig(
    name="xlstm-350m-smoke", family="xlstm",
    vocab=256, d_model=64, n_layers=4,
    num_heads=4, num_kv_heads=4, d_ff=0,
    chunk_size=16,
)

register(ArchSpec(
    arch_id="xlstm-350m", config=CONFIG, smoke=SMOKE,
    source="arXiv:2405.04517; unverified",
))
