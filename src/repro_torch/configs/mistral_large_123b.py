"""mistral-large-123b [dense]: 88L d_model=12288 96H (kv=8) d_ff=28672
vocab=32768, head_dim=128 (hf:mistralai/Mistral-Large-Instruct-2407;
unverified tier).

GQA with G = 96 / 8 = 12 query heads a KV head.  Its ~123B parameters
(~246 GB in bf16) do not fit one 80 GB card: the card serves it at full
width with fewer layers.  Full attention: long_500k skipped.
"""

from repro_torch.configs.base import ArchSpec, LONG_SKIP, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="mistral-large-123b", family="dense",
    vocab=32768, d_model=12288, n_layers=88,
    num_heads=96, num_kv_heads=8, d_ff=28672, head_dim=128,
    rope_theta=1e6,
    chunk_size=512,
)

SMOKE = LMConfig(
    name="mistral-large-123b-smoke", family="dense",
    vocab=256, d_model=96, n_layers=3,
    num_heads=6, num_kv_heads=2, d_ff=224, head_dim=16,
    chunk_size=16,
)

register(ArchSpec(
    arch_id="mistral-large-123b", config=CONFIG, smoke=SMOKE,
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
    skip_shapes=(LONG_SKIP,),
))
