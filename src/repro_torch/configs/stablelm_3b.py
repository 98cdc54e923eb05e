"""stablelm-3b [dense]: 32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304
(hf:stabilityai/stablelm-2-1_6b scaling; unverified tier).

LayerNorm per the StableLM-2 family; head dim 2560 / 32 = 80.  Full
attention: long_500k skipped.
"""

from repro_torch.configs.base import ArchSpec, LONG_SKIP, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="stablelm-3b", family="dense",
    vocab=50304, d_model=2560, n_layers=32,
    num_heads=32, num_kv_heads=32, d_ff=6912,
    norm="layernorm", norm_eps=1e-5, rope_theta=10000.0,
    chunk_size=512,
)

SMOKE = LMConfig(
    name="stablelm-3b-smoke", family="dense",
    vocab=256, d_model=64, n_layers=2,
    num_heads=4, num_kv_heads=4, d_ff=160,
    norm="layernorm", norm_eps=1e-5,
    chunk_size=16,
)

register(ArchSpec(
    arch_id="stablelm-3b", config=CONFIG, smoke=SMOKE,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
    skip_shapes=(LONG_SKIP,),
))
