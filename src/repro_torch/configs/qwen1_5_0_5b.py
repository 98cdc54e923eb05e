"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936, QKV bias, tied embeddings (hf:Qwen/Qwen1.5-0.5B; hf tier).

Full attention: long_500k skipped.
"""

from repro_torch.configs.base import ArchSpec, LONG_SKIP, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen1.5-0.5b", family="dense",
    vocab=151936, d_model=1024, n_layers=24,
    num_heads=16, num_kv_heads=16, d_ff=2816,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    chunk_size=512,
)

SMOKE = LMConfig(
    name="qwen1.5-0.5b-smoke", family="dense",
    vocab=256, d_model=64, n_layers=2,
    num_heads=4, num_kv_heads=4, d_ff=128,
    qkv_bias=True, tie_embeddings=True,
    chunk_size=16,
)

register(ArchSpec(
    arch_id="qwen1.5-0.5b", config=CONFIG, smoke=SMOKE,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    skip_shapes=(LONG_SKIP,),
))
