"""qwen2-0.5b [dense]: 24L d_model=896 14H (kv=2) d_ff=4864 vocab=151936,
GQA + QKV bias (arXiv:2407.10671; hf tier).  Full attention: long_500k
skipped."""

from repro_torch.configs.base import ArchSpec, LONG_SKIP, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen2-0.5b", family="dense",
    vocab=151936, d_model=896, n_layers=24,
    num_heads=14, num_kv_heads=2, d_ff=4864,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    chunk_size=512,
)

SMOKE = LMConfig(
    name="qwen2-0.5b-smoke", family="dense",
    vocab=256, d_model=56, n_layers=2,
    num_heads=7, num_kv_heads=1, d_ff=128,
    qkv_bias=True, tie_embeddings=True,
    chunk_size=16,
)

register(ArchSpec(
    arch_id="qwen2-0.5b", config=CONFIG, smoke=SMOKE,
    source="arXiv:2407.10671; hf",
    skip_shapes=(LONG_SKIP,),
))
