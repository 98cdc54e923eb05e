"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192,
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
(arXiv:2411.15242; hf tier).

38 Mamba2 (SSD) layers; ONE weight-shared transformer block (32H attention
+ 8192 SwiGLU) applied after every 6th mamba layer (7 application points,
each with its own KV cache).  Documented simplification vs the paper: the
shared block consumes the running hidden state directly (no concat with
the original embedding / LoRA projectors).  Sub-quadratic backbone: runs
long_500k (attention caches shard their 500k sequence over the data axis).
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="zamba2-1.2b", family="hybrid",
    vocab=32000, d_model=2048, n_layers=38,
    num_heads=32, num_kv_heads=32, d_ff=8192,
    ssm_state=64, ssm_head_dim=64, attn_every=6,
    chunk_size=256,
)

SMOKE = LMConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    vocab=256, d_model=64, n_layers=4,
    num_heads=4, num_kv_heads=4, d_ff=128,
    ssm_state=16, ssm_head_dim=16, attn_every=2,
    chunk_size=16,
)

register(ArchSpec(
    arch_id="zamba2-1.2b", config=CONFIG, smoke=SMOKE,
    source="arXiv:2411.15242; hf",
))
