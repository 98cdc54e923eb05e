"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared experts
(hf:Qwen/Qwen1.5-MoE-A2.7B; hf tier).

Shared experts are fused into one SwiGLU of width 4*1408=5632 with a
sigmoid-gated residual (the HF implementation's shared_expert_gate).
QKV bias per Qwen1.5.  About 14.3 B parameters (~28.6 GB in bf16): one
80 GB card serves it at full width and depth.  Full attention: long_500k
skipped.
"""

from repro_torch.configs.base import ArchSpec, LONG_SKIP, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b", family="moe",
    vocab=151936, d_model=2048, n_layers=24,
    num_heads=16, num_kv_heads=16, d_ff=1408,
    qkv_bias=True, rope_theta=1e6,
    moe_experts=60, moe_top_k=4,
    moe_shared_experts=4, moe_d_ff_shared=5632,
    chunk_size=512,
)

SMOKE = LMConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    vocab=256, d_model=64, n_layers=2,
    num_heads=4, num_kv_heads=4, d_ff=32,
    qkv_bias=True,
    moe_experts=8, moe_top_k=2,
    moe_shared_experts=2, moe_d_ff_shared=64,
    chunk_size=16,
)

register(ArchSpec(
    arch_id="qwen2-moe-a2.7b", config=CONFIG, smoke=SMOKE,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
    skip_shapes=(LONG_SKIP,),
))
