"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (kv=4) d_ff=1536
vocab=151936, MoE 128 routed top-8, no shared experts
(hf:Qwen/Qwen3-30B-A3B family scaling; hf tier).

head_dim=128 (Qwen3 decouples head_dim from d_model/num_heads), so
``wq`` is ``[4096, 64, 128]``; GQA with G = 64 / 4 = 16.  About 2.49 B
parameters a layer (~470 GB in bf16 at full depth) do not fit one 80 GB
card: the card serves it at full width with fewer layers.  Full
attention: long_500k skipped.
"""

from repro_torch.configs.base import ArchSpec, LONG_SKIP, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    vocab=151936, d_model=4096, n_layers=94,
    num_heads=64, num_kv_heads=4, d_ff=1536, head_dim=128,
    rope_theta=1e6,
    moe_experts=128, moe_top_k=8,
    chunk_size=512,
)

SMOKE = LMConfig(
    name="qwen3-moe-235b-a22b-smoke", family="moe",
    vocab=256, d_model=64, n_layers=3,
    num_heads=8, num_kv_heads=2, d_ff=32, head_dim=16,
    moe_experts=16, moe_top_k=4,
    chunk_size=16,
)

register(ArchSpec(
    arch_id="qwen3-moe-235b-a22b", config=CONFIG, smoke=SMOKE,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
    skip_shapes=(LONG_SKIP,),
))
