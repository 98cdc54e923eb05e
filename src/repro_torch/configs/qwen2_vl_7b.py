"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064,
M-RoPE + dynamic resolution (arXiv:2409.12191; hf tier).

Backbone only: the vision frontend is a stub, and the caller passes
precomputed patch embeddings [B, 256, D] (a 16x16 grid) as
``extra_batch["patch_embeds"]``; they replace the first 256 token
embeddings.  M-RoPE sections (16, 24, 24) frequency pairs over the (t, h,
w) position streams (head dim 128).  About 7.6 B parameters (~15.2 GB in
bf16): one 80 GB card serves it at full width and depth.  Full
attention: long_500k skipped.
"""

from repro_torch.configs.base import ArchSpec, LONG_SKIP, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen2-vl-7b", family="vlm",
    vocab=152064, d_model=3584, n_layers=28,
    num_heads=28, num_kv_heads=4, d_ff=18944, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), n_patches=256, patch_grid=(16, 16),
    chunk_size=512,
)

SMOKE = LMConfig(
    name="qwen2-vl-7b-smoke", family="vlm",
    vocab=256, d_model=64, n_layers=2,
    num_heads=4, num_kv_heads=2, d_ff=128, head_dim=16,
    qkv_bias=True,
    mrope_sections=(4, 2, 2), n_patches=4, patch_grid=(2, 2),
    chunk_size=16,
)

register(ArchSpec(
    arch_id="qwen2-vl-7b", config=CONFIG, smoke=SMOKE,
    source="arXiv:2409.12191; hf",
    skip_shapes=(LONG_SKIP,),
))
