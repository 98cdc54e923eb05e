"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal (arXiv:2308.11596; hf tier).

Backbone only: the speech frontend is a stub, and the caller passes
precomputed frame embeddings [B, S/4, D] (4x = the speech encoder's conv
downsampling ratio) as ``extra_batch["src_embeds"]``, the encoder's
input.  12 encoder + 12 decoder layers, LayerNorm, GELU FFN.  About
0.88 B parameters (~1.8 GB in bf16).  Full attention: long_500k
skipped.
"""

from repro_torch.configs.base import ArchSpec, LONG_SKIP, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="seamless-m4t-medium", family="encdec",
    vocab=256206, d_model=1024, n_layers=12, enc_layers=12,
    num_heads=16, num_kv_heads=16, d_ff=4096,
    norm="layernorm", norm_eps=1e-5, src_ratio=4,
    chunk_size=512,
)

SMOKE = LMConfig(
    name="seamless-m4t-medium-smoke", family="encdec",
    vocab=512, d_model=64, n_layers=2, enc_layers=2,
    num_heads=4, num_kv_heads=4, d_ff=128,
    norm="layernorm", norm_eps=1e-5, src_ratio=4,
    chunk_size=16,
)

register(ArchSpec(
    arch_id="seamless-m4t-medium", config=CONFIG, smoke=SMOKE,
    source="arXiv:2308.11596; hf",
    skip_shapes=(LONG_SKIP,),
))
