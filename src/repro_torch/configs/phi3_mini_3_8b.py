"""phi3-mini-3.8b [dense] — RoPE SwiGLU, MHA-ish (kv=32).

[arXiv:2404.14219] 32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
long_500k runs through stale-KV block attention (the paper's blocksparse
long variant mapped to the DIGEST mechanism).
A copy of ``src/repro/configs/phi3_mini_3_8b.py``.
"""
import dataclasses
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    pattern=("attn",), rope_theta=10000.0,
    optimizer="adamw", learning_rate=3e-4,
    source="arXiv:2404.14219",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, head_dim=32, dtype="float32")
