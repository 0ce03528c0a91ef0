"""qwen3-0.6b [dense] — qk_norm + GQA.

[hf:Qwen/Qwen3-8B family] 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, head_dim=128, qk-norm.
A copy of ``src/repro/configs/qwen3_0_6b.py``.
"""
import dataclasses
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=3072, vocab_size=151936, head_dim=128, qk_norm=True,
    pattern=("attn",), rope_theta=1000000.0,
    optimizer="adamw", learning_rate=3e-4,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32, dtype="float32")
