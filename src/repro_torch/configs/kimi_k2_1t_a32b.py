"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table scale test).

[arXiv:2501.kimi2] 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per expert)
vocab=163840, MoE 384e top-8 + shared expert. Adafactor is mandatory at
this scale (Adam state alone would exceed 512 x 16 GB HBM).
A copy of ``src/repro/configs/kimi_k2_1t_a32b.py``.
"""
import dataclasses
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    pattern=("moe",), num_experts=384, experts_per_token=8,
    shared_expert=True, rope_theta=1000000.0,
    optimizer="adafactor", learning_rate=1e-4,
    source="arXiv:2501.kimi2",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=512, head_dim=32, num_experts=4,
    experts_per_token=2, dtype="float32", optimizer="adamw",
    moe_impl="ref")
