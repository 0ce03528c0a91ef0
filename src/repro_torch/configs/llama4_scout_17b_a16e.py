"""llama4-scout-17b-a16e [moe] — 16 experts, top-1, shared expert,
early-fusion token stream.

[hf:meta-llama/Llama-4-Scout-17B-16E] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 16e top-1.
A copy of ``src/repro/configs/llama4_scout_17b_a16e.py``.
"""
import dataclasses
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    pattern=("moe",), num_experts=16, experts_per_token=1,
    shared_expert=True, rope_theta=500000.0,
    optimizer="adafactor", learning_rate=1.5e-4,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=32, num_experts=4,
    dtype="float32", optimizer="adamw", moe_impl="ref")
