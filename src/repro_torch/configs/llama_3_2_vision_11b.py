"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer.

[hf:meta-llama/Llama-3.2-11B-Vision] 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256. Vision frontend is a stub: input_specs supplies
precomputed patch embeddings (B, 1601, 1280) consumed by xattn layers.
A copy of ``src/repro/configs/llama_3_2_vision_11b.py``.
"""
import dataclasses
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    pattern=("attn", "attn", "attn", "attn", "xattn"),
    vision_dim=1280, num_patches=1601, rope_theta=500000.0,
    optimizer="adafactor", learning_rate=1.5e-4,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32,
    pattern=("attn", "xattn"), vision_dim=64, num_patches=17,
    dtype="float32", optimizer="adamw")
