"""minitron-8b [dense] — width-pruned Nemotron-4.

[arXiv:2407.14679] 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
A copy of ``src/repro/configs/minitron_8b.py``.
"""
import dataclasses
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000, head_dim=128,
    pattern=("attn",), rope_theta=500000.0,
    optimizer="adafactor", learning_rate=2e-4,
    source="arXiv:2407.14679",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32, dtype="float32",
    optimizer="adamw")
