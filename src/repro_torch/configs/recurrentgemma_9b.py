"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec.

[arXiv:2402.19427] 38L d_model=4096 16H (kv=1, MQA) d_ff=12288
vocab=256000; local attention window 2048; rnn width = d_model.
38 = 12 x (rec, rec, swa) + (rec, rec) tail.
A copy of ``src/repro/configs/recurrentgemma_9b.py``.
"""
import dataclasses
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    pattern=("rec", "rec", "swa"), tail=("rec", "rec"),
    window=2048, rnn_dim=4096, conv_width=4,
    optimizer="adafactor", learning_rate=1.5e-4,
    source="arXiv:2402.19427",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=5, d_model=128, num_heads=4, num_kv_heads=1,
    d_ff=256, vocab_size=512, head_dim=32, window=64, rnn_dim=128,
    dtype="float32", optimizer="adamw")
