"""deepseek-coder-33b [dense] — llama-arch code model.

[arXiv:2401.14196] 62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
A copy of ``src/repro/configs/deepseek_coder_33b.py``.
"""
import dataclasses
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19200, vocab_size=32256, head_dim=128,
    pattern=("attn",), rope_theta=100000.0,
    optimizer="adafactor", learning_rate=1.2e-4,
    source="arXiv:2401.14196",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16,
    dtype="float32", optimizer="adamw")
