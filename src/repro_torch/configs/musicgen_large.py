"""musicgen-large [audio] — decoder-only over EnCodec tokens.

[arXiv:2306.05284] 48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048.
The EnCodec conv codec is a stub: input_specs supplies token ids in the
2048-entry codebook directly (one stream; the 4-codebook delay pattern is
modality-frontend logic). RoPE replaces sinusoidal embeddings (noted
deviation — positional scheme, not capacity).
A copy of ``src/repro/configs/musicgen_large.py``.
"""
import dataclasses
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    pattern=("attn",), rope_theta=10000.0,
    optimizer="adamw", learning_rate=3e-4,
    source="arXiv:2306.05284",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=256, head_dim=32, dtype="float32")
