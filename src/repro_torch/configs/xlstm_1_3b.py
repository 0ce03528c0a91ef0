"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, 7:1 ratio.

[arXiv:2405.04517] 48L d_model=2048 4H (kv=4) d_ff=0 (blocks carry their
own expansions: mLSTM pf=2 up-projection, sLSTM block has a 2x MLP).
A copy of ``src/repro/configs/xlstm_1_3b.py``.
"""
import dataclasses
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm",
             "mlstm", "slstm"),
    mlstm_expansion=2,
    optimizer="adamw", learning_rate=3e-4,
    source="arXiv:2405.04517",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=512, pattern=("mlstm", "slstm"),
    dtype="float32")
