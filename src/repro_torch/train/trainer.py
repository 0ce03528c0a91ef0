"""The LM trainer's serving step (the counterpart of
``repro.train.trainer.make_serve_step``).  The rest of the LM trainer —
train step, optimizers, data — is not ported yet (ROADMAP.md §1 item 8a).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models.transformer import ArchConfig, decode_step


def make_serve_step(cfg: ArchConfig, long: bool = False) -> Callable:
    """serve_step(params, cache, tokens) → (logits, cache)."""
    def serve_step(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens, long=long)
    return serve_step
