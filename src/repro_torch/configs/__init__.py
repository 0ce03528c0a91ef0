"""Config registry: the paper's own GNN configs (``digest_gcn``,
``digest_gat``) and the LM architectures (copies of the reference's).

``get_arch(name)`` returns the full published ArchConfig,
``get_smoke_arch(name)`` the reduced same-family variant of the CPU tests
and :func:`all_archs` every architecture's ArchConfig: the dense family
(qwen3-0.6b, phi3-mini-3.8b, deepseek-coder-33b, minitron-8b,
musicgen-large), the MoE family (llama4-scout-17b-a16e, kimi-k2-1t-a32b),
the hybrid recurrentgemma-9b, the xLSTM xlstm-1.3b and the VLM
llama-3.2-vision-11b.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "llama_3_2_vision_11b",
    "llama4_scout_17b_a16e",
    "deepseek_coder_33b",
    "kimi_k2_1t_a32b",
    "qwen3_0_6b",
    "recurrentgemma_9b",
    "xlstm_1_3b",
    "minitron_8b",
    "musicgen_large",
    "phi3_mini_3_8b",
]

# Every architecture has a port.
PORTED = tuple(ARCH_IDS)

# CLI-friendly aliases (the assignment's dashed ids).
ALIASES = {
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-0.6b": "qwen3_0_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "xlstm-1.3b": "xlstm_1_3b",
    "minitron-8b": "minitron_8b",
    "musicgen-large": "musicgen_large",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_arch(name: str):
    return _module(name).CONFIG


def get_smoke_arch(name: str):
    return _module(name).SMOKE


def all_archs() -> dict:
    return {n: get_arch(n) for n in ARCH_IDS}
