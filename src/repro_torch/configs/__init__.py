"""Config registry: the paper's own GNN configs (``digest_gcn``,
``digest_gat``) and the LM architectures (copies of the reference's).

``get_arch(name)`` returns the full published ArchConfig and
``get_smoke_arch(name)`` the reduced same-family variant of the CPU tests.
The dense family (qwen3-0.6b, phi3-mini-3.8b, deepseek-coder-33b,
minitron-8b, musicgen-large) and the MoE family (llama4-scout-17b-a16e,
kimi-k2-1t-a32b) are ported; the other three architectures raise
``NotImplementedError`` naming their ROADMAP item, as does
:func:`all_archs`.
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

# The ported architectures: patterns of "attn" and "moe" blocks.
PORTED = ("deepseek_coder_33b", "kimi_k2_1t_a32b", "llama4_scout_17b_a16e",
          "minitron_8b", "musicgen_large", "phi3_mini_3_8b", "qwen3_0_6b")
# The others, with the ROADMAP.md §1 item that ports their blocks.
UNPORTED = {"recurrentgemma_9b": ("swa and rec", "8b"),
            "xlstm_1_3b": ("mlstm and slstm", "8c"),
            "llama_3_2_vision_11b": ("xattn and the vision cache", "8d")}

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
    if name not in PORTED:
        blocks, item = UNPORTED[name]
        raise NotImplementedError(
            f"arch {name!r} needs its {blocks} blocks, which are not ported "
            f"yet: ROADMAP.md §1 item {item}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_arch(name: str):
    return _module(name).CONFIG


def get_smoke_arch(name: str):
    return _module(name).SMOKE


def all_archs():
    raise NotImplementedError(
        "all_archs needs every architecture, and recurrentgemma-9b, "
        "xlstm-1.3b and llama-3.2-vision-11b are not ported yet: ROADMAP.md "
        "§1 item 8f")
