#!/usr/bin/env python3
"""Device time of the port's K6 (``flash_attention_cuda``) at the LM
slice's shapes, on one NVIDIA card.

    PYTHONPATH=src python3 scripts/torch_flash_times.py [--label NAME]

The ``repro_torch`` on the import path is the one timed, so two checkouts
are compared on one card by running this script once with each checkout's
``src`` first on ``PYTHONPATH``, in turns (A, B, B, A).  Shapes: the
qwen3-0.6b prefill's attention (B 4, S 1024, 16 query heads over 8 KV
heads, head dim 128, causal) and the same at S 512 non-causal, in fp32
and bf16, on (B, H, S, D) views of (B, S, H, D) tensors as the
transformer passes them.  Each time is ``chip_smoke.device_ms``: 20 calls
queued behind a spin kernel between two CUDA events.  Prints the card's
``nvidia-smi`` name and power limit and one JSON line ``{"label",
"card", "ms": {shape: ms}}``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (device_ms, nvidia_smi)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_cuda

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(3)
    b, h, kv, d = chip_smoke.LM_BATCH, 16, 8, 128
    ms = {}
    with torch.inference_mode():
        for dtype, causal, s in ((torch.float32, True, chip_smoke.LM_SEQ),
                                 (torch.float32, False, 512),
                                 (torch.bfloat16, True, chip_smoke.LM_SEQ),
                                 (torch.bfloat16, False, 512)):
            q, k, v = (torch.randn((b, s, n, d), generator=gen)
                       .to(dev, dtype).transpose(1, 2)
                       for n in (h, kv, kv))
            name = (f"{str(dtype).split('.')[-1]} "
                    f"{'causal' if causal else 'non-causal'} S{s}")
            ms[name] = chip_smoke.device_ms(
                torch, lambda: flash_attention_cuda(q, k, v, causal))
    import repro_torch
    print(card, flush=True)
    print(json.dumps({"label": args.label, "card": card,
                      "package": str(Path(repro_torch.__file__).parent),
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
