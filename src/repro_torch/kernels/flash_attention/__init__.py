from repro_torch.kernels.flash_attention.flash_attention import (
    BLOCKS, HEAD_DIMS, check_tma, flash_attention_cuda,
    flash_attention_plain, split_bf16)
from repro_torch.kernels.flash_attention.ops import multi_head_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_ref", "check_tma", "flash_attention_cuda",
           "flash_attention_plain", "multi_head_attention", "split_bf16",
           "BLOCKS", "HEAD_DIMS"]
