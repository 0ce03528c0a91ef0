"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper launches its kernel (``repro_torch/csrc/*.cu``, built by
:mod:`repro_torch.kernels._build` at first use) on CUDA tensors, and runs
its plain PyTorch version on CPU tensors.
"""
