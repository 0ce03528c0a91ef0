"""PyTorch + CUDA port of the DIGEST reproduction (``src/repro``).

The package mirrors the reference layout (``graph/``, ``kernels/spmm/``,
``nn/``, ``models/``, ``core/``, ``launch/``) and keeps its public names
and argument layouts.  It imports ``torch`` and numpy only.  Every entry
point takes an explicit ``device`` and runs on the card unless the caller
asks for the CPU; on CPU tensors each kernel wrapper runs its plain
PyTorch version.
"""
