"""Public entry: fused GAT aggregation over DIGEST's split adjacency.

``backend`` keeps the reference's vocabulary: ``"auto"`` runs K5
(:func:`.gat_edge.gat_edge_partial_cuda`: the kernel on CUDA tensors, its
plain version on CPU tensors), ``"jnp"`` the dense oracle of :mod:`.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gat_edge.gat_edge import gat_edge_partial_cuda
from repro_torch.kernels.gat_edge.ref import (gat_edge_partial_ref,
                                              merge_partials)

BACKENDS = ("auto", "jnp")


def gat_aggregate(in_nbr, in_valid, out_nbr, out_valid, s_dst,
                  s_src_local, s_src_halo, z_local, z_halo,
                  backend: str = "auto") -> torch.Tensor:
    """Single-head fused GAT layer aggregation (DIGEST split form).

    z_local/z_halo and s_src_* must include the sentinel row.  Returns the
    softmax-normalised aggregation over the union of both edge sets.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    fn = gat_edge_partial_ref if backend == "jnp" else gat_edge_partial_cuda
    p_in = fn(in_nbr, in_valid, s_dst, s_src_local, z_local)
    p_out = fn(out_nbr, out_valid, s_dst, s_src_halo, z_halo)
    return merge_partials([p_in, p_out])
