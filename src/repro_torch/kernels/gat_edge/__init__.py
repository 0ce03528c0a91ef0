from repro_torch.kernels.gat_edge.gat_edge import (gat_edge_partial_cuda,
                                                   gat_edge_partial_plain)
from repro_torch.kernels.gat_edge.ops import gat_aggregate
from repro_torch.kernels.gat_edge.ref import (gat_edge_partial_ref,
                                              merge_partials)

__all__ = ["gat_aggregate", "gat_edge_partial_cuda",
           "gat_edge_partial_plain", "gat_edge_partial_ref",
           "merge_partials"]
