"""Graph construction, partitioning and neighbour sampling (numpy only).

The modules (``graph``, ``generators``, ``partition``, ``sampler``) are
copies of the reference package's numpy-only graph code with their
imports re-rooted here, so both packages build byte-identical partitions
and sampler batches from the same seeds; ``transpose`` is the port's own.
"""
from repro_torch.graph.graph import (EllMatrix, Graph, coo_to_ell,
                                     from_edges, gcn_norm_weights)
from repro_torch.graph.partition import (ChunkWorklist, LOCAL_ORDERS,
                                         PullPlan, StackedPartitions,
                                         build_chunk_worklist,
                                         build_partitions, build_pull_plan,
                                         edge_cut, greedy_partition,
                                         partition_report, random_partition,
                                         reverse_cuthill_mckee)
from repro_torch.graph.generators import (DATASETS, community_powerlaw_graph,
                                          make_dataset, powerlaw_graph,
                                          sbm_graph)
from repro_torch.graph.sampler import NeighborSampler, build_sampler

__all__ = [
    "EllMatrix", "Graph", "coo_to_ell", "from_edges", "gcn_norm_weights",
    "ChunkWorklist", "LOCAL_ORDERS", "PullPlan", "StackedPartitions",
    "build_chunk_worklist", "build_partitions", "build_pull_plan",
    "edge_cut", "greedy_partition", "partition_report", "random_partition",
    "reverse_cuthill_mckee", "DATASETS", "community_powerlaw_graph",
    "make_dataset", "powerlaw_graph", "sbm_graph", "NeighborSampler",
    "build_sampler",
]
