"""Graph construction and partitioning (numpy only).

The three modules are copies of the reference package's numpy-only graph
code with their imports re-rooted here, so both packages build
byte-identical partitions from the same seed.
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

__all__ = [
    "EllMatrix", "Graph", "coo_to_ell", "from_edges", "gcn_norm_weights",
    "ChunkWorklist", "LOCAL_ORDERS", "PullPlan", "StackedPartitions",
    "build_chunk_worklist", "build_partitions", "build_pull_plan",
    "edge_cut", "greedy_partition", "partition_report", "random_partition",
    "reverse_cuthill_mckee", "DATASETS", "community_powerlaw_graph",
    "make_dataset", "powerlaw_graph", "sbm_graph",
]
