"""Placement of the port's tensors over a ``DeviceMesh`` by the
reference's logical axis rules (:mod:`.sharding`)."""
from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                              EXPERT_PARALLEL_RULES, cut,
                                              init_sharded, local_bytes,
                                              map_placed, merged_rules,
                                              mesh_sizes, placements,
                                              resolve, shard_cache,
                                              shard_params)

__all__ = ["DEFAULT_RULES", "EXPERT_PARALLEL_RULES", "cut", "init_sharded",
           "local_bytes", "map_placed", "merged_rules", "mesh_sizes",
           "placements", "resolve", "shard_cache", "shard_params"]
