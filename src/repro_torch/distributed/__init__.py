"""Placement of the port's tensors over a ``DeviceMesh`` by the
reference's logical axis rules (:mod:`.sharding`)."""
from repro_torch.distributed.sharding import (DEFAULT_RULES,
                                              EXPERT_PARALLEL_RULES,
                                              TRAIN_RULES, LeafGroups, cut,
                                              gather_whole, init_sharded,
                                              leaf_groups, local_bytes,
                                              map_placed, merged_rules,
                                              mesh_sizes, opt_state_specs,
                                              placements, resolve,
                                              shard_cache, shard_params,
                                              train_state_specs)

__all__ = ["DEFAULT_RULES", "EXPERT_PARALLEL_RULES", "TRAIN_RULES",
           "LeafGroups", "cut", "gather_whole", "init_sharded",
           "leaf_groups", "local_bytes", "map_placed", "merged_rules",
           "mesh_sizes", "opt_state_specs", "placements", "resolve",
           "shard_cache", "shard_params", "train_state_specs"]
