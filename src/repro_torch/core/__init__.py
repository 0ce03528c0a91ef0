from repro_torch.core import halo_exchange, serving
from repro_torch.core.digest import (MODES, TrainSettings,
                                     check_worklist_geometry, digest_train,
                                     empty_halo_struct, evaluate,
                                     full_graph_forward, gat_projected,
                                     init_state, make_epoch_fn,
                                     make_subgraph_loss, prepare_graph_data,
                                     project_store_tables, top_layer_reps)
from repro_torch.core.halo_exchange import HaloPrecision, HaloSpec
from repro_torch.core.serving import (ServeConfig, ServePlan,
                                      build_serve_plan, serve_query)

__all__ = ["halo_exchange", "serving", "MODES", "TrainSettings",
           "check_worklist_geometry", "digest_train", "empty_halo_struct",
           "evaluate", "full_graph_forward", "gat_projected", "init_state",
           "make_epoch_fn", "make_subgraph_loss", "prepare_graph_data",
           "project_store_tables", "top_layer_reps", "HaloPrecision",
           "HaloSpec", "ServeConfig", "ServePlan", "build_serve_plan",
           "serve_query"]
