from repro_torch.core import halo_exchange, serving
from repro_torch.core.digest import (empty_halo_struct, evaluate,
                                     full_graph_forward, prepare_graph_data,
                                     top_layer_reps)
from repro_torch.core.halo_exchange import HaloPrecision
from repro_torch.core.serving import (ServeConfig, ServePlan,
                                      build_serve_plan, serve_query)

__all__ = ["halo_exchange", "serving", "empty_halo_struct", "evaluate",
           "full_graph_forward", "prepare_graph_data", "top_layer_reps",
           "HaloPrecision", "ServeConfig", "ServePlan", "build_serve_plan",
           "serve_query"]
