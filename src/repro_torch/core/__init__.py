from repro_torch.core import (comm_model, faults, halo_exchange, predictor,
                              serving)
from repro_torch.core.async_engine import (AsyncSettings, digest_a_train,
                                           store_geometry,
                                           sync_time_per_round)
from repro_torch.core.comm_model import (CommConstants, epoch_comm_bytes,
                                         epoch_time_model, khop_halo_sizes)
from repro_torch.core.digest import (MODES, TrainSettings,
                                     check_collective_geometry,
                                     check_worklist_geometry, digest_train,
                                     empty_halo_struct, evaluate,
                                     full_graph_forward, gat_projected,
                                     gather_state, init_sampled_state,
                                     init_state, make_epoch_fn,
                                     make_sampled_epoch_fn,
                                     make_subgraph_loss, prepare_graph_data,
                                     project_store_tables, sampled_train,
                                     shard_batch, shard_data, shard_state,
                                     top_layer_reps)
from repro_torch.core.error_bound import (measure_error_and_bound,
                                          quantization_eps)
from repro_torch.core.faults import (FaultConfig, FaultSchedule,
                                     attach_fault_state, measured_staleness)
from repro_torch.core.halo_exchange import HaloPrecision, HaloSpec
from repro_torch.core.predictor import PredictorConfig
from repro_torch.core.serving import (ServeConfig, ServePlan,
                                      build_serve_plan, init_serve_store,
                                      make_refresh_fn, place_serving,
                                      refresh_or_degrade, serve_query,
                                      serve_query_sharded)

__all__ = ["halo_exchange", "serving", "MODES", "TrainSettings",
           "check_worklist_geometry", "digest_train", "empty_halo_struct",
           "evaluate", "full_graph_forward", "gat_projected", "init_state",
           "make_epoch_fn", "make_subgraph_loss", "prepare_graph_data",
           "project_store_tables", "top_layer_reps", "HaloPrecision",
           "HaloSpec", "ServeConfig", "ServePlan", "build_serve_plan",
           "serve_query", "faults", "FaultConfig", "FaultSchedule",
           "attach_fault_state", "measured_staleness",
           "measure_error_and_bound", "quantization_eps", "predictor",
           "PredictorConfig", "comm_model", "CommConstants",
           "epoch_comm_bytes", "epoch_time_model", "khop_halo_sizes",
           "init_sampled_state", "make_sampled_epoch_fn", "sampled_train",
           "AsyncSettings", "digest_a_train", "store_geometry",
           "sync_time_per_round", "init_serve_store", "make_refresh_fn",
           "refresh_or_degrade", "check_collective_geometry",
           "serve_query_sharded", "shard_data", "shard_state",
           "shard_batch", "gather_state", "place_serving"]
