from repro_torch.models.gnn import (GNN, GNNConfig, gnn_forward,
                                    gnn_forward_sampled, gnn_layer,
                                    gnn_specs)

__all__ = ["GNN", "GNNConfig", "gnn_forward", "gnn_forward_sampled",
           "gnn_layer", "gnn_specs"]
