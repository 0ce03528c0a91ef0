from repro_torch.models.gnn import (GNN, GNNConfig, gnn_forward, gnn_layer,
                                    gnn_specs)

__all__ = ["GNN", "GNNConfig", "gnn_forward", "gnn_layer", "gnn_specs"]
