"""The paper's own experiment config: distributed GCN under DIGEST.

Mirrors §5.1: Adam, METIS-style partitioning, M=8 subgraphs (8 GPUs),
sync interval N=10 (the paper's best on OGB-Products, Fig. 6).  A copy of
``src/repro/configs/digest_gcn.py``.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GNNExperiment:
    dataset: str = "products-sim"
    model: str = "gcn"
    num_layers: int = 3
    hidden_dim: int = 128
    num_parts: int = 8
    partitioner: str = "greedy"
    sync_interval: int = 10
    learning_rate: float = 5e-3
    epochs: int = 200
    heads: int = 1


CONFIG = GNNExperiment()
SMOKE = dataclasses.replace(CONFIG, dataset="flickr-sim", hidden_dim=32,
                            num_parts=4, epochs=20)
