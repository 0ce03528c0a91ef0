"""The paper's GAT experiment config (§5, Table 1 right half); a copy of
``src/repro/configs/digest_gat.py``."""
import dataclasses

from repro_torch.configs.digest_gcn import GNNExperiment

CONFIG = GNNExperiment(model="gat", heads=4, hidden_dim=128,
                       learning_rate=5e-3)
SMOKE = dataclasses.replace(CONFIG, dataset="flickr-sim", hidden_dim=32,
                            num_parts=4, epochs=20)
