"""The paper's GNN experiment configs (copies of the reference's)."""
