from repro_torch.data.pipeline import (SyntheticLMDataset, TokenBatch,
                                       make_lm_pipeline)

__all__ = ["SyntheticLMDataset", "TokenBatch", "make_lm_pipeline"]
