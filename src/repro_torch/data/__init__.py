"""Data pipeline: the deterministic synthetic LM stream and its loader."""
from repro_torch.data.pipeline import (DataConfig, ShardedLoader,
                                       SyntheticLMDataset, make_loader)

__all__ = ["DataConfig", "SyntheticLMDataset", "ShardedLoader", "make_loader"]
