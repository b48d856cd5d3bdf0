"""Deterministic, shardable data pipeline with checkpointable iterator state."""
from repro_torch.data.pipeline import (DataConfig, TokenDataset, make_batches,
                                       synthetic_dataset)

__all__ = ["DataConfig", "TokenDataset", "make_batches", "synthetic_dataset"]
