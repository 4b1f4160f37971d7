"""Port of ``repro/data``: the deterministic, shardable token streams."""
from repro_torch.data.pipeline import (Batcher, DataConfig, SyntheticLMDataset,
                                       TokenFileDataset, make_dataset)

__all__ = ["DataConfig", "SyntheticLMDataset", "TokenFileDataset",
           "make_dataset", "Batcher"]
