"""The synthetic LM data stream (port of ``src/repro/data``)."""
from repro_torch.data.pipeline import SyntheticTextDataset, make_train_iterator

__all__ = ["SyntheticTextDataset", "make_train_iterator"]
