"""The deterministic synthetic LM data pipeline, a copy of
``repro.data`` (numpy only): batches are numpy arrays and the caller
moves them to its device."""
from .pipeline import SyntheticLM, DataConfig, make_batch_iterator

__all__ = ["SyntheticLM", "DataConfig", "make_batch_iterator"]
