"""Data pipeline: deterministic synthetic token streams, sharded per host."""

from .pipeline import SyntheticLMDataset, make_batch_iterator  # noqa: F401
