"""Checkpointing: atomic, integrity-checked, in the JAX package's format."""

from .ckpt import CheckpointManager, load_checkpoint, save_checkpoint  # noqa: F401
