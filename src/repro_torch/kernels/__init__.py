"""Hand-written Hopper kernels, their wrappers, and their plain PyTorch versions."""

from . import ops, ref  # noqa: F401
