"""Optimizer: AdamW, schedules, clipping, written by hand after the JAX package."""

from .adamw import AdamWState, adamw_init, adamw_update, global_norm  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
