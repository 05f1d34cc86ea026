"""Logical-axis → mesh-axis sharding rules (FSDP/TP), and the explicit
form of the sharded execution that GSPMD gives the reference."""

from .rules import (  # noqa: F401
    ACT_RULES,
    PARAM_RULES,
    batch_pspec,
    cache_pspecs,
    fit_pspec,
    param_pspecs,
)
