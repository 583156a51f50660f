"""Sharding policies of the LM zoo as DTensor placements (``policy.py``)."""

from repro_torch.sharding.policy import (
    ShardingPolicy,
    batch_axes,
    batch_pspec,
    batch_shardings,
    cache_shardings,
    param_shardings,
    place,
    placements,
    state_shardings,
)

__all__ = [
    "ShardingPolicy",
    "batch_axes",
    "batch_pspec",
    "batch_shardings",
    "cache_shardings",
    "param_shardings",
    "place",
    "placements",
    "state_shardings",
]
