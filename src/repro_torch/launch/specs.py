"""Shape-only stand-ins for every model input, param, state and cache tree.

The JAX package's ``launch/specs.py`` in PyTorch.  Where the JAX package
takes ``jax.eval_shape`` of its initializers, this runs the port's own
initializers on the meta device: the same code path, so the trees, shapes
and dtypes always match the real ones, with no storage and no draws.
kimi-k2's trillion parameters build in well under a second.

``input_specs`` returns the batch tree for an (arch, shape) cell;
``param_specs`` / ``state_specs`` / ``cache_specs`` the others.  Every
leaf is a meta tensor (``pos`` of a cache tree stays the Python int 0).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.runtime import train as train_lib

META = torch.device("meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Batch tree of meta tensors for this cell."""
    b = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": torch.empty((b, 1), dtype=torch.int32, device=META)}
    s = shape.seq_len
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    if cfg.family == "audio":
        batch["frames"] = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16, device=META)
    if cfg.family == "vlm":
        batch["patches"] = torch.empty((b, lm.PATCH_TOKENS, lm.PATCH_DIM),
                                       dtype=torch.bfloat16, device=META)
    return batch


def max_pos_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    return shape.seq_len if cfg.family == "audio" else 32768


def param_specs(cfg: ModelConfig, shape: ShapeConfig):
    return lm.init_params(cfg, None, device=META, max_pos=max_pos_for(cfg, shape))


def state_specs(cfg: ModelConfig, shape: ShapeConfig):
    return train_lib.init_state(cfg, param_specs(cfg, shape))


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    return lm.init_caches(cfg, shape.global_batch, shape.seq_len, enc_len=shape.seq_len,
                          device=META)
