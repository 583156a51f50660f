"""Blockwise int8 round trip of an activation, as the reference needs it.

Frozen copy of ``quantize_ref`` and ``dequantize_ref`` of
``src/repro_torch/kernels/quantize/ref.py`` at commit f4e3f2d, cut to the
f32 round trip: each ``block``-wide slice of the trailing dim gets the
scale ``max|x| * f32(1/127)`` and the codes
``clip(round(x / max(scale, 1e-12)), -127, 127)`` (``torch.round`` rounds
half to even); decoding multiplies the codes by their block's scale.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_trip(x: torch.Tensor, block: int) -> torch.Tensor:
    """dequantize(quantize(x)) in f32, with the trailing dim zero-padded to a
    block multiple while it is coded (padding never raises a block's max)."""
    *lead, d = x.shape
    nb = -(-d // block)
    xp = F.pad(x.to(torch.float32), (0, nb * block - d)) if nb * block != d else x.float()
    xb = xp.reshape(*lead, nb, block)
    scale = xb.abs().amax(dim=-1) * (1.0 / 127.0)
    safe = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xb / safe[..., None]), -127, 127)
    return (q * scale[..., None]).reshape(*lead, nb * block)[..., :d]
