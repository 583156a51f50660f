"""The built-in inter-stage transfer codecs.

Each is registered by name so ``DeploymentSpec(codec=...)`` can put any of
them on a link:

  =============  ========  ============  =======================================
  codec          ~ratio    error bound   mechanism
  =============  ========  ============  =======================================
  identity       1.000     0 (lossless)  raw f32 bytes
  fp16           0.500     2^-11         float16 rounding (clamped to +-65504)
  int8           0.254     1/254         blockwise int8 (``kernels/quantize``:
                                         the CUDA kernels on a CUDA tensor,
                                         the plain version on a CPU tensor)
  topk-sparse    0.500     1 (unbounded) top-25% magnitudes as (index, value)
  =============  ========  ============  =======================================

Ratios are for f32 activations.  Transforms take and return torch tensors
on the tensor's own device: fp16 and topk-sparse are plain torch ops there
(XLA ops in the JAX package, not Pallas kernels), int8 runs the CUDA
kernels on a CUDA tensor.  Each lossy codec has a ``device`` attribute:
``configured(device=...)`` pins a copy to the deployment's device, and that
copy refuses a tensor on any other device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.dataplane.base import Codec, _itemsize
from repro_torch.dataplane.registry import register_codec
from repro_torch.kernels.quantize import INT8_MAX_REL_ERROR, dequantize_int8, quantize_int8


def _check_device(codec: Codec, x: torch.Tensor) -> None:
    """Refuse ``x`` unless it lies on ``codec.device`` (None accepts any)."""
    if codec.device is None:
        return
    want = torch.device(codec.device)
    if x.device.type != want.type or (
            want.index is not None and x.device.index != want.index):
        raise ValueError(f"{codec.name} codec configured for {codec.device} got a "
                         f"tensor on {x.device}")


@register_codec("identity", default=True)
class IdentityCodec(Codec):
    """Raw activations on the wire; the no-compression baseline."""

    def encode(self, x):
        return x

    def decode(self, payload):
        return payload

    def transcode(self, x):
        return x

    def wire_ratio(self, elem_bytes: float = 4.0) -> float:
        return 1.0


@register_codec("fp16")
class Fp16Codec(Codec):
    """float16 rounding: half the bytes at ~2^-11 relative error.

    The bound holds within float16's finite range (|x| <= 65504); larger
    values are clamped to the range edge on encode, never inf.  The cast
    rounds to nearest even, as the JAX package's does, so the codes are
    the same bits."""

    F16_MAX = 65504.0
    error_bound = 2.0 ** -11
    encode_flops_per_byte = 0.25  # one convert per f32 element
    decode_flops_per_byte = 0.25
    device = None  # as Int8Codec.device

    def encode(self, x: torch.Tensor):
        _check_device(self, x)
        return x.clamp(-self.F16_MAX, self.F16_MAX).to(torch.float16), x.dtype

    def decode(self, payload):
        y, dtype = payload
        return y.to(dtype)

    def wire_ratio(self, elem_bytes: float = 4.0) -> float:
        return 2.0 / elem_bytes


@register_codec("int8")
class Int8Codec(Codec):
    """Blockwise symmetric int8 (``kernels/quantize``): 1 byte per element
    plus one f32 scale per ``block``; error <= scale/2 per element."""

    block = 256
    error_bound = INT8_MAX_REL_ERROR
    encode_flops_per_byte = 1.5  # abs/max-reduce/div/round/clip per element
    decode_flops_per_byte = 0.5  # mul + cast per element
    # the deployment's device (``configured(device=...)``): a pipeline's
    # codec refuses an activation on any other device, so a CPU tensor can
    # never slip onto a CUDA deployment's plain path.  None accepts any.
    device = None

    def encode(self, x: torch.Tensor):
        _check_device(self, x)
        q, s = quantize_int8(x, block=self.block)
        return "torch", q, s, x.dtype

    def decode(self, payload):
        _, q, s, dtype = payload
        return dequantize_int8(q, s, dtype=dtype, block=self.block)

    def wire_ratio(self, elem_bytes: float = 4.0) -> float:
        return (1.0 + 4.0 / self.block) / elem_bytes

    def compressed_bytes(self, shape, dtype=None) -> int:
        *lead, d = shape
        n_blocks = math.prod(lead) * -(-d // self.block)
        return int(math.prod(shape)) + 4 * int(n_blocks)


@register_codec("topk-sparse")
class TopKSparseCodec(Codec):
    """Magnitude top-k sparsification: the largest ``keep_frac`` of the
    elements as (int32 index, value) pairs, zeros elsewhere.  The reported
    error bound is 1.0 -- a dropped element can be as large as the kept
    threshold -- so ``auto`` only picks it when the tolerance says the
    caller genuinely does not care."""

    keep_frac = 0.25
    error_bound = 1.0
    encode_flops_per_byte = 4.0  # selection dominates
    decode_flops_per_byte = 0.25  # scatter into zeros
    device = None  # as Int8Codec.device

    def _k(self, n: int) -> int:
        return max(1, int(math.ceil(self.keep_frac * n)))

    def encode(self, x: torch.Tensor):
        _check_device(self, x)
        flat = x.reshape(-1)
        idx = torch.topk(flat.abs(), self._k(flat.numel()), sorted=False).indices
        return "torch", tuple(x.shape), x.dtype, idx.to(torch.int32), flat[idx]

    def decode(self, payload):
        _, shape, dtype, idx, vals = payload
        flat = torch.zeros(math.prod(shape), dtype=dtype, device=vals.device)
        flat[idx] = vals
        return flat.reshape(shape)

    def wire_ratio(self, elem_bytes: float = 4.0) -> float:
        return self.keep_frac * (elem_bytes + 4.0) / elem_bytes

    def compressed_bytes(self, shape, dtype=None) -> int:
        k = self._k(int(math.prod(shape)))
        return int(k * (_itemsize(dtype) + 4.0))
