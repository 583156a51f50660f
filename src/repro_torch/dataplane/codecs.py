"""The built-in inter-stage transfer codecs.

Each is registered by name so ``DeploymentSpec(codec=...)`` can put any of
them on a link:

  =============  ========  ============  =======================================
  codec          ~ratio    error bound   mechanism
  =============  ========  ============  =======================================
  identity       1.000     0 (lossless)  raw f32 bytes
  fp16           0.500     2^-11         float16 truncation (byte model only)
  int8           0.254     1/254         blockwise int8 (``kernels/quantize``:
                                         the CUDA kernels on a CUDA tensor,
                                         the plain version on a CPU tensor)
  topk-sparse    0.500     1 (unbounded) top-25% magnitudes (byte model only)
  =============  ========  ============  =======================================

Ratios are for f32 activations.  Transforms take and return torch tensors
on the tensor's own device.  ``fp16`` and ``topk-sparse`` keep their byte
and cost model (the planner may score them) but their transforms are not
ported yet and raise ``NotImplementedError`` when a link carries data.
"""

from __future__ import annotations

import math

import torch

from repro_torch.dataplane.base import Codec, _itemsize
from repro_torch.dataplane.registry import register_codec
from repro_torch.kernels.quantize import INT8_MAX_REL_ERROR, dequantize_int8, quantize_int8


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
    """float16 truncation: half the bytes at ~2^-11 relative error."""

    F16_MAX = 65504.0
    error_bound = 2.0 ** -11
    encode_flops_per_byte = 0.25  # one convert per f32 element
    decode_flops_per_byte = 0.25

    def encode(self, x):
        raise NotImplementedError("the fp16 transform is not ported yet")

    def decode(self, payload):
        raise NotImplementedError("the fp16 transform is not ported yet")

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
        if self.device is not None:
            want = torch.device(self.device)
            if x.device.type != want.type or (
                    want.index is not None and x.device.index != want.index):
                raise ValueError(f"int8 codec configured for {self.device} got a "
                                 f"tensor on {x.device}")
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

    def _k(self, n: int) -> int:
        return max(1, int(math.ceil(self.keep_frac * n)))

    def encode(self, x):
        raise NotImplementedError("the topk-sparse transform is not ported yet")

    def decode(self, payload):
        raise NotImplementedError("the topk-sparse transform is not ported yet")

    def wire_ratio(self, elem_bytes: float = 4.0) -> float:
        return self.keep_frac * (elem_bytes + 4.0) / elem_bytes

    def compressed_bytes(self, shape, dtype=None) -> int:
        k = self._k(int(math.prod(shape)))
        return int(k * (_itemsize(dtype) + 4.0))
