"""Codec interface: what the data plane needs to know about a wire format.

A codec is three things at once:

  1. a **transform** -- ``encode(x) -> payload`` / ``decode(payload) -> x'``
     on real activation tensors (torch, on any device), with ``transcode`` as the
     round-trip the serving engine applies when a microbatch crosses a link;
  2. a **byte model** -- ``compressed_bytes(shape, dtype)`` is the exact
     on-wire size of one array, and ``wire_bytes(nbytes)`` is the analytic
     projection of that ratio onto the simulator's byte-counted boundaries
     (activations are f32 on the wire unless a codec says otherwise), which
     is what ``core.bottleneck.service_times`` charges the link;
  3. a **cost model** -- encode/decode flops per input byte, turned into
     seconds by the hosting node's ``flops_per_s``, charged to the link's
     serial window (the transfer occupies the link for
     ``encode + wire/bw + decode``).

``error_bound`` is the codec's reported worst-case round-trip error,
relative to ``max|x|`` over the tensor (0 for lossless).  It is the single
number the planner's ``accuracy_tolerance`` check consumes -- for ``int8``
it is literally the bound the quantize-kernel tests assert
(``repro_torch.kernels.quantize.INT8_MAX_REL_ERROR``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Sequence

F32_BYTES = 4.0  # the simulator's byte model: f32 activations on the wire


@dataclasses.dataclass
class EncodedActivation:
    """A still-encoded boundary activation handed to a receiving stage.

    When the receiving stage's executor advertises a fused decode for the
    link's codec (``executor.fused_codecs``), the engine skips the eager
    ``decode`` half of ``transcode`` and passes the wire payload through --
    the stage's first op consumes it directly (e.g. int8 ->
    ``kernels.quantize.dequant_matmul``).  ``decode()`` is the always-correct
    fallback for any consumer that needs the plain array."""

    codec: "Codec"
    payload: Any

    def decode(self) -> Any:
        return self.codec.decode(self.payload)


class Codec:
    """One inter-stage transfer wire format.  Subclass and register with
    ``@register_codec(name)``; override the transform and the byte model."""

    name: str = "?"
    error_bound: float = 0.0  # max |roundtrip - x| / max|x| (0 = lossless)
    encode_flops_per_byte: float = 0.0
    decode_flops_per_byte: float = 0.0

    # -- transform -----------------------------------------------------------
    def encode(self, x: Any) -> Any:
        raise NotImplementedError

    def decode(self, payload: Any) -> Any:
        raise NotImplementedError

    def transcode(self, x: Any) -> Any:
        """decode(encode(x)): what a receiver sees.  The serving engine
        applies this when a transfer completes, so lossy codecs really do
        alter the activations flowing through the pipeline."""
        return self.decode(self.encode(x))

    def configured(self, **attrs: Any) -> "Codec":
        """A shallow copy with ``attrs`` overridden (e.g. the
        deployment's ``device``).  The registry's singletons stay
        untouched; unknown attributes are rejected so a typo can't silently
        configure nothing."""
        for k in attrs:
            if not hasattr(self, k):
                raise AttributeError(f"codec {self.name!r} has no attribute {k!r}")
        dup = copy.copy(self)
        for k, v in attrs.items():
            setattr(dup, k, v)
        return dup

    # -- byte model ----------------------------------------------------------
    def wire_ratio(self, elem_bytes: float = F32_BYTES) -> float:
        """On-wire bytes per input byte for ``elem_bytes``-wide elements."""
        raise NotImplementedError

    def wire_bytes(self, nbytes: float, elem_bytes: float = F32_BYTES) -> float:
        """Analytic on-wire size of an ``nbytes`` boundary transfer."""
        return float(nbytes) * self.wire_ratio(elem_bytes)

    def compressed_bytes(self, shape: Sequence[int], dtype: Any = None) -> int:
        """Exact on-wire size of one array (measured layout, not the analytic
        ratio).  Default derives from ``wire_ratio``; codecs with per-block
        sidecars (scales, indices) override with the real layout math."""
        elem = _itemsize(dtype)
        n = math.prod(shape)
        return int(math.ceil(n * elem * self.wire_ratio(elem)))

    # -- cost model ----------------------------------------------------------
    def encode_cost_s(self, nbytes: float, flops_per_s: float) -> float:
        """Seconds the sender spends encoding an ``nbytes`` boundary."""
        if flops_per_s is None or flops_per_s <= 0:
            return 0.0
        return float(nbytes) * self.encode_flops_per_byte / float(flops_per_s)

    def decode_cost_s(self, nbytes: float, flops_per_s: float) -> float:
        """Seconds the receiver spends decoding back to ``nbytes``."""
        if flops_per_s is None or flops_per_s <= 0:
            return 0.0
        return float(nbytes) * self.decode_flops_per_byte / float(flops_per_s)

    def __repr__(self) -> str:
        return f"<codec {self.name}>"


def _itemsize(dtype: Any) -> float:
    """Bytes per element of ``dtype`` (a torch dtype, a numpy dtype or
    scalar type; default f32) without importing numpy at module scope."""
    if dtype is None:
        return F32_BYTES
    size = getattr(dtype, "itemsize", None)
    if not isinstance(size, int):  # a scalar *type* like np.float32
        import numpy as np

        size = np.dtype(dtype).itemsize
    return float(size)
