"""Bandwidth-aware activation data plane: pluggable inter-stage codecs.

SEIFER pipelines on edge networks are link-bound -- the inter-partition
activation transfer, not compute, sets the bottleneck period -- and the
companion DEFER paper shows lossy activation compression is the lever that
restores throughput.  This package is that lever as a subsystem:

  * ``registry`` -- ``@register_codec`` named-codec registry with
    did-you-mean errors (mirrors ``repro_torch.api.registry``);
  * ``base``     -- the ``Codec`` interface: real encode/decode transforms,
    an exact ``compressed_bytes(shape, dtype)`` layout model, the analytic
    ``wire_bytes`` ratio the byte-counted simulator charges, and an
    encode/decode compute-cost model;
  * ``codecs``   -- ``identity`` / ``fp16`` / ``int8`` (backed by the
    ``kernels/quantize`` CUDA kernels) / ``topk-sparse``, fp16 and
    topk-sparse as plain torch ops on the tensor's device;
  * ``auto``     -- per-link codec selection under a per-link
    ``accuracy_tolerance``, used by the planner's joint codec x placement
    search and provably never worse than ``identity``.

The codec names flow spec -> plan -> pipeline -> engine: the planner picks
(or is told) a codec per link, ``core.bottleneck.service_times`` charges
``encode + transfer(compressed) + decode`` to the link's serial window, and
the serving engine applies the real transform to every microbatch crossing
that link -- where the int8 quantize kernel joins the serving path.
"""

from repro_torch.dataplane.auto import (
    assign_link_codecs,
    link_charge_s,
    resolve_codecs,
    select_codec,
)
from repro_torch.dataplane.base import Codec
from repro_torch.dataplane.registry import (
    AUTO,
    UnknownCodecError,
    codec_table,
    default_codec,
    get_codec,
    list_codecs,
    register_codec,
)

__all__ = [
    "AUTO",
    "Codec",
    "UnknownCodecError",
    "assign_link_codecs",
    "codec_table",
    "default_codec",
    "get_codec",
    "link_charge_s",
    "list_codecs",
    "register_codec",
    "resolve_codecs",
    "select_codec",
]
