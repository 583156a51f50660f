"""Edge-cluster bridge: per-layer callables as one cluster ``ExecutorFn``."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.dataplane.base import EncodedActivation


def make_layer_executor(layer_fns: list[Callable[[torch.Tensor], torch.Tensor]]):
    """Adapt per-layer callables into the cluster ``ExecutorFn`` signature.

    The edge control plane's ``InferencePipeline`` drives pods with
    ``executor(start, stop, x)`` over the partition's layer range.

    **Fused decode protocol.**  A layer fn may carry a ``fused`` attribute --
    a ``{codec_name: handler}`` dict whose handler consumes a still-encoded
    boundary activation (``dataplane.base.EncodedActivation``) directly,
    e.g. int8 wire payloads feeding ``kernels.quantize.dequant_matmul``
    instead of a separate dequantize pass.  The executor advertises
    ``executor.fused_codecs`` -- codec names EVERY layer can consume, so the
    engine's gating stays correct for any partition cut point -- and
    falls back to ``EncodedActivation.decode()`` when the entry layer has no
    handler.
    """
    fused_codecs: frozenset[str] | None = None
    for fn in layer_fns:
        keys = frozenset(getattr(fn, "fused", {}) or {})
        fused_codecs = keys if fused_codecs is None else fused_codecs & keys

    def executor(start: int, stop: int, x):
        if isinstance(x, EncodedActivation):
            handler = None
            if start < stop:
                handler = getattr(layer_fns[start], "fused", {}).get(x.codec.name)
            if handler is not None:
                x = handler(x)
                start += 1
            else:
                x = x.decode()
        for i in range(start, stop):
            x = layer_fns[i](x)
        return x

    executor.fused_codecs = fused_codecs or frozenset()
    return executor
