"""Joint codec-per-link selection (the data plane's planning half).

The timing model charges a link's serial window with

    encode(raw bytes on the sender) + wire_bytes / bandwidth + decode(raw
    bytes on the receiver)

so each hop's charge depends only on its *own* codec -- which makes the
per-link optimum exact and cheap: for every hop, pick the admissible codec
(``error_bound <= accuracy_tolerance``) minimizing the charged window, with
lossless-first tie-breaking.  Because ``identity`` (error 0) is always
admissible, ``codec="auto"`` can never predict worse than the uncompressed
plan, and because every candidate's window is non-increasing in bandwidth,
predicted throughput stays monotone in link bandwidth -- both properties are
pinned by ``tests/test_dataplane_properties.py``.

Hop indexing matches ``core.bottleneck.service_times``: hop 0 is the
dispatcher -> first-stage input, hop h (1 <= h <= k-1) the stage h-1 ->
stage h boundary, hop k the last-stage -> dispatcher output.  The dispatcher
round-trip hops always ride ``identity`` -- codecs compress *inter-stage*
activations; the request/response payload belongs to the client.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.bottleneck import node_flops
from repro_torch.dataplane.base import Codec
from repro_torch.dataplane.registry import AUTO, default_codec, get_codec, list_codecs


def resolve_codecs(codecs) -> list[Codec] | None:
    """Names-or-instances -> instances (None passes through)."""
    if codecs is None:
        return None
    return [c if isinstance(c, Codec) else get_codec(c) for c in codecs]


def link_charge_s(
    codec: Codec,
    nbytes: float,
    bw: float,
    *,
    src_flops: float = 0.0,
    dst_flops: float = 0.0,
) -> float:
    """The serial window one ``nbytes`` transfer occupies on the link."""
    if nbytes <= 0:
        return 0.0
    wire = codec.wire_bytes(nbytes)
    xfer = float("inf") if bw <= 0 else wire / bw
    return codec.encode_cost_s(nbytes, src_flops) + xfer + \
        codec.decode_cost_s(nbytes, dst_flops)


def select_codec(
    nbytes: float,
    bw: float,
    *,
    tolerance: float | None = None,
    src_flops: float = 0.0,
    dst_flops: float = 0.0,
    candidates: Sequence[str] | None = None,
) -> str:
    """The admissible codec with the smallest charged window on this link.

    Ties break toward the smaller error bound (then the name), so a link
    fast enough that compression buys nothing stays lossless.
    """
    names = list(candidates) if candidates is not None else list(list_codecs())
    best: tuple[float, float, str] | None = None
    for name in names:
        codec = get_codec(name)
        if tolerance is not None and codec.error_bound > tolerance:
            continue
        key = (
            link_charge_s(codec, nbytes, bw,
                          src_flops=src_flops, dst_flops=dst_flops),
            codec.error_bound,
            name,
        )
        if best is None or key < best:
            best = key
    if best is None:  # every candidate over tolerance: fall back to lossless
        return default_codec()
    return best[2]


def assign_link_codecs(
    hop_bytes: Sequence[float],
    path: Sequence[int],
    bw: np.ndarray,
    *,
    codec: str | None = None,
    tolerance: float | None = None,
    flops_per_node=None,
    dispatcher: int | None = None,
    compression_ratio: float = 1.0,
) -> tuple[str, ...]:
    """One codec name per hop (``len(path) + 1`` entries).

    ``codec`` is a registered name (every inter-stage hop uses it), ``"auto"``
    (per-hop optimum as above), or ``None`` (the registry default,
    ``identity``).  ``hop_bytes`` are the *raw* boundary bytes in hop order;
    the legacy ``compression_ratio`` is applied before the codec, matching
    ``service_times``.
    """
    k = len(path)
    if len(hop_bytes) != k + 1:
        raise ValueError(f"expected {k + 1} hop byte counts, got {len(hop_bytes)}")
    if codec is None:
        codec = default_codec()
    names: list[str] = []
    for h in range(k + 1):
        src = dispatcher if h == 0 else path[h - 1]
        dst = dispatcher if h == k else path[h]
        interior = 1 <= h <= k - 1
        if not interior:
            names.append(default_codec())  # dispatcher round-trip: raw
            continue
        if codec != AUTO:
            names.append(codec)
            continue
        raw = float(hop_bytes[h]) / compression_ratio
        if raw <= 0 or src is None or dst is None or src == dst:
            names.append(default_codec())  # nothing crosses a wire here
            continue
        names.append(select_codec(
            raw, float(bw[src, dst]),
            tolerance=tolerance,
            src_flops=node_flops(flops_per_node, src),
            dst_flops=node_flops(flops_per_node, dst),
        ))
    return tuple(names)
