"""Layer-graph abstraction consumed by the SEIFER partitioner.

The paper treats a DNN as a chain of layers; each inter-layer edge carries
the activation bytes produced by the earlier layer.  ``LayerGraph`` captures
exactly the three quantities the partitioning/placement algorithms need:

  * ``param_bytes``  -- memory the layer occupies on a device (weights),
  * ``out_bytes``    -- activation bytes sent to the *next* layer (edge weight),
  * ``flops``        -- compute cost (used by the beyond-paper joint objective).

All SEIFER algorithms are architecture-agnostic: any model that can export a
``LayerGraph`` (CNNs for the paper's own evaluation, every assigned LM arch
via ``models/graph_export.py``) is partitionable.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class Layer:
    """One node in the chain."""

    name: str
    param_bytes: int
    out_bytes: int  # activation bytes handed to the next layer
    flops: int = 0

    def __post_init__(self) -> None:
        if self.param_bytes < 0 or self.out_bytes < 0 or self.flops < 0:
            raise ValueError(f"layer {self.name!r}: negative size")


@dataclasses.dataclass(frozen=True)
class LayerGraph:
    """A chain-structured DNN graph.

    ``layers[i].out_bytes`` is the weight of the edge (i, i+1).  The final
    layer's ``out_bytes`` is the model *output* size (used only when the
    dispatcher round-trip is included in the bottleneck metric).
    """

    name: str
    layers: tuple[Layer, ...]
    in_bytes: int = 0  # model input size (dispatcher -> first partition)

    def __post_init__(self) -> None:
        if not self.layers:
            raise ValueError("LayerGraph needs at least one layer")

    # -- basic accessors -------------------------------------------------
    def __len__(self) -> int:
        return len(self.layers)

    @property
    def total_param_bytes(self) -> int:
        return sum(l.param_bytes for l in self.layers)

    @property
    def total_flops(self) -> int:
        return sum(l.flops for l in self.layers)

    def edge_bytes(self, i: int) -> int:
        """Activation bytes crossing the cut between layer i and i+1."""
        if not 0 <= i < len(self.layers) - 1:
            raise IndexError(f"edge {i} out of range for {len(self.layers)} layers")
        return self.layers[i].out_bytes

    @property
    def edges(self) -> tuple[int, ...]:
        """All inter-layer edge weights (len == n_layers - 1)."""
        return tuple(l.out_bytes for l in self.layers[:-1])

    # -- partition helpers ------------------------------------------------
    def segment_param_bytes(self, start: int, stop: int) -> int:
        """Parameter bytes of the contiguous segment layers[start:stop]."""
        return sum(l.param_bytes for l in self.layers[start:stop])

    def segment_flops(self, start: int, stop: int) -> int:
        return sum(l.flops for l in self.layers[start:stop])

    def prefix_param_bytes(self) -> list[int]:
        """prefix[i] = sum of param_bytes of layers[:i]; len == n+1."""
        acc, out = 0, [0]
        for l in self.layers:
            acc += l.param_bytes
            out.append(acc)
        return out

    def prefix_flops(self) -> list[int]:
        acc, out = 0, [0]
        for l in self.layers:
            acc += l.flops
            out.append(acc)
        return out


@dataclasses.dataclass(frozen=True)
class Partition:
    """A contiguous slice [start, stop) of the layer chain."""

    start: int
    stop: int
    param_bytes: int
    flops: int
    out_bytes: int  # bytes sent to the next partition (0 for the last)

    @property
    def n_layers(self) -> int:
        return self.stop - self.start


def make_partitions(graph: LayerGraph, cuts: Sequence[int]) -> tuple[Partition, ...]:
    """Materialize partitions from sorted cut points.

    ``cuts`` are layer indices i meaning "cut the edge between layer i and
    layer i+1"; e.g. cuts=[2, 5] over 8 layers yields [0:3), [3:6), [6:8).
    """
    n = len(graph)
    cuts = sorted(cuts)
    if any(not 0 <= c < n - 1 for c in cuts):
        raise ValueError(f"cut out of range: {cuts} for {n} layers")
    if len(set(cuts)) != len(cuts):
        raise ValueError(f"duplicate cuts: {cuts}")
    bounds = [0] + [c + 1 for c in cuts] + [n]
    parts = []
    for s, e in zip(bounds[:-1], bounds[1:]):
        parts.append(
            Partition(
                start=s,
                stop=e,
                param_bytes=graph.segment_param_bytes(s, e),
                flops=graph.segment_flops(s, e),
                out_bytes=graph.layers[e - 1].out_bytes if e < n else 0,
            )
        )
    return tuple(parts)


def boundary_bytes(parts: Sequence[Partition]) -> tuple[int, ...]:
    """Bytes crossing each of the k-1 partition boundaries."""
    return tuple(p.out_bytes for p in parts[:-1])


def chain(name: str, sizes: Iterable[tuple[int, int]], in_bytes: int = 0) -> LayerGraph:
    """Convenience constructor from (param_bytes, out_bytes) pairs."""
    layers = tuple(
        Layer(name=f"{name}.{i}", param_bytes=p, out_bytes=o)
        for i, (p, o) in enumerate(sizes)
    )
    return LayerGraph(name=name, layers=layers, in_bytes=in_bytes)
