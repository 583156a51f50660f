"""SEIFER core: DNN partitioning + placement for max-throughput inference.

Exports resolve lazily (PEP 562): ``from repro_torch.core import CommGraph`` works
as before, but importing a leaf like ``repro_torch.core.registry`` no longer drags
in the whole algorithm stack.  That laziness is load-bearing -- the shared
registry helper lives here and is imported by ``repro_torch.api.registry``, which
the algorithm modules import back to self-register; an eager ``__init__``
would close that loop into a circular import.
"""

_SUBMODULE_EXPORTS = {
    "bottleneck": ("PipelineMetrics", "evaluate_pipeline", "link_latencies"),
    "graph": (
        "Layer",
        "LayerGraph",
        "Partition",
        "boundary_bytes",
        "chain",
        "make_partitions",
    ),
    "joint": ("JointResult", "joint", "sequential"),
    "partitioner": (
        "PartitionResult",
        "partition_exact_k",
        "partition_exhaustive",
        "partition_fewest_parts",
        "partition_min_bottleneck",
        "partition_min_sum",
        "partition_paper_greedy",
    ),
    "placement": (
        "CommGraph",
        "PlacementResult",
        "place_brute_force",
        "place_color_coding",
        "place_greedy",
        "place_hierarchical",
        "place_optimal",
        "place_random",
        "quantize_bandwidths",
    ),
}

_NAME_TO_MODULE = {
    name: mod for mod, names in _SUBMODULE_EXPORTS.items() for name in names
}

__all__ = sorted(_NAME_TO_MODULE)


def __getattr__(name):
    mod = _NAME_TO_MODULE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value  # cache: subsequent lookups skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
