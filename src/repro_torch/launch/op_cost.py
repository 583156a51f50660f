"""Op-level cost counting of one rank's work: FLOPs, bytes, collectives and
the peak of live bytes.

The counterpart of the JAX package's ``launch/hlo_cost.py`` (trip-count-
aware FLOPs and bytes of compiled HLO) and ``launch/hlo_stats.py``
(collective bytes of HLO).  The port has no HLO: ``OpCostMode`` is a
``TorchDispatchMode`` that counts the aten and custom ops a step runs, as
they run, on real or fake tensors.

  * **Local ops only.**  An op on DTensors is not counted; the ops DTensor
    runs on each rank's shards (and the collectives of its redistributes)
    are, so on a mesh the counts are rank 0's.  Nor is DTensor's own shape
    propagation, which runs every new op once on global-shaped fake tensors
    (``FlopCounterMode`` counts those too: a sharded matmul twice).
  * **FLOPs:** matmul-class ops at 2 |out| |contracted|
    (``torch.utils.flop_counter``'s formulas), plus each custom op's
    registered FLOPs (``kernels/library.OP_COSTS``: the LM kernels, whatever
    implements them).  Elementwise ops are not counted, as in ``hlo_cost``.
  * **Bytes:** each op's input and output tensors once.  Views and metadata
    ops count nothing (``hlo_cost``'s ``_NO_TRAFFIC``); a custom op counts
    its registered bytes.  Eager PyTorch fuses nothing, so these are the
    bytes of the ops the card runs, every intermediate written and read
    again: not comparable with XLA's count, whose fusions keep theirs on
    chip.
  * **Collectives:** the output bytes and count of each ``_c10d_functional``
    collective (and DTensor's ``shard_dim_alltoall``), under the JAX
    package's names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``).
  * **No trip counts:** every op that runs is counted, a loop's body as
    often as it runs.
  * **Memory** (``track_memory``): the peak of the bytes of live local
    storages, the ``external`` tensors (params, state, batch) included.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels.library import OP_COSTS

_COLLECTIVE_NAMES = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
                     ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"),
                     ("p2p", "collective-permute"), ("send", "collective-permute"),
                     ("recv", "collective-permute"))
# ops that allocate or describe and move nothing
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "detach", "lift_fresh", "sym_size", "sym_stride", "sym_numel",
               "sym_storage_offset", "is_contiguous", "_local_scalar_dense", "wait_tensor",
               "_unsafe_view"}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict[str, int]
    count_by_op: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def summary(self) -> str:
        parts = [
            f"{op}: {self.count_by_op[op]} ops, {self.bytes_by_op[op]/1e6:.1f} MB"
            for op in sorted(self.bytes_by_op)
        ]
        return "; ".join(parts) if parts else "none"


@dataclasses.dataclass
class OpCost:
    flops: float
    bytes: float
    collective_bytes: dict[str, float]
    collective_count: dict[str, float]
    flops_by_op: dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_op: dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def collective_stats(self) -> CollectiveStats:
        return CollectiveStats({k: int(v) for k, v in self.collective_bytes.items()},
                               {k: int(v) for k, v in self.collective_count.items()})


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


# the collectives' namespaces (DTensor's own all-to-all of one shard dim is
# ``_dtensor.shard_dim_alltoall``)
_C10D = ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional", "c10d", "_dtensor")


_COMPOSITE: dict = {}


def _composite(func) -> bool:
    """True for an op that is a composite of others (counted as those)."""
    if func not in _COMPOSITE:
        _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
    return _COMPOSITE[func]


def _collective(func) -> str | None:
    if func.namespace not in _C10D:
        return None
    name = func._schema.name.split("::")[-1]
    return next((kind for key, kind in _COLLECTIVE_NAMES if key in name), None)


class OpCostMode(TorchDispatchMode):
    """Count the local ops run under it (see the module docstring); read
    ``result()`` after.

        with OpCostMode(track_memory=True, external=(state, batch)) as m:
            step(state, batch)
        cost = m.result()
    """

    def __init__(self, *, track_memory: bool = False, external: Any = ()):
        super().__init__()
        self._propagating = 0
        self.flops_by_op: dict[str, float] = defaultdict(float)
        self.bytes_by_op: dict[str, float] = defaultdict(float)
        self.collective_bytes: dict[str, float] = defaultdict(float)
        self.collective_count: dict[str, float] = defaultdict(float)
        self.track_memory = track_memory
        self._live: dict[int, int] = {}  # storage key -> bytes
        self.live_bytes = 0
        self.peak_bytes = 0
        if track_memory:
            for t in _tensors(external):
                self._track(_local(t))

    # -- DTensor's shape propagation is not the rank's work ----------------
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._saved = ShardingPropagator._propagate_tensor_meta_non_cached
        mode, inner = self, self._saved

        def propagate(prop_self, op_schema):
            mode._propagating += 1
            try:
                return inner(prop_self, op_schema)
            finally:
                mode._propagating -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = self._saved
        return super().__exit__(*exc)

    # -- counting -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the shards, which come back here
        if _composite(func):  # matmul, einsum... (inference mode reaches them whole)
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        name = str(func.overloadpacket).replace("aten.", "")
        kind = _collective(func)
        if kind is not None:
            self.collective_bytes[kind] += _nbytes(out)
            self.collective_count[kind] += 1
        elif func in OP_COSTS:
            f, b = OP_COSTS[func](*args, **kwargs)
            self.flops_by_op[name] += f
            self.bytes_by_op[name] += b
        else:
            from torch.utils.flop_counter import flop_registry

            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops_by_op[name] += formula(*args, **kwargs, out_val=out)
            if not (func.namespace in ("prim", *_C10D) or _is_view(func)
                    or func._schema.name.split("::")[-1] in _NO_TRAFFIC):
                self.bytes_by_op[name] += _nbytes((args, kwargs)) + _nbytes(out)
        if self.track_memory:
            for t in _tensors(out):
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def result(self) -> OpCost:
        return OpCost(flops=sum(self.flops_by_op.values()), bytes=sum(self.bytes_by_op.values()),
                      collective_bytes=dict(self.collective_bytes),
                      collective_count=dict(self.collective_count),
                      flops_by_op=dict(self.flops_by_op), bytes_by_op=dict(self.bytes_by_op),
                      peak_bytes=self.peak_bytes)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t
