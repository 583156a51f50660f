"""What the LM kernels' custom ops register beside themselves: a cost and a
DTensor sharding rule.

The flash-attention and SSD-scan kernels (forward and backward) are
``torch.library.custom_op``s (``flash_attention/ops.py``,
``ssm_scan/ops.py``), so fake tensors and DTensors reach them: the ctypes
wrappers under them take ``data_ptr()``, which neither has.  Each op has

- a fake implementation, whose outputs have the kernel's shapes, dtypes
  and strides (the dry run runs it under ``FakeTensorMode``);
- a cost, FLOPs and bytes a launch (``kernels/costs.py``), in ``OP_COSTS``
  for ``launch/op_cost.py`` and as a formula of
  ``torch.utils.flop_counter`` for ``FlopCounterMode``;
- a sharding rule: the placements, one mesh dim at a time, under which the
  op runs on each rank's shards alone (``register_dtensor_rule``); DTensor
  redistributes the inputs to the cheapest one and combines them over the
  mesh's dims.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

# op overload -> fn(*args) -> (FLOPs, bytes) of one launch on those inputs
OP_COSTS: dict = {}


def register_cost(op, cost: Callable[..., tuple[int, int]]) -> None:
    """``cost(*op_args)`` -> (FLOPs, bytes) of one launch of ``op``."""
    from torch.utils.flop_counter import register_flop_formula

    OP_COSTS[op] = cost

    def flops(*args, out_val=None, **kwargs):
        return cost(*args, **kwargs)[0]

    register_flop_formula(op._overloadpacket, get_raw=True)(flops)


def _even(spec, mesh) -> bool:
    """True when every dim ``spec`` shards divides over its mesh dims."""
    from torch.distributed.tensor import Shard

    shards: dict[int, int] = {}
    for size, p in zip(mesh.shape, spec.placements):
        if isinstance(p, Shard):
            shards[p.dim] = shards.get(p.dim, 1) * size
    shape = spec.tensor_meta.shape
    return all(shape[d] % n == 0 for d, n in shards.items())


# (op, strategies, n_out, static_argnum) of each op, registered with DTensor
# by register_dtensor_rules (importing DTensor's internals costs a second, so
# only a process that shards does)
DTENSOR_RULES: list[tuple] = []
_registered: set = set()


def register_dtensor_rule(op, strategies: Sequence[str], n_out: int,
                          static_argnum: int) -> None:
    """DTensor runs ``op`` shard by shard under any combination, over the
    mesh's dims, of ``strategies``: each one mesh dim's placements, the
    ``n_out`` outputs' then the tensor inputs', written as short names
    apart ("R" replicated, "P" partial sum, "S<d>" sharded on dim d).  Combinations
    that would shard a dim unevenly are dropped (the kernels take no ragged
    shards); the arguments from ``static_argnum`` on (the masks, the chunk)
    key the propagation cache.  Takes effect at ``register_dtensor_rules``."""
    DTENSOR_RULES.append((op, strategies, n_out, static_argnum))


def register_dtensor_rules() -> None:
    """Register every op's sharding rule with DTensor (once)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops.utils import expand_to_full_mesh_op_strategy

    for op, strategies, n_out, static_argnum in DTENSOR_RULES:
        if op in _registered:
            continue
        rows = [_placements(row) for row in strategies]

        def strategy(op_schema, rows=rows, n_out=n_out):
            mesh = op_schema.get_mesh_from_args()
            out = expand_to_full_mesh_op_strategy(mesh, op_schema, rows, input_index=n_out)
            out.strategies = [s for s in out.strategies
                              if all(_even(spec, mesh) for spec in s.input_specs)]
            return out

        DTensor._op_dispatcher.sharding_propagator.register_op_strategy(
            op, strategy, RuntimeSchemaInfo(static_argnum, needs_pytree=True))
        _registered.add(op)


def _placements(row: str) -> list:
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [Replicate() if n == "R" else Partial() if n == "P" else Shard(int(n[1:]))
            for n in row.split()]


def fake_empty(like: torch.Tensor, shape, dtype=None) -> torch.Tensor:
    """A new contiguous tensor of ``shape`` beside ``like`` (a fake output)."""
    return torch.empty(tuple(shape), dtype=dtype or like.dtype, device=like.device)
