"""What the per-layer metrics' readers share.

A reader gets ``obs``, the entry's observations of the window: ``trace``
(one reduced device trace a rank, ``lib/trace.py``), ``calls`` (the program
calls the readers asked for, ``lib/calls.py``), the engine's counters and
the benchmark's host spans.  A reader that finds nothing to read returns
``None`` and the metric is left out of the line; a share of a roofline or
a peak is never reported as 0 for want of data.
"""

from __future__ import annotations

import math

from seifer_bench.lib import costs, trace

DTYPE_BYTES = {"torch.float32": 4, "torch.bfloat16": 2, "torch.float16": 2, None: 4}


def arg(call, position: int, name: str, default=None):
    """A recorded call's argument by position or keyword."""
    _, args, kwargs = call
    if name in kwargs:
        return kwargs[name]
    return args[position] if position < len(args) else default


def shape(call, position: int) -> tuple[int, ...]:
    kind, dims, _ = arg(call, position, "")
    if kind != "tensor":
        raise ValueError(f"argument {position} of {call[0]} is not a tensor")
    return dims


def elements(dims) -> int:
    return math.prod(dims)


def roofline(obs: dict, sites, patterns, bound_of) -> float | None:
    """100 x (the least time of every recorded call at ``sites``, by
    ``bound_of(call)``) / (the device time of the operations matching
    ``patterns``), over every rank traced."""
    found = [c for c in obs.get("calls", ()) if c[0] in sites]
    secs = sum(trace.op_seconds(d, patterns) for d in obs.get("trace", ()))
    if not found or secs <= 0:
        return None
    return 100.0 * sum(bound_of(c) for c in found) / secs


def codec_bound(call) -> float:
    """Least time of one int8 codec launch: quantize reads the activation
    and writes its codes and scales, dequantize reads those and writes the
    activation, each byte once, over HBM."""
    if call[0].endswith(":dequantize_int8_cuda"):
        codes, scales = shape(call, 0), shape(call, 1)
        out = DTYPE_BYTES.get(arg(call, 2, "dtype", "torch.bfloat16"), 4)
        block = arg(call, 3, "block") or codes[-1] // scales[-1]
        nbytes = costs.dequantize_bytes(elements(codes), out, block)
    else:
        _, dims, itemsize = arg(call, 0, "x")
        nbytes = costs.quantize_bytes(elements(dims), itemsize, arg(call, 1, "block", 256))
    return costs.bound_s(nbytes)
