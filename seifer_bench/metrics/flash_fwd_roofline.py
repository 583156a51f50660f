"""The flash-attention forward kernel's share of its roofline: the least
time of every launch in the window (the frozen ``flash_fwd_flops`` over
its live causal pairs at 3 TF32 passes, or ``flash_fwd_bytes`` over HBM)
over the device time of its kernel.  It moves ``req_per_s``."""

from seifer_bench.lib import costs
from seifer_bench.lib.readers import arg, roofline, shape

CALLS = ("repro_torch.kernels.flash_attention.ops:flash_attention_cuda",)
PATTERNS = (r"flash_fwd_kernel",)


def bound(call):
    b, s, h, hd = shape(call, 0)
    kh = shape(call, 1)[2]
    causal, window = arg(call, 3, "causal", True), arg(call, 4, "window", 0)
    flops = costs.flash_fwd_flops(b, s, h, hd, causal=causal, window=window)
    nbytes = costs.flash_fwd_bytes(b, s, h, kh, hd, lse=bool(arg(call, 6, "lse", False)))
    return costs.bound_s(nbytes, flops, costs.F32_PRODUCT_S_PER_FLOP)


def read(obs):
    return roofline(obs, CALLS, PATTERNS, bound)
