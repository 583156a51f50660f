"""The SSD scan kernel's share of its roofline: the least time of every
forward launch in the window (the frozen ``ssd_fwd_cost`` at its shape: the
fewest FLOPs of any chunking at 3 TF32 passes, or its bytes over HBM)
over the device time of the kernels named below.  It moves ``p95_ms``."""

from seifer_bench.lib import costs
from seifer_bench.lib.readers import roofline, shape

CALLS = ("repro_torch.kernels.ssm_scan.ops:ssd_chunked_cuda",)
PATTERNS = (r"ssd_scan_kernel",)


def bound(call):
    b, s, h, dh = shape(call, 0)
    flops, nbytes = costs.ssd_fwd_cost(b, s, h, dh, shape(call, 1)[-1])
    return costs.bound_s(nbytes, flops, costs.F32_PRODUCT_S_PER_FLOP)


def read(obs):
    return roofline(obs, CALLS, PATTERNS, bound)
