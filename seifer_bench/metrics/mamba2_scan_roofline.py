"""The grouped SSD scan's share of its roofline in the Zamba2 cell: the
least time of every ``ssd_chunked_cuda`` launch with grouped B and C in the
window (``zamba2_costs.ssd_grouped_bound_s``: its fewest FLOPs at the
cheapest chunking, C B^T once a group, at 3 TF32 passes, or its bytes over
HBM) over the device time of the scan's kernels.  It moves ``req_per_s``."""

from seifer_bench.lib import trace, zamba2_costs
from seifer_bench.lib.readers import shape

CALLS = ("repro_torch.kernels.ssm_scan.ops:ssd_chunked_cuda",)
PATTERNS = (r"ssd_scan_kernel",)


def bound(call):
    b, s, h, dh = shape(call, 0)
    _, _, g, n = shape(call, 1)
    return zamba2_costs.ssd_grouped_bound_s(b, s, h, dh, n, g)


def read(obs):
    # only launches with (B, S, G, N) B and C: one-group scans are not this cell's
    found = [c for c in obs.get("calls", ()) if c[0] in CALLS and len(shape(c, 1)) == 4]
    secs = sum(trace.op_seconds(d, PATTERNS) for d in obs.get("trace", ()))
    if not found or secs <= 0:
        return None
    return 100.0 * sum(bound(c) for c in found) / secs
