"""The share of a rank's device time spent in NCCL kernels (the boundary
exchanges, the all-reduce before the first tick and the broadcast of the
outputs), the largest over the ranks of the four-card GPipe.  It moves
``req_per_s``."""

from seifer_bench.lib import trace

PATTERNS = (r"nccl",)


def read(obs):
    shares = [trace.op_seconds(d, PATTERNS) / busy for d in obs.get("trace", ())
              if (busy := trace.busy_s(d)) > 0]
    return 100.0 * max(shares) if shares else None
