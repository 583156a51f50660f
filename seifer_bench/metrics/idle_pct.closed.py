"""The share of the traced window in which no operation ran on the device,
the mean over the ranks traced.  It moves ``req_per_s``."""

from seifer_bench.lib import trace


def read(obs):
    shares = [1.0 - trace.busy_s(d) / trace.window_s(d) for d in obs.get("trace", ())
              if trace.window_s(d) > 0]
    return 100.0 * sum(shares) / len(shares) if shares else None
