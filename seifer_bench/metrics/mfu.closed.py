"""The whole step's share of the cards' peak in the closed-loop cells: the
model FLOPs of the requests completed in the window (``costs``, products
only) over the window times the chips at 495e12 FLOP/s each (dense TF32).
It moves ``req_per_s``."""

from seifer_bench.lib import costs


def read(obs):
    if not obs.get("completed") or obs.get("window_s", 0) <= 0:
        return None
    flops = obs["completed"] * obs["request_flops"]
    return 100.0 * flops / (obs["window_s"] * obs["chips"] * costs.PEAK_TF32)
