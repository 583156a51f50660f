"""The whole step's share of the card's peak in the open-loop cell: the
model FLOPs of the requests completed in the window (``costs``, products
only) over the wall time of the ``Deployment.step()`` calls that served
them, each ending in its synchronise, at 495e12 FLOP/s (dense TF32).  It
moves ``p95_ms``."""

from seifer_bench.lib import costs


def read(obs):
    if not obs.get("completed") or obs.get("step_wall_s", 0) <= 0:
        return None
    flops = obs["completed"] * obs["request_flops"]
    return 100.0 * flops / (obs["step_wall_s"] * costs.PEAK_TF32)
