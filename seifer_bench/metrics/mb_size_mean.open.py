"""Requests a microbatch in the open-loop cell: the engine's completed
requests over its completed microbatches in the window (its own counters,
``Deployment.metrics()``).  Continuous batching widens batches as the queue
grows; it moves ``p95_ms``."""


def read(obs):
    if not obs.get("microbatches"):
        return None
    return obs["engine_completed"] / obs["microbatches"]
