"""Host milliseconds inside ``Deployment.step()`` a microbatch served, in
the closed-loop cells: the engine's scheduling, batch stacking, codec calls
and kernel launches, without the synchronise that waits for the device.
From the benchmark's spans around each call; it moves ``req_per_s``."""


def read(obs):
    if not obs.get("microbatches"):
        return None
    return 1e3 * obs["step_host_s"] / obs["microbatches"]
