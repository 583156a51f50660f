"""Model-watch container: redeploy on model-version updates (Sec. 2.3-3).

Watches the artifact store's version pointer; when the external repository
publishes a new model version, the watcher stops the inference pods and
reruns partitioning/placement + deployment.  A full cluster restart is only
needed when a NODE is added (per the paper) -- version bumps are handled
in-place.

Two modes:

  * ``poll``        -- legacy one-shot: detect + redeploy in one call.
  * ``poll_events`` -- control-plane mode: the watcher only *detects* and
    emits a ``VersionBumped`` event; the reconciler owns convergence.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

from repro_torch.cluster.dispatcher import Dispatcher
from repro_torch.cluster.events import VersionBumped
from repro_torch.cluster.lifecycle import InferencePipeline
from repro_torch.cluster.store import ArtifactStore
from repro_torch.core.graph import LayerGraph

if TYPE_CHECKING:  # avoid a cycle: controlplane imports nothing from watch
    from repro_torch.cluster.controlplane import ControlPlane


class ModelWatcher:
    def __init__(
        self,
        store: ArtifactStore,
        dispatcher: Dispatcher | None = None,
        graph_for_version: Callable[[int], LayerGraph] | None = None,
    ):
        # dispatcher/graph_for_version are only needed for legacy ``poll``;
        # in control-plane mode the reconciler owns both.
        self.store = store
        self.dispatcher = dispatcher
        self.graph_for_version = graph_for_version
        self.deployed_version = store.current_version()

    def poll(
        self, pipeline: InferencePipeline, executor: Callable, **deploy_kw
    ) -> InferencePipeline:
        """One watch tick: redeploy if the store moved past us."""
        if self.dispatcher is None or self.graph_for_version is None:
            raise RuntimeError(
                "legacy poll() requires dispatcher and graph_for_version; "
                "use poll_events(control) in control-plane mode"
            )
        latest = self.store.current_version()
        if latest <= self.deployed_version:
            return pipeline
        for pod in pipeline.pods:  # stop the old inference pods
            pod.alive = False
        graph = self.graph_for_version(latest)
        plan = self.dispatcher.configure(graph, latest)
        if not plan.feasible:
            raise RuntimeError(f"version {latest} does not fit the cluster")
        new_pipe = self.dispatcher.deploy(plan, executor, **deploy_kw)
        self.deployed_version = latest
        return new_pipe

    def poll_events(self, control: "ControlPlane") -> bool:
        """One watch tick in control-plane mode: emit, don't act.

        Compares the store pointer against the control plane's *deployed*
        version (the observed state), so the detector itself is stateless
        and watchers can be created at any time.  Returns True when a
        ``VersionBumped`` event was submitted; the caller (or the serving
        loop) triggers ``control.reconcile()``.
        """
        latest = self.store.current_version()
        deployed = (
            control.desired.version
            if control.desired is not None
            else self.deployed_version
        )
        if latest <= deployed:
            return False
        control.submit(VersionBumped(latest))
        # deployed_version deliberately NOT advanced: the reconciler may
        # reject the bump (infeasible), and control-plane mode compares
        # against control.desired.version anyway -- mutating here would
        # desync a watcher that also serves legacy poll() callers
        return True
