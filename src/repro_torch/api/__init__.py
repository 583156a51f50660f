"""Declarative deployment API: ``DeploymentSpec`` -> ``Planner`` -> ``Deployment``.

The one-facade entry point to the PyTorch port of the SEIFER reproduction:

    from repro_torch.api import ClusterSpec, DeploymentSpec, deploy

    spec = DeploymentSpec(model="demo_mlp",
                          cluster=ClusterSpec(n_nodes=8, capacity_bytes=11_000),
                          codec="int8", device="cuda")
    d = deploy(spec)          # elect -> probe -> partition -> place -> deploy
    d.submit(x); d.step()     # serve
    d.inject(NodeFailed(3))   # churn
    d.reconcile()             # converge

Layers: ``registry`` (named strategies, self-registered from
``repro_torch.core``), ``spec`` (frozen validated description of model +
cluster + strategies + SLOs + device), ``planner`` (spec -> ``Plan``:
partition + placement + predicted metrics), ``deploy`` (``Deployment``
facade owning dispatcher + control plane + serving loop).

Everything except the registry is imported lazily (PEP 562): the core
algorithm modules import ``repro_torch.api.registry`` at definition time to
self-register, and an eager ``spec``/``planner`` import here would close
that cycle.
"""

from __future__ import annotations

from repro_torch.api.registry import (
    KINDS,
    Strategy,
    UnknownStrategyError,
    default_strategy,
    get_strategy,
    list_strategies,
    register_strategy,
    strategy_table,
)

_LAZY = {
    "ClusterSpec": "repro_torch.api.spec",
    "DeploymentSpec": "repro_torch.api.spec",
    "InfeasibleSpecError": "repro_torch.api.spec",
    "SLOClass": "repro_torch.api.spec",
    "SpecIssue": "repro_torch.api.spec",
    "TenantSpec": "repro_torch.api.spec",
    "Plan": "repro_torch.api.planner",
    "Planner": "repro_torch.api.planner",
    "Deployment": "repro_torch.api.deploy",
    "deploy": "repro_torch.api.deploy",
}

__all__ = [
    "KINDS",
    "Strategy",
    "UnknownStrategyError",
    "default_strategy",
    "get_strategy",
    "list_strategies",
    "register_strategy",
    "strategy_table",
    *sorted(_LAZY),
]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        obj = getattr(importlib.import_module(_LAZY[name]), name)
        # cache it: the submodule import binds e.g. ``repro_torch.api.deploy``
        # (the MODULE) onto this package under the same name as the function
        # it exports; pinning the resolved object wins that collision
        globals()[name] = obj
        return obj
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
