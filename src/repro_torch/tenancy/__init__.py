"""Multi-tenant serving: many models, one shared edge cluster.

A ``Deployment`` serves ONE model per cluster.  This package adds the
cluster-level tenancy layer:

  * ``TenantScheduler`` -- carve the hosting nodes into per-tenant slices
    under ``capacity_fraction`` quotas (or fractional co-residency under
    the ``"shared"`` policy),
  * ``TenancyRouter`` -- quota-scoped admission + weighted-fair service
    across tenants on one virtual timeline,
  * ``MultiTenantControlPlane`` -- churn routed only to the tenant(s)
    whose slice it touches, so one tenant's re-plan never perturbs
    another's live pipelines,
  * ``deploy_tenants`` -- the one-call entry (also reached by handing
    ``repro_torch.api.deploy()`` a *list* of specs).
"""

from repro_torch.tenancy.controlplane import MultiTenantControlPlane
from repro_torch.tenancy.deploy import MultiTenantDeployment, deploy_tenants
from repro_torch.tenancy.router import TenancyRouter
from repro_torch.tenancy.scheduler import (
    POLICIES,
    TenancyPlan,
    TenantPlacement,
    TenantScheduler,
    resolve_fractions,
)

__all__ = [
    "MultiTenantControlPlane",
    "MultiTenantDeployment",
    "POLICIES",
    "TenancyPlan",
    "TenancyRouter",
    "TenantPlacement",
    "TenantScheduler",
    "deploy_tenants",
    "resolve_fractions",
]
