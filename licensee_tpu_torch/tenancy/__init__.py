"""Multi-tenant serving: tenant registry, per-pool supervision, and
self-serve corpus onboarding.  The port's copy of `licensee_tpu/tenancy/`.

The subsystem closes the loop from an edge bearer token to a corpus
fingerprint:

- :mod:`licensee_tpu_torch.tenancy.registry` — the durable tenant config
  (token -> tenant -> corpus source -> pool) plus the journaled
  onboarding state that survives a crash mid-roll.
- :mod:`licensee_tpu_torch.tenancy.pools` — heterogeneous worker pools: one
  :class:`~licensee_tpu_torch.fleet.supervisor.Supervisor` per pool behind
  the supervisor surface the router consumes, with a per-pool
  ``reload_fleet``.
- :mod:`licensee_tpu_torch.tenancy.onboard` — the authenticated
  upload -> validate -> roll -> persist pipeline behind the edge's
  ``POST /corpus`` verb.
"""

from licensee_tpu_torch.tenancy.onboard import CorpusOnboarder, OnboardError
from licensee_tpu_torch.tenancy.pools import TenantPools
from licensee_tpu_torch.tenancy.registry import (
    RegistryError,
    Tenant,
    TenantRegistry,
)

__all__ = [
    "CorpusOnboarder",
    "OnboardError",
    "RegistryError",
    "Tenant",
    "TenantRegistry",
]
