"""Fleet tier: multi-worker serving supervision and routing.

One ``licensee-tpu-torch fleet`` process = a :class:`Supervisor` (spawn N
serve workers, health-check, restart with backoff, drain gracefully —
fleet/supervisor.py), a :class:`Router` (least-loaded dispatch, hedged
retries, failover — fleet/router.py) fronting them on a single client
socket, and the fault harness (fleet/faults.py) + selftest
(fleet/selftest.py) that prove the pair rides out crashes, hangs, and
brownouts with zero client-visible errors.

Exports resolve lazily: ``python -m licensee_tpu_torch.fleet.faults`` (the
stub worker the fault tests spawn by the dozen) must not pay the serve
import chain just to exist.
"""

from __future__ import annotations

_EXPORTS = {
    "Router": "licensee_tpu_torch.fleet.router",
    "FrontServer": "licensee_tpu_torch.fleet.router",
    "Supervisor": "licensee_tpu_torch.fleet.supervisor",
    "WorkerHandle": "licensee_tpu_torch.fleet.supervisor",
    "default_worker_argv": "licensee_tpu_torch.fleet.supervisor",
    "worker_env": "licensee_tpu_torch.fleet.supervisor",
    "Connection": "licensee_tpu_torch.fleet.wire",
    "ConnectionPool": "licensee_tpu_torch.fleet.wire",
    "WireError": "licensee_tpu_torch.fleet.wire",
    "oneshot": "licensee_tpu_torch.fleet.wire",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
