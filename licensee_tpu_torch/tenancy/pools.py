"""Heterogeneous worker pools: one supervisor per pool, one facade.

The port's copy of `licensee_tpu/tenancy/pools.py`; each pool's
supervisor runs the port's serve workers, on the card unless its
``serve_args`` carry ``--device cpu`` (a respawned or rolled worker
keeps its argv, and so its device).

The fleet tier was built single-corpus: ONE supervisor owns every
worker and ``reload_fleet`` rolls them all.  Multi-tenant serving
needs N workers on corpus A next to M workers on corpus B, each pool
independently health-probed, restarted, and rolled — without teaching
the router a second supervision protocol.  :class:`TenantPools` is
that shim: it owns one :class:`~licensee_tpu_torch.fleet.supervisor.
Supervisor` per pool and re-exports the exact supervisor surface the
router consumes (``dispatchable``/``status``/``host_health``/
``reload_fleet``), routing each call to the pool that owns the named
worker.  Worker names are globally unique across pools (the router's
backend table is flat), so the mapping is a plain dict.
"""

from __future__ import annotations


class TenantPools:
    """A supervisor-of-supervisors: the router sees one ``supervisor``
    object; each pool keeps its own probe thread, restart backoff, and
    blue/green reload lock, so rolling pool A cannot stall or restart
    pool B's workers."""

    def __init__(self, pools: dict, *, default_pool: str | None = None):
        if not pools:
            raise ValueError("TenantPools needs at least one pool")
        self.pools = dict(pools)
        self.default_pool = (
            default_pool if default_pool is not None
            else sorted(self.pools)[0]
        )
        if self.default_pool not in self.pools:
            raise ValueError(
                f"default pool {self.default_pool!r} is not one of "
                f"{sorted(self.pools)}"
            )
        self._owner: dict[str, str] = {}
        for pool_name, sup in self.pools.items():
            for worker in sup.workers:
                other = self._owner.get(worker)
                if other is not None:
                    raise ValueError(
                        f"worker name {worker!r} appears in pools "
                        f"{other!r} and {pool_name!r} (names must be "
                        "fleet-unique: the router's backend table is "
                        "flat)"
                    )
                self._owner[worker] = pool_name
        self._router = None

    # the Router constructor does ``supervisor.router = self``; fan the
    # handle out so each pool's drain path can read per-worker
    # outstanding counts from the shared router
    @property
    def router(self):
        return self._router

    @router.setter
    def router(self, value) -> None:
        self._router = value
        for sup in self.pools.values():
            sup.router = value

    @property
    def workers(self) -> dict[str, str]:
        """Merged worker name -> socket target across every pool (the
        Router's ``backends`` ctor argument)."""
        merged: dict[str, str] = {}
        for sup in self.pools.values():
            for name, handle in sup.workers.items():
                merged[name] = handle.socket_path
        return merged

    def handles(self) -> dict:
        """Merged worker name -> live WorkerHandle across every pool
        (the selftests read pids and restart counts here)."""
        merged: dict = {}
        for sup in self.pools.values():
            merged.update(sup.workers)
        return merged

    def pool_of(self, name: str) -> str | None:
        return self._owner.get(name)

    def worker_pools(self) -> dict[str, str]:
        """worker name -> pool name (the router's routing table seed)."""
        return dict(self._owner)

    # -- lifecycle --

    def start(self) -> None:
        for sup in self.pools.values():
            sup.start()

    def stop(self) -> None:
        for sup in self.pools.values():
            sup.stop()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def wait_healthy(self, timeout_s: float = 30.0) -> bool:
        import time

        deadline = time.perf_counter() + timeout_s
        for sup in self.pools.values():
            remaining = deadline - time.perf_counter()
            if remaining <= 0 or not sup.wait_healthy(remaining):
                return False
        return True

    # -- the supervisor surface the router consumes --

    def dispatchable(self, name: str) -> bool:
        pool = self._owner.get(name)
        if pool is None:
            return True
        return self.pools[pool].dispatchable(name)

    def probe(self, name: str):
        pool = self._owner.get(name)
        if pool is None:
            return None
        return self.pools[pool].probe(name)

    def status(self) -> dict:
        merged: dict = {}
        for pool_name, sup in sorted(self.pools.items()):
            for worker, row in sup.status().items():
                if isinstance(row, dict):
                    row = dict(row)
                    row["pool"] = pool_name
                merged[worker] = row
        return merged

    def host_health(self) -> dict:
        totals = {
            "workers": 0, "healthy": 0, "dispatchable": 0,
            "restarts": 0, "serving": True,
        }
        per_pool: dict = {}
        for pool_name, sup in sorted(self.pools.items()):
            health = sup.host_health()
            per_pool[pool_name] = health
            for key in ("workers", "healthy", "dispatchable", "restarts"):
                totals[key] += health.get(key, 0)
            totals["serving"] = totals["serving"] and bool(
                health.get("serving", False)
            )
        totals["pools"] = per_pool
        return totals

    def drain(self, name: str, **kwargs):
        pool = self._owner.get(name)
        if pool is None:
            raise KeyError(name)
        return self.pools[pool].drain(name, **kwargs)

    def reload_fleet(self, corpus: str, *, pool: str | None = None,
                     **kwargs) -> dict:
        """Roll ONE pool onto a new corpus; other pools keep serving
        untouched.  ``pool=None`` rolls the default pool (the
        single-tenant ``{"op": "reload"}`` verb keeps working)."""
        target = pool if pool is not None else self.default_pool
        sup = self.pools.get(target)
        if sup is None:
            return {
                "ok": False,
                "error": f"unknown_pool: no pool named {target!r}",
                "pools": sorted(self.pools),
            }
        result = sup.reload_fleet(corpus, **kwargs)
        if isinstance(result, dict):
            result.setdefault("pool", target)
        return result
