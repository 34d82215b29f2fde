"""The tenant registry: durable JSON config binding edge bearer
tokens to corpus sources and worker pools, plus the journaled
onboarding state.  The port's copy of `licensee_tpu/tenancy/registry.py`:
the same file and journal formats, so either package boots from the
other's registry.

The config file is the operator's source of truth::

    {
      "version": 1,
      "default_pool": "acme",
      "tenants": {
        "acme": {"token": "tok-acme", "corpus": "vendored",
                 "pool": "acme"},
        "beta": {"token": "tok-beta", "corpus": "spdx"}
      }
    }

``pool`` defaults to the tenant's own name — the common one-pool-per-
tenant topology needs no extra config.  Saves are atomic (tmp +
``os.replace``) so a crash mid-save leaves the previous config intact.

Onboarding rolls are journaled NEXT TO the config file
(``<config>.journal``) through the jobs tier's fsync'd append-only
:class:`~licensee_tpu_torch.jobs.journal.JobJournal`: a ``roll_start``
record lands before the fleet reload begins and a ``roll_done`` /
``roll_failed`` record after, so a SIGKILL mid-roll leaves a dangling
start that :meth:`TenantRegistry.pending_rolls` surfaces for recovery
at the next boot.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field

from licensee_tpu_torch.jobs.journal import JobJournal, JournalError

REGISTRY_VERSION = 1


class RegistryError(Exception):
    """A malformed registry file or tenant definition (fail-closed:
    a fleet must not boot serving the wrong corpus to a token)."""


@dataclass
class Tenant:
    """One org's binding: bearer token -> corpus source -> pool."""

    name: str
    token: str
    corpus: str
    pool: str = ""
    # runtime state, not config: the fingerprint the tenant's pool is
    # currently serving (filled in after boot / after a roll)
    fingerprint: str | None = field(default=None, compare=False)

    def __post_init__(self):
        if not self.pool:
            self.pool = self.name

    def as_dict(self) -> dict:
        row = {"token": self.token, "corpus": self.corpus}
        if self.pool != self.name:
            row["pool"] = self.pool
        return row


def _parse_tenant(name: str, row) -> Tenant:
    if not isinstance(row, dict):
        raise RegistryError(f"tenant {name!r}: want an object, got "
                            f"{type(row).__name__}")
    token = row.get("token")
    corpus = row.get("corpus")
    if not isinstance(token, str) or not token:
        raise RegistryError(f"tenant {name!r}: missing 'token'")
    if not isinstance(corpus, str) or not corpus:
        raise RegistryError(f"tenant {name!r}: missing 'corpus'")
    pool = row.get("pool", "")
    if not isinstance(pool, str):
        raise RegistryError(f"tenant {name!r}: 'pool' must be a string")
    return Tenant(name=name, token=token, corpus=corpus, pool=pool)


class TenantRegistry:
    """The durable tenant table plus its onboarding journal.

    Thread-safe: the edge resolves tokens from its ops threads while
    an onboarding roll rewrites a tenant's corpus binding.
    """

    def __init__(self, path: str, *, create: bool = False):
        self.path = path
        self._lock = threading.Lock()
        self._tenants: dict[str, Tenant] = {}
        self.default_pool: str | None = None
        if create and not os.path.exists(path):
            self._save_locked()
        else:
            self._load()
        self._journal = JobJournal(path + ".journal")

    # -- config file --

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except OSError as exc:
            raise RegistryError(f"cannot read {self.path!r}: {exc}")
        except ValueError as exc:
            raise RegistryError(f"{self.path!r} is not JSON: {exc}")
        if not isinstance(doc, dict):
            raise RegistryError(f"{self.path!r}: want a JSON object")
        version = doc.get("version")
        if version != REGISTRY_VERSION:
            raise RegistryError(
                f"{self.path!r}: unsupported version {version!r} "
                f"(this build speaks {REGISTRY_VERSION})"
            )
        rows = doc.get("tenants")
        if not isinstance(rows, dict):
            raise RegistryError(f"{self.path!r}: missing 'tenants' object")
        tenants = {
            name: _parse_tenant(name, row) for name, row in rows.items()
        }
        tokens: dict[str, str] = {}
        for tenant in tenants.values():
            other = tokens.get(tenant.token)
            if other is not None:
                raise RegistryError(
                    f"token collision: tenants {other!r} and "
                    f"{tenant.name!r} share a bearer token"
                )
            tokens[tenant.token] = tenant.name
        default_pool = doc.get("default_pool")
        if default_pool is not None:
            if not isinstance(default_pool, str):
                raise RegistryError(
                    f"{self.path!r}: 'default_pool' must be a string"
                )
            pools = {t.pool for t in tenants.values()}
            if tenants and default_pool not in pools:
                raise RegistryError(
                    f"{self.path!r}: default_pool {default_pool!r} "
                    f"names no tenant pool (have {sorted(pools)})"
                )
        self._tenants = tenants
        self.default_pool = default_pool

    def _save_locked(self) -> None:
        doc: dict = {"version": REGISTRY_VERSION}
        if self.default_pool is not None:
            doc["default_pool"] = self.default_pool
        doc["tenants"] = {
            name: tenant.as_dict()
            for name, tenant in sorted(self._tenants.items())
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=False)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    def save(self) -> None:
        with self._lock:
            self._save_locked()

    # -- lookups --

    def tenants(self) -> dict[str, Tenant]:
        with self._lock:
            return dict(self._tenants)

    def get(self, name: str) -> Tenant | None:
        with self._lock:
            return self._tenants.get(name)

    def by_token(self, token: str) -> Tenant | None:
        with self._lock:
            for tenant in self._tenants.values():
                if tenant.token == token:
                    return tenant
        return None

    def tokens(self) -> dict[str, str]:
        """token -> tenant name, the map the HTTP edge authenticates
        against (the edge's client label IS the tenant name)."""
        with self._lock:
            return {t.token: t.name for t in self._tenants.values()}

    def pools(self) -> dict[str, list[str]]:
        """pool name -> sorted tenant names bound to it."""
        out: dict[str, list[str]] = {}
        with self._lock:
            for tenant in self._tenants.values():
                out.setdefault(tenant.pool, []).append(tenant.name)
        return {pool: sorted(names) for pool, names in sorted(out.items())}

    def set_tenant(self, tenant: Tenant, *, save: bool = True) -> None:
        with self._lock:
            self._tenants[tenant.name] = tenant
            if save:
                self._save_locked()

    def update_corpus(
        self, name: str, corpus: str, fingerprint: str | None,
        *, save: bool = True,
    ) -> Tenant:
        """Rebind a tenant's corpus after a successful roll and persist
        the new binding (the registry file is what the NEXT boot serves
        from, so it must only ever name validated, rolled corpora)."""
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                raise RegistryError(f"unknown tenant {name!r}")
            tenant.corpus = corpus
            tenant.fingerprint = fingerprint
            if save:
                self._save_locked()
            return tenant

    # -- onboarding journal --

    def record_roll(self, event: str, tenant: str, **fields) -> None:
        """Append one onboarding lifecycle edge (``roll_start`` /
        ``roll_done`` / ``roll_failed``) — fsync'd before returning,
        so the record survives a SIGKILL of the fleet process."""
        row = {"event": event, "tenant": tenant}
        row.update(fields)
        self._journal.append(row)

    def pending_rolls(self) -> list[dict]:
        """Every journaled ``roll_start`` without a matching terminal
        record — the rolls a crash interrupted, replayed at boot by
        :meth:`CorpusOnboarder.recover`."""
        try:
            records = self._journal.replay()
        except JournalError:
            # a corrupt non-tail record means the journal cannot be
            # trusted for recovery; fail open to "nothing pending"
            # rather than re-rolling from garbage
            return []
        open_rolls: dict[str, dict] = {}
        for row in records:
            event = row.get("event")
            tenant = row.get("tenant")
            if not isinstance(tenant, str):
                continue
            if event == "roll_start":
                open_rolls[tenant] = row
            elif event in ("roll_done", "roll_failed"):
                open_rolls.pop(tenant, None)
        return list(open_rolls.values())

    def close(self) -> None:
        self._journal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
