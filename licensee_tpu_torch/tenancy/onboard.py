"""Self-serve corpus onboarding: upload -> validate -> roll -> persist.

The port's copy of `licensee_tpu/tenancy/onboard.py`.

The edge's ``POST /corpus`` verb lands here (on an ops thread, never
the router's event loop).  The pipeline:

1. **Stage** the uploaded artifact bytes under a content-addressed
   name (sha256 prefix) so a re-upload of the same bytes is idempotent
   and a half-written file can never be rolled.
2. **Validate** through the corpus gate
   (:func:`~licensee_tpu_torch.corpus.artifact.resolve_corpus` by default —
   the same fail-closed fingerprint-checked load the blue/green
   reload runs, on the host), yielding the artifact's fingerprint.
   Each worker's own reload then validates it on its device.
3. **Journal** a ``roll_start`` record (fsync'd), then roll the
   tenant's pool via the per-pool ``reload_fleet`` — other pools keep
   serving.  A crash between start and done leaves a dangling journal
   record that :meth:`CorpusOnboarder.recover` replays at next boot.
4. **Persist** the tenant's new corpus binding in the registry and
   swap the router's fingerprint routes, so tagged traffic follows
   the roll and response verification expects the new fingerprint.

Failures raise :class:`OnboardError` with a closed set of codes; the
edge owns the HTTP mapping (403/400/409/500) and mints the wire error
bodies — no protocol strings originate here.
"""

from __future__ import annotations

import hashlib
import os

from licensee_tpu_torch.corpus.artifact import ArtifactError, resolve_corpus


class OnboardError(Exception):
    """A typed onboarding failure.  ``code`` is one of
    ``unknown_tenant`` / ``corpus_invalid`` /
    ``fleet_reload_in_progress`` / ``reload_failed``; the edge maps
    codes to HTTP statuses and mints the response body."""

    def __init__(self, code: str, detail: str):
        self.code = code
        self.detail = detail
        super().__init__(f"{code}: {detail}")


def _default_validator(path: str) -> str:
    _corpus, fingerprint, _manifest = resolve_corpus(path)
    return fingerprint


class CorpusOnboarder:
    """The tenant-facing onboarding pipeline over one fleet.

    ``validator(path) -> fingerprint`` and
    ``source_for(path, fingerprint) -> corpus source`` are injectable
    so the stub selftests can drill the full journal/roll/route flow
    without building a real corpus (a stub worker's "corpus" is just
    the fingerprint string its reload op installs).
    """

    def __init__(
        self, registry, pools, router, *, staging_dir: str,
        validator=None, source_for=None, reload_kwargs: dict | None = None,
    ):
        self.registry = registry
        self.pools = pools
        self.router = router
        self.staging_dir = staging_dir
        self._validator = validator or _default_validator
        self._source_for = source_for or (lambda path, fp: path)
        self._reload_kwargs = dict(reload_kwargs or {})
        os.makedirs(staging_dir, exist_ok=True)

    # -- edge auth glue --

    def tenant_for(self, client: str | None):
        """The edge's authenticated client label -> Tenant (the edge
        token map comes from ``registry.tokens()``, so the label IS
        the tenant name); None for unauthenticated or unbound."""
        if not client:
            return None
        return self.registry.get(client)

    def pool_for_client(self, client: str | None) -> str | None:
        tenant = self.tenant_for(client)
        return tenant.pool if tenant is not None else None

    # -- route table sync --

    def sync_routes(self, fingerprints: dict | None = None) -> None:
        """Seed the router's corpus-tag routes from the registry:
        every tenant name and pool name routes to its pool, plus any
        known fingerprint (``fingerprints`` maps pool -> fp for
        topologies where the caller already knows what each pool
        serves, e.g. the selftests and boot-time CLI)."""
        for tenant in self.registry.tenants().values():
            self.router.set_corpus_route(tenant.name, tenant.pool)
            self.router.set_corpus_route(tenant.pool, tenant.pool)
            fp = (fingerprints or {}).get(tenant.pool) or tenant.fingerprint
            if fp:
                self._install_fingerprint(tenant.pool, fp, old=None)

    def _install_fingerprint(
        self, pool: str, fp: str, *, old: str | None
    ) -> None:
        if old and old != fp:
            self.router.drop_corpus_route(old)
            self.router.drop_corpus_route(old[:12])
        self.router.set_corpus_route(fp, pool)
        if len(fp) > 12:
            self.router.set_corpus_route(fp[:12], pool)
        self.router.set_pool_fingerprint(pool, fp)

    # -- the onboarding pipeline --

    def stage(self, data: bytes, name: str | None = None) -> str:
        digest = hashlib.sha256(data).hexdigest()[:16]
        base = os.path.basename(name) if name else "corpus.npz"
        path = os.path.join(self.staging_dir, f"{digest}-{base}")
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return path

    def upload(self, tenant_name: str, data: bytes,
               name: str | None = None) -> dict:
        """The whole pipeline for one authenticated upload.  Runs on
        an edge ops thread; the only event-loop interaction is through
        ``reload_fleet``'s own oneshot connections."""
        tenant = self.registry.get(tenant_name)
        if tenant is None:
            raise OnboardError(
                "unknown_tenant", f"no tenant named {tenant_name!r}"
            )
        staged = self.stage(data, name)
        try:
            fingerprint = self._validator(staged)
        except (ArtifactError, OSError, ValueError) as exc:
            raise OnboardError("corpus_invalid", str(exc))
        if not isinstance(fingerprint, str) or not fingerprint:
            raise OnboardError(
                "corpus_invalid", "validator yielded no fingerprint"
            )
        source = self._source_for(staged, fingerprint)
        return self._roll(tenant, source, fingerprint, staged=staged)

    def _roll(self, tenant, source: str, fingerprint: str, *,
              staged: str | None = None) -> dict:
        old_fp = tenant.fingerprint
        self.registry.record_roll(
            "roll_start", tenant.name, corpus=source,
            fingerprint=fingerprint, staged=staged,
        )
        # disarm the router's per-pool fingerprint fence for the roll
        # window: a mid-roll pool serves old AND new fingerprints, and
        # either is the right answer until the swap completes
        self.router.set_pool_fingerprint(tenant.pool, None)
        try:
            result = self.pools.reload_fleet(
                source, pool=tenant.pool, **self._reload_kwargs
            )
        except Exception as exc:
            self.router.set_pool_fingerprint(tenant.pool, old_fp)
            self.registry.record_roll(
                "roll_failed", tenant.name, reason=str(exc)
            )
            raise
        if not result.get("ok"):
            # a refused roll leaves the pool on (or rolled back to)
            # its previous corpus: re-arm the fence where it was
            self.router.set_pool_fingerprint(tenant.pool, old_fp)
            reason = str(result.get("error") or "reload failed")
            self.registry.record_roll(
                "roll_failed", tenant.name, reason=reason
            )
            if reason.startswith("fleet_reload_in_progress"):
                raise OnboardError("fleet_reload_in_progress", reason)
            raise OnboardError("reload_failed", reason)
        self.registry.record_roll(
            "roll_done", tenant.name, fingerprint=fingerprint
        )
        self.registry.update_corpus(tenant.name, source, fingerprint)
        self._install_fingerprint(tenant.pool, fingerprint, old=old_fp)
        return {
            "tenant": tenant.name,
            "pool": tenant.pool,
            "fingerprint": fingerprint,
            "corpus": source,
            "workers": sorted(result.get("workers") or ()),
        }

    def recover(self) -> list[dict]:
        """Replay rolls a crash interrupted: every journaled
        ``roll_start`` without a terminal record is re-validated and
        re-rolled (reload is idempotent — a pool already on the target
        fingerprint rolls to itself)."""
        results = []
        for row in self.registry.pending_rolls():
            tenant = self.registry.get(row.get("tenant") or "")
            source = row.get("corpus")
            fingerprint = row.get("fingerprint")
            if tenant is None or not isinstance(source, str):
                continue
            if not isinstance(fingerprint, str) or not fingerprint:
                continue
            try:
                results.append(
                    self._roll(tenant, source, fingerprint,
                               staged=row.get("staged"))
                )
            except OnboardError as exc:
                results.append({
                    "tenant": tenant.name, "recovered": False,
                    "reason": str(exc),
                })
        return results
