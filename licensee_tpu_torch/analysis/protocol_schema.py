"""The declared JSONL wire-protocol schema the contract checker
(rules_protocol.py) holds every surface to.

The protocol is hand-rolled and spoken INDEPENDENTLY by five code
paths — the event-loop router (fleet/router.py), the real serve worker
(serve/server.py), the protocol-faithful stub worker (fleet/faults.py),
the pooled probe/one-shot helpers (fleet/wire.py + supervisor), and the
``stats``/``fleet`` CLI clients — so the one honest definition of
"protocol-faithful" is a schema the analyzer can diff every surface
against.  Editing the wire format is a TWO-PLACE change by design:
the code and this schema, and CI fails until both moved.

``content`` is the implicit op: a request line with no ``"op"`` key and
a ``content``/``content_b64`` body.  Error codes travel as the
``"error"`` response field; a code with prose carries it after a colon
(``"bad_request: missing 'content'"``) and the checker matches on the
prefix.
"""

from __future__ import annotations

# request ops -> the request fields each may carry.  "content" is the
# op-less classification row.
REQUEST_OPS: dict[str, tuple[str, ...]] = {
    # "corpus" is the ROUTER-facing tenancy tag (tenant name, pool
    # name, or fingerprint): the fleet router resolves it to a worker
    # pool and strips nothing — workers ignore it, and the response
    # row's "corpus" field (the serving fingerprint) closes the loop
    "content": (
        "content", "content_b64", "id", "filename", "deadline_ms", "trace",
        "corpus",
    ),
    "stats": ("id", "format"),
    "trace": ("id", "n"),
    # the telemetry plane's assembled-tree verb: FRONT-socket only
    # (the router's collector joins every worker's "trace" tail) — a
    # plain worker answers bad_request, so the stub parity check
    # (worker vs stub) is untouched
    "traces": ("id", "n", "trace_id"),
    # the telemetry-store query verb: FRONT-socket only (the router
    # owns the TsdbStore the scrape scheduler feeds) — a plain worker
    # answers bad_request, same precedent as "traces"
    "query": (
        "id", "series", "fn", "window", "q", "labels", "by", "limit",
        "list", "match",
    ),
    # the anomaly watchdog's alert ledger: FRONT-socket only, no args
    "alerts": ("id",),
    # "pool" narrows a front-door reload to one tenant pool (tenancy
    # topologies only; a plain fleet treats its absence as "the fleet")
    "reload": ("id", "corpus", "pool"),
    # normalized blob vs closest (or named) template, rendered as an
    # inline word diff (serve/diffverb.py) — same content body as the
    # op-less classification row plus the optional comparison target.
    # Relayed THROUGH the fleet router like a content row (stateless,
    # idempotent, any worker answers), so it carries/echoes the
    # spliced "trace" the pipelining cross-check rides
    "diff": (
        "id", "content", "content_b64", "filename", "license", "trace",
    ),
}

# error codes a response row's "error" field may carry (prefix before
# the first ":"), and which surfaces may mint them
ERROR_CODES: tuple[str, ...] = (
    "bad_request",
    "internal_error",
    "queue_full",
    "reload_failed",
    "reload_in_progress",
    # the fleet-level roll mutex refusal, carried inside the reload
    # result object the front-door verb echoes to clients
    "fleet_reload_in_progress",
    "no_backend_available",
    "router_closed",
    "router_not_started",
    # the diff verb named a license key the corpus does not know
    "unknown_license",
    # -- the jobs tier (fleet/http_edge.py /jobs routes) --
    # the edge serves no jobs executor (fleet started without
    # --jobs-dir), or the executor is draining for shutdown
    "jobs_disabled",
    # GET/DELETE named a job id the journal has never seen
    "job_not_found",
    # results/containers requested before the job completed
    "job_not_done",
    # a telemetry-store query named a series the store never ingested
    # (distinct from bad_request: the query was well-formed, the data
    # is absent — HTTP maps it to 404, not 400)
    "unknown_series",
    # -- the tenancy tier (fleet/router.py + fleet/http_edge.py) --
    # a content row's "corpus" routing tag names no pool the router
    # serves (typo'd tenant name, rolled-away fingerprint)
    "unknown_corpus",
    # POST /corpus from an authenticated client bound to no registry
    # tenant — HTTP maps it to 403 (the token may still /classify)
    "unknown_tenant",
    # the uploaded artifact failed the validation gate (unreadable,
    # wrong format, or its payload no longer hashes to its manifest)
    "corpus_invalid",
    # the edge serves no tenant registry (fleet started without
    # --tenants); POST /corpus answers 503
    "tenancy_disabled",
)

# response-row fields a client may read; every one must have at least
# one producer somewhere in the program
RESPONSE_FIELDS: tuple[str, ...] = (
    "id",
    "key",
    "matcher",
    "confidence",
    "cached",
    "closest",
    "attribution",
    "corpus",
    "trace",
    "error",
    "retry_after",
    "problems",
    "stats",
    "prometheus",
    "traces",
    "reload",
    "diff",
    "query",
    "alerts",
)

# every wire "op" the checker enumerates: request verbs plus error
# codes (the error vocabulary is as much protocol as the verbs — a
# client that retries on "queue_full" must never meet a worker that
# spells it differently)
WIRE_OPS: tuple[str, ...] = tuple(REQUEST_OPS) + ERROR_CODES

# dict keys watched by the extraction pass: request fields, response
# fields, and the op discriminator itself
WATCHED_KEYS: frozenset[str] = frozenset(
    {"op"}
    | {f for fields in REQUEST_OPS.values() for f in fields}
    | set(RESPONSE_FIELDS)
)

# -- the HTTP edge surface (fleet/http_edge.py) ------------------------
#
# The network edge speaks HTTP/1.1 OUTSIDE and the JSONL protocol
# above INSIDE (a /classify body IS a content row, so the worker/stub
# parity checks cover the edge's inner face for free).  Its outer face
# is protocol too: the routes it serves and the status codes it may
# mint are declared here and diffed against the edge module's own
# ROUTES/STATUS_TEXT tables plus every request-line constant a client
# harness sends (rules_protocol.check_http_drift).

# (method, path) -> wire-level meaning.  ``{id}`` paths are templates:
# the edge parses the job id at runtime and serves the request under
# the template's declared route (client harnesses therefore build
# those request lines from variables, never literals).
HTTP_ROUTES: dict[tuple[str, str], str] = {
    ("POST", "/classify"): "content",
    ("GET", "/healthz"): "health",
    ("GET", "/metrics"): "prometheus",
    ("GET", "/metrics/history"): "metrics_history",
    ("POST", "/jobs"): "job_submit",
    ("GET", "/jobs/{id}"): "job_status",
    ("GET", "/jobs/{id}/results"): "job_results",
    ("GET", "/jobs/{id}/containers"): "job_containers",
    ("DELETE", "/jobs/{id}"): "job_cancel",
    ("POST", "/corpus"): "corpus_upload",
}

# every status code the edge may mint.  The backpressure contract maps
# here: queue_full -> 429 (+ Retry-After), router shutdown / a fleet
# with no dispatchable backend -> 503.  The jobs tier adds 202 (a
# submit/cancel accepted for async execution) and 409 (results asked
# of a job that has not completed).  The tenancy tier adds 403 (an
# authenticated token bound to no tenant asked to onboard a corpus)
# and reuses 409 for a roll already in flight.
HTTP_STATUS_CODES: tuple[int, ...] = (
    200, 202, 400, 401, 403, 404, 405, 409, 413, 429, 500, 503,
)

# role detection, by path basename: the real worker transport, the
# stub that must stay protocol-faithful to it, and the HTTP edge.
# Basenames (not full paths) so fixture programs can cast their own
# players.
WORKER_BASENAMES: tuple[str, ...] = ("server.py",)
STUB_BASENAMES: tuple[str, ...] = ("faults.py",)
EDGE_BASENAMES: tuple[str, ...] = ("http_edge.py",)

# modules that legitimately speak the wire protocol; facts found in
# other modules are ignored (a random dict with an "op" key in a
# corpus loader is not a wire request)
SURFACE_BASENAMES: tuple[str, ...] = (
    "router.py", "server.py", "faults.py", "wire.py", "supervisor.py",
    "selftest.py", "main.py", "bench.py", "batch.py", "scheduler.py",
    "eventloop.py", "http_edge.py",
)
