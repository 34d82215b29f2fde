"""The fleet router: one client-facing socket fronting N serve workers
— least-loaded dispatch, health-checked failover, backpressure-aware
retries, and tail-cutting hedged requests, all carried by ONE
single-threaded non-blocking event loop (serve/eventloop.py).

Dean & Barroso's "The Tail at Scale" is the playbook:

* **least-loaded routing** — each request goes to the healthy,
  non-draining worker with the lowest load score (probed
  ``queue_depth + in_flight`` plus the router's own outstanding count
  for that worker; the local term keeps bursts spread even between
  probe rounds).
* **failover on death** — classification requests are pure functions
  of content (the content-hash cache key IS the idempotency proof), so
  a request whose worker dies mid-flight is simply retried on another
  replica.  The client sees one answer, never a connection reset.
* **backpressure failover** — a worker answering ``queue_full`` sheds
  load; the router tries the next replica and only surfaces
  ``queue_full`` (with the smallest ``retry_after``) when EVERY
  replica is shedding.
* **hedged requests** — optionally, a duplicate is sent to a second
  worker once the first has been out longer than the observed p95
  (``hedge_ms="auto"``) or a fixed delay; the first answer wins.  The
  duplicate costs the twin a device slot only for content it has never
  seen: a blob already cached or in flight there coalesces via the
  content-hash key (ResultCache/MicroBatcher), and otherwise the extra
  load is bounded by the hedge rate (~5% at a p95-derived delay).  The
  loser's late answer is discarded when it eventually arrives.

**The I/O core.**  Every client connection, every backend connection,
every health probe, and every timeout is a callback on one
``selectors`` event loop — no thread is ever parked on a socket, so a
slow or dead backend can never stall an unrelated client.  Requests
are **pipelined** onto a bounded per-worker connection pool
(``pool_per_worker``): a backend connection carries many in-flight
requests at once, correlated back to their clients by FIFO order (the
worker answers in request order by contract) and cross-checked against
the trace ID the wire protocol carries — a response echoing the wrong
trace is a protocol violation that kills the connection and fails its
in-flight requests over rather than ever answering the wrong client.
A connection that dies with requests in flight fails ALL of them over;
a request that times out closes its (head-of-line-blocked) connection,
failing the requests queued behind it over too.

Trace IDs are minted HERE and forwarded on the wire (``"trace"``
field); the worker adopts the ID (obs/tracing.py), so the router tail
shows ``route``/``hedge``/``failover`` spans and the worker tail shows
the serving spans — same 16-hex handle end to end.

Threading contract: the request state machines live on the loop thread
and need no locks.  ``dispatch()`` is the blocking facade (submit via
``call_soon_threadsafe``, wait on an event); ``stats()`` /
``outstanding()`` / ``pick()`` snapshot loop-owned state via
``run_sync``.  Long ops verbs (the fan-out Prometheus scrape, the
rolling fleet reload) run on a small ops executor, never on the loop.
The analyzer's ``blocking-call`` rule walks every loop callback in
this module: a blocking primitive on the loop thread is a CI finding.
"""

from __future__ import annotations

import json
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import re

from licensee_tpu_torch.fleet.wire import (
    ConnectionPool,
    WireError,
    json_str_field,
    oneshot,
)
from licensee_tpu_torch.obs import (
    AnomalyWatchdog,
    FlatlineRule,
    Observability,
    QueryError,
    RateJumpRule,
    SaturationRule,
    ScrapeScheduler,
    SLOEngine,
    TraceCollector,
    TsdbStore,
    merge_expositions,
    pool_objectives,
    router_objectives,
)
from licensee_tpu_torch.serve.eventloop import (
    EventLoop,
    LineConn,
    LoopClosedError,
    LoopJsonlServer,
    connect_target,
    drop_close,
    drop_line,
)
from licensee_tpu_torch.serve.stats import LatencyStats

# how long a no-backend request waits between re-pick attempts while
# the whole fleet is down (a restart may bring a worker back before
# the dispatch deadline) — a timer wakeup, never a parked thread
_REPICK_DELAY_S = 0.05

# wire trace IDs are 64-bit, rendered 16-hex — same space the tracer
# mints from (obs/tracing.py); the mint-only fast path masks into it
_WIRE_MASK = 0xFFFFFFFFFFFFFFFF

# error codes a FEDERATED backend (a per-host router fronting its own
# worker domain) answers when ITS domain momentarily has no capacity —
# to the tier above they mean "this host cannot serve this request
# right now", i.e. attempt failure with failover to another host, never
# a client-visible row.  A plain worker mints none of these, so the
# single-host path is untouched.
_FEDERATED_FAILOVER_CODES = frozenset(
    ("no_backend_available", "router_closed", "router_not_started")
)

# an upstream hop's trace ID: 16 lowercase hex (the worker's adoption
# grammar, serve/server.py TRACE_ID_RE)
_TRACE_ID_RE = re.compile(r"\A[0-9a-f]{16}\Z")


def _fp_compatible(got: str, want: str) -> bool:
    """Fingerprint identity across stamp conventions: real workers
    stamp the SHORT (12-hex) fingerprint on response rows while the
    route table may hold the full 64-hex form (and stub workers stamp
    whatever ``--fingerprint`` string they were booted with) — a
    prefix match in either direction is the same corpus, anything else
    is a worker on the wrong fingerprint."""
    return got == want or got.startswith(want) or want.startswith(got)


class _Attempt:
    """One request sent to one backend connection: the FIFO entry that
    a response line (or a connection death, or a timeout) resolves.
    ``deadline`` is the monotonic instant the router's timeout sweep
    declares this attempt head-of-line dead — one periodic sweep over
    the FIFO heads replaces the timer-per-attempt heap churn that was
    measurable at saturation."""

    __slots__ = ("request", "backend", "conn", "is_hedge", "resolved",
                 "deadline")

    def __init__(self, request: "_Request", backend: "Backend",
                 is_hedge: bool):
        self.request = request
        self.backend = backend
        self.conn: "_BackendConn | None" = None
        self.is_hedge = is_hedge
        self.resolved = False
        self.deadline = 0.0


class _Request:
    """One routed client request's event-loop state machine.

    ``msg`` may be None: the front session's fast path skips the
    client-line parse for content rows, and :attr:`rid` then parses the
    wire line lazily — only the rare finishing paths (queue_full,
    deadline, error rows, slow exemplars) ever need the request id."""

    __slots__ = ("msg", "wire_line", "trace", "wire_trace",
                 "tried", "queue_full_rows", "arms", "t0", "deadline",
                 "hedge_timer", "hedge_started", "first_round",
                 "finished", "last_reason", "on_done", "repick_timer",
                 "pool")

    def __init__(self, msg: dict | None, wire_line: str, trace,
                 wire_trace, on_done, pool=None):
        self.msg = msg
        self.pool = pool
        self.wire_line = wire_line
        self.trace = trace
        self.wire_trace = wire_trace
        self.tried: set[str] = set()
        self.queue_full_rows: list[dict] = []
        self.arms: list[_Attempt] = []
        self.t0 = 0.0
        self.deadline = 0.0
        self.hedge_timer = None
        self.hedge_started = False
        self.first_round = True
        self.finished = False
        self.last_reason = "no healthy backend"
        self.on_done = on_done
        self.repick_timer = None

    @property
    def rid(self):
        if self.msg is None:
            try:
                parsed = json.loads(self.wire_line)
                self.msg = parsed if isinstance(parsed, dict) else {}
            except ValueError:
                self.msg = {}
        return self.msg.get("id")


class _BackendConn:
    """One pipelined JSONL connection to a worker: a FIFO of in-flight
    attempts, resolved strictly in order as response lines arrive (the
    worker's in-order session contract), each response cross-checked
    against the trace ID its request carried."""

    __slots__ = ("router", "backend", "state", "fifo", "line_conn",
                 "_pending_lines", "_abort_connect")

    def __init__(self, router: "Router", backend: "Backend"):
        self.router = router
        self.backend = backend
        self.state = "connecting"
        self.fifo: deque[_Attempt] = deque()
        self.line_conn: LineConn | None = None
        self._pending_lines: list[str] = []
        self._abort_connect = connect_target(
            router.loop, backend.socket_path, router.probe_timeout_s,
            self._on_connected, self._on_connect_error,
        )

    def inflight(self) -> int:
        return len(self.fifo)

    def send(self, attempt: _Attempt) -> None:
        attempt.conn = self
        if self.state == "closed":
            # the dial failed synchronously (ECONNREFUSED on a freshly
            # killed worker's stale socket): buffering here would strand
            # the attempt forever — fail it over NOW instead
            self.router._attempt_resolved(
                attempt, "fail",
                f"{self.backend.name}: connection already closed",
            )
            return
        self.fifo.append(attempt)
        line = attempt.request.wire_line
        if self.state == "open":
            try:
                self.line_conn.write_line_on_loop(line)
            except OSError:
                pass  # close already failed the FIFO over
        else:
            self._pending_lines.append(line)

    # -- loop callbacks --

    def _on_connected(self, sock) -> None:
        self.state = "open"
        self.line_conn = LineConn(
            self.router.loop, sock,
            on_line=self._on_line, on_close=self._on_close,
        )
        pending, self._pending_lines = self._pending_lines, []
        for line in pending:
            try:
                self.line_conn.write_line_on_loop(line)
            except OSError:
                return

    def _on_connect_error(self, exc: Exception) -> None:
        self.state = "closed"
        self._fail_over(f"connect failed: {exc}")

    def _on_line(self, text: str) -> None:
        if not self.fifo:
            self.close("response with no request in flight")
            return
        attempt = self.fifo.popleft()
        expected = attempt.request.wire_trace
        # the hot path avoids a json.loads per response: the trace
        # cross-check and the queue_full/error detection run as
        # substring probes on the raw line (a 16-hex trace ID cannot
        # appear by accident), and the full parse happens only on the
        # rare paths — backpressure rows, protocol violations, and the
        # blocking dispatch() facade's caller thread
        if (
            expected is not None
            and '"trace"' in text
            and expected not in text
        ):
            # pipelining's integrity check: the worker's in-order
            # contract says this response belongs to the FIFO head, but
            # the echoed trace disagrees — the stream is out of sync.
            # Never deliver a mis-correlated verdict: fail this attempt
            # over and burn the connection (its position is unknowable).
            try:
                got = json.loads(text).get("trace")
            except (ValueError, AttributeError):
                got = "<unparseable>"
            self.router._attempt_resolved(
                attempt, "fail",
                f"{self.backend.name}: trace mismatch "
                f"(sent {expected}, response echoes {got})",
            )
            self.close("pipelined response trace mismatch")
            return
        if (
            '"error"' in text
            or '"id"' not in text
            or not text.endswith("}")
        ):
            try:
                row = json.loads(text)
                if not isinstance(row, dict):
                    raise ValueError("response must be a JSON object")
            except ValueError as exc:
                # the head attempt is already popped: fail it over with
                # everything behind it — the stream is unreadable
                self.router._attempt_resolved(
                    attempt, "fail",
                    f"{self.backend.name}: bad response line: {exc}",
                )
                self.close(f"bad response line: {exc}")
                return
            err = row.get("error")
            if isinstance(err, str) and (
                err.split(":", 1)[0] in _FEDERATED_FAILOVER_CODES
            ):
                # cross-host federation: a per-host router reporting
                # "my domain has no backend" (worker mid-restart,
                # domain draining) is a failed ATTEMPT at this tier —
                # fail over to another host instead of relaying the
                # error to the client
                self.router._attempt_resolved(
                    attempt, "fail",
                    f"{self.backend.name}: federated backend answered "
                    f"{err}",
                )
                return
            outcome = "queue_full" if err == "queue_full" else "ok"
            self.router._attempt_resolved(attempt, outcome, row, text)
            return
        self.router._attempt_resolved(attempt, "ok", None, text)

    def _on_close(self, reason) -> None:
        self.state = "closed"
        self._fail_over(f"connection lost: {reason}")

    def _fail_over(self, why: str) -> None:
        if self in self.backend.conns:
            self.backend.conns.remove(self)
        pending, self.fifo = list(self.fifo), deque()
        for attempt in pending:
            self.router._attempt_resolved(
                attempt, "fail", f"{self.backend.name}: {why}"
            )

    def close(self, reason: str | None = None) -> None:
        if self.state == "closed":
            return
        if self.state == "connecting":
            self.state = "closed"
            self._abort_connect()
            # abort fires _on_connect_error -> _fail_over, but only for
            # a still-pending dial; a raced completion lands in a
            # "closed" conn whose fifo we still own
            self._fail_over(reason or "closed")
            return
        self.state = "closed"
        conn, self.line_conn = self.line_conn, None
        if conn is not None:
            # LineConn.close fires _on_close exactly once -> _fail_over
            conn.on_close = self._on_close
            conn.close(reason)


class Backend:
    """The router's view of one worker: connection pool, probed load,
    and per-backend counters.  Loop-thread-owned; the metrics collector
    and ``as_dict`` read the plain ints lock-free (GIL-atomic)."""

    def __init__(self, name: str, socket_path: str):
        self.name = name
        self.socket_path = socket_path
        self.pool: str | None = None  # tenant pool (multi-pool fleets)
        self.conns: list[_BackendConn] = []
        self.healthy = False
        self.probed_load = 0
        self.probe_failures = 0
        self.probe_rounds = 0
        self.outstanding = 0  # routed requests in flight right now
        self.dispatched = 0
        self.ok = 0
        self.failed = 0
        self.queue_full = 0
        self.last_stats: dict = {}
        # probe plumbing (loop-owned)
        self.probe_conn: LineConn | None = None
        self.probe_abort = None
        self.probe_inflight = False
        self.probe_deadline = 0.0

    def load(self) -> int:
        return self.probed_load + self.outstanding

    def pool_inflight(self) -> int:
        return sum(c.inflight() for c in list(self.conns))

    def acquire_conn(self, router: "Router") -> _BackendConn:
        """The pipelining pool policy: reuse an idle connection, grow
        the pool while every connection is busy and the bound allows,
        else pipeline onto the least-loaded connection.  One pass, one
        ``len`` per connection — this runs once per request at
        saturation, where the two-comprehension version was
        measurable."""
        least = None
        least_n = 0
        closed_seen = False
        for conn in self.conns:
            if conn.state == "closed":
                # a dial that failed synchronously closes the conn
                # before (or despite) its place in the pool list —
                # prune below, never reuse
                closed_seen = True
                continue
            n = len(conn.fifo)
            if n == 0 and conn.state == "open":
                if closed_seen:
                    self.conns = [
                        c for c in self.conns if c.state != "closed"
                    ]
                return conn
            if least is None or n < least_n:
                least = conn
                least_n = n
        if closed_seen:
            self.conns = [c for c in self.conns if c.state != "closed"]
        if len(self.conns) < router.pool_per_worker:
            conn = _BackendConn(router, self)
            if conn.state != "closed":  # a sync dial failure stays out
                self.conns.append(conn)
            return conn
        return least

    def close_conns(self) -> None:
        for conn in list(self.conns):
            conn.close("router shutdown")
        self.conns.clear()
        if self.probe_conn is not None:
            conn, self.probe_conn = self.probe_conn, None
            conn.close("router shutdown")
        if self.probe_abort is not None:
            abort, self.probe_abort = self.probe_abort, None
            abort()

    def as_dict(self) -> dict:
        row = {
            "socket": self.socket_path,
            "healthy": self.healthy,
            "probed_load": self.probed_load,
            "outstanding": self.outstanding,
            "dispatched": self.dispatched,
            "ok": self.ok,
            "failed": self.failed,
            "queue_full": self.queue_full,
            "pool_conns": len(self.conns),
            "pool_inflight": self.pool_inflight(),
        }
        if self.pool is not None:
            row["pool"] = self.pool
        return row


class Router:
    """Dispatch requests across the worker fleet; serve the front
    socket.

    ``backends`` maps worker name -> socket path.  ``supervisor`` is
    optional: when given, its draining/stopped flags veto dispatch (the
    drain protocol) and the supervisor reads ``outstanding()`` back.
    ``hedge_ms`` is ``None``/"off" (no hedging), a number (fixed delay
    in ms), or "auto" (the p95 of recent request latencies, floored at
    ``hedge_floor_ms``).  ``pool_per_worker`` bounds the pipelined
    connection pool each backend may grow."""

    def __init__(
        self,
        backends: dict[str, str],
        *,
        supervisor=None,
        probe_interval_s: float = 0.25,
        probe_timeout_s: float = 2.0,
        request_timeout_s: float = 30.0,
        dispatch_wait_s: float = 15.0,
        hedge_ms=None,
        hedge_floor_ms: float = 5.0,
        hedge_min_samples: int = 20,
        max_concurrency: int = 1024,
        pool_per_worker: int = 4,
        registry=None,
        tracing: bool = True,
        trace_sample: float = 0.01,
        trace_slow_ms: float = 250.0,
        merge_label: str = "worker",
        scrape_interval_s: float = 5.0,
        store: "TsdbStore | None" = None,
        watchdog_rules=None,
        pools: dict[str, str] | None = None,
        default_pool: str = "default",
    ):
        if not backends:
            raise ValueError("need at least one backend")
        if hedge_ms in ("off", "none"):
            hedge_ms = None
        if hedge_ms is not None and hedge_ms != "auto":
            hedge_ms = float(hedge_ms)
            if not (hedge_ms >= 0):
                raise ValueError(f"hedge_ms must be >= 0, got {hedge_ms!r}")
        if int(pool_per_worker) < 1:
            raise ValueError(
                f"pool_per_worker must be >= 1, got {pool_per_worker!r}"
            )
        self.hedge_ms = hedge_ms
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.hedge_min_samples = int(hedge_min_samples)
        self.supervisor = supervisor
        if supervisor is not None:
            supervisor.router = self
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self.dispatch_wait_s = float(dispatch_wait_s)
        self.max_concurrency = int(max_concurrency)
        self.pool_per_worker = int(pool_per_worker)
        # the label prometheus() tags each scraped backend's exposition
        # with: "worker" for a single-host fleet, "host" for the
        # federation tier (each backend is then a per-host router whose
        # exposition is already worker-labeled — the merge nests host
        # OUTSIDE worker, obs/export.merge_expositions)
        self.merge_label = str(merge_label)
        self.backends: dict[str, Backend] = {
            name: Backend(name, path)
            for name, path in backends.items()
        }
        # the tenancy plane: ``pools`` maps worker name -> pool name
        # (heterogeneous fleets serving different corpora side by
        # side); dispatch, failover, and hedging are then confined to
        # the request's pool.  ``_corpus_routes`` maps a request's
        # corpus tag (tenant name, pool name, full or short
        # fingerprint) to its pool; ``_pool_fps`` holds each pool's
        # expected fingerprint for response verification.  Both tables
        # are plain dicts written by ops threads (onboarding rolls)
        # and read per-request on the loop — GIL-atomic replace-only
        # updates, same discipline as the loop-owned counters.
        self.default_pool = str(default_pool)
        self.pools_active = bool(pools)
        self._corpus_routes: dict[str, str] = {}
        self._pool_fps: dict[str, str] = {}
        self._pool_counts: dict[tuple[str, str], int] = {}
        if pools:
            unknown = sorted(set(pools) - set(self.backends))
            if unknown:
                raise ValueError(
                    f"pools names unknown workers: {unknown}"
                )
            for name, backend in self.backends.items():
                backend.pool = pools.get(name, self.default_pool)
            if not any(
                b.pool == self.default_pool
                for b in self.backends.values()
            ):
                raise ValueError(
                    f"default pool {self.default_pool!r} has no "
                    "workers (untagged traffic would never dispatch)"
                )
            for pool in set(pools.values()):
                self._corpus_routes.setdefault(pool, pool)
        self.loop = EventLoop(name="fleet-router")
        self._latency = LatencyStats(capacity=1024)
        self._hedge_p95_cache: tuple[float, float] | None = None
        # loop-owned request accounting
        self._counters = {
            "requests": 0,
            "ok": 0,
            "failovers": 0,
            "retries": 0,
            "hedges_started": 0,
            "hedges_won": 0,
            "hedges_lost": 0,
            "queue_full_failovers": 0,
            "queue_full_returned": 0,
            "no_backend": 0,
            "unknown_corpus": 0,
        }
        self._active = 0
        self._admission: deque = deque()
        # every admitted, unfinished request — the shutdown path must
        # be able to answer requests parked on a repick timer, which
        # are reachable from nowhere else once their timer is dropped
        self._inflight: set = set()
        self._draining = False
        self._probe_timer = None
        self._first_probe_round = threading.Event()
        self._started = False
        self._closing = False
        self.obs = Observability(
            registry,
            tracing=tracing,
            trace_sample=trace_sample,
            trace_slow_ms=trace_slow_ms,
            trace_proc="router",
        )
        # the mint-only fast path: with head sampling off the router
        # still needs a wire trace ID per request (pipelining
        # correlation), but nothing else — mint IDs from a loop-owned
        # counter and skip the Trace object, its spans, and the
        # tracer's lock entirely.  Slow exemplars stay honest via
        # Tracer.note_slow from the measured request latency.
        self._mint_only = self.obs.tracer.mint_only
        self._wire_seq = 0
        self._wire_base = random.Random().getrandbits(64)
        self._timeout_sweep_timer = None
        # the ops lane: long front-socket verbs (the fan-out Prometheus
        # scrape, the rolling fleet reload) block BY DESIGN — they run
        # here, never on the loop
        self._ops = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="fleet-ops"
        )
        self._register_metrics()
        # the retained telemetry plane (obs/tsdb.py): a scrape round
        # every scrape_interval_s pulls each worker's exposition over a
        # parked wire connection plus the router's own registry
        # in-process, all on the ops executor — the store behind the
        # {"op": "query"} verb, /metrics/history, the SLO burn windows,
        # and the anomaly watchdog.  scrape_interval_s <= 0 keeps the
        # store but never starts the cadence thread (benches drive
        # scrape_once() by hand to isolate its cost).
        self.scrape_interval_s = float(scrape_interval_s)
        self.store = store if store is not None else TsdbStore()
        self.store.register_metrics(self.obs.registry)
        self._scrape_pools = {
            name: ConnectionPool(
                b.socket_path, max_idle=1,
                connect_timeout=self.probe_timeout_s,
            )
            for name, b in self.backends.items()
        }
        self.scraper = ScrapeScheduler(
            self.store,
            interval_s=max(self.scrape_interval_s, 0.05),
            label=self.merge_label,
            executor=self._ops,
            on_round=self._watchdog_round,
        )
        self.scraper.register_metrics(self.obs.registry)
        self.scraper.add_target("router", self._own_exposition)
        for name in self.backends:
            self.scraper.add_target(
                name, lambda n=name: self._scrape_backend(n)
            )
        self.watchdog = AnomalyWatchdog(
            self.store,
            (
                watchdog_rules
                if watchdog_rules is not None
                else self._default_watchdog_rules()
            ),
            registry=self.obs.registry,
        )
        # the fleet SLO engine (obs/slo.py): availability + p99 over
        # the router counters, attached AFTER _register_metrics so the
        # collector pass syncs counters before each evaluation.  Burn
        # windows read the telemetry store (the router's own series
        # land there labeled merge_label="router"); the private sample
        # ring stays as the fallback until the store has coverage.
        objectives = router_objectives()
        if self.pools_active:
            # one latency objective per tenant pool over the
            # pool-labeled histogram: B's burn gauge witnesses that
            # rolling A's pool never touched B's tail
            objectives += pool_objectives(
                {b.pool for b in self.backends.values()}
            )
        self.slo = SLOEngine(
            self.obs.registry, objectives,
            store=self.store,
            store_labels={self.merge_label: "router"},
        ).attach()
        # the telemetry-plane collector (obs/collect.py): the router's
        # own tail plus a {"op":"trace"} pull per worker, joined by
        # trace ID into assembled trees.  Pulls are BLOCKING fan-outs —
        # assembled_traces runs on the ops executor / caller threads,
        # never on the event loop (same contract as prometheus()).
        self.collector = TraceCollector(root_proc="router")
        self.collector.add_source(
            "router", lambda: self.obs.tracer.tail(200)
        )
        for name, backend in self.backends.items():
            self.collector.add_source(
                name,
                lambda b=backend: self._pull_worker_tail(b),
            )

    # -- metrics --

    def _register_metrics(self) -> None:
        reg = self.obs.registry
        reg.gauge(
            "fleet_backends_healthy",
            "Workers currently answering health probes",
        ).set_fn(
            lambda: sum(1 for b in self.backends.values() if b.healthy)
        )
        reg.gauge(
            "fleet_backends_total", "Workers configured behind the router"
        ).set(len(self.backends))
        reg.gauge(
            "fleet_outstanding",
            "Routed requests in flight across all workers",
        ).set_fn(
            lambda: sum(b.outstanding for b in self.backends.values())
        )
        reg.gauge(
            "fleet_loop_lag_ms",
            "Smoothed router event-loop lag (heartbeat lateness); a "
            "blocked loop grows this before the tail latencies do",
        ).set_fn(self.loop.lag_ms)
        reg.gauge(
            "fleet_loop_max_lag_ms",
            "Decaying max of the router event-loop lag",
        ).set_fn(self.loop.max_lag_ms)
        events = reg.counter(
            "fleet_requests_total",
            "Router lifecycle events by kind (requests, ok, failovers, "
            "retries, hedges_started, hedges_won, hedges_lost, "
            "queue_full_failovers, queue_full_returned, no_backend, "
            "unknown_corpus)",
            labels=("event",),
        )
        # labeled "backend", not "worker": the fleet scrape merges this
        # registry under an injected worker="router" label, and a
        # sample carrying its own "worker" label would emit a duplicate
        # label name — which a real Prometheus server rejects
        per_worker = reg.counter(
            "fleet_backend_requests_total",
            "Routed requests by backend worker and outcome",
            labels=("backend", "outcome"),
        )
        pool_conns = reg.gauge(
            "fleet_pool_connections",
            "Open pipelined connections per backend worker",
            labels=("backend",),
        )
        pool_inflight = reg.gauge(
            "fleet_pool_inflight",
            "Requests in flight on the pipelined pool per backend",
            labels=("backend",),
        )
        hist = reg.histogram(
            "fleet_request_seconds",
            "Client-visible routed request latency (retries and hedges "
            "included)",
        )
        # the solo child, resolved ONCE: family.observe() walks
        # labels() -> dict lookup per call, which is measurable at
        # per-request rates on the loop thread
        self._latency_hist = hist.labels()
        # the tenancy plane's metrics exist only on multi-pool fleets:
        # a single-corpus fleet's exposition is byte-identical to
        # before the subsystem existed
        self._pool_hists: dict[str, object] = {}
        pool_events = None
        if self.pools_active:
            pool_names = sorted(
                {b.pool for b in self.backends.values() if b.pool}
            )
            pool_hist = reg.histogram(
                "fleet_tenant_request_seconds",
                "Routed request latency by tenant pool (retries and "
                "hedges included)",
                labels=("pool",),
            )
            # children resolved once per pool, same reasoning as the
            # solo fleet_request_seconds child above
            self._pool_hists = {
                p: pool_hist.labels(pool=p) for p in pool_names
            }
            pool_events = reg.counter(
                "fleet_tenant_requests_total",
                "Tenant-pool routing events by pool and kind (ok, "
                "corpus_mismatch, unknown_corpus)",
                labels=("pool", "event"),
            )

        def collect(_reg) -> None:
            # loop-owned ints read lock-free: a torn read is impossible
            # under the GIL, and a scrape tolerates one-event staleness
            for k, v in dict(self._counters).items():
                events.labels(event=k).sync(v)
            for name, b in list(self.backends.items()):
                per_worker.labels(backend=name, outcome="ok").sync(b.ok)
                per_worker.labels(backend=name, outcome="failed").sync(
                    b.failed
                )
                per_worker.labels(backend=name, outcome="queue_full").sync(
                    b.queue_full
                )
                pool_conns.labels(backend=name).set(len(b.conns))
                pool_inflight.labels(backend=name).set(b.pool_inflight())
            if pool_events is not None:
                for (pool, event), v in list(self._pool_counts.items()):
                    pool_events.labels(pool=pool, event=event).sync(v)

        reg.add_collector(collect)

    def _bump_pool(self, pool: str | None, event: str) -> None:
        # loop-owned tenancy counters; the collector pass syncs them
        # into fleet_tenant_requests_total
        key = (pool or self.default_pool, event)
        self._pool_counts[key] = self._pool_counts.get(key, 0) + 1

    # -- telemetry plane --

    def _own_exposition(self) -> str:
        """The router registry's exposition for the scrape scheduler —
        in-process, no socket; lands in the store under
        ``{merge_label: "router"}``."""
        return self.obs.prometheus()

    def _scrape_backend(self, name: str) -> str:
        """One worker's exposition over its parked scrape connection
        (fleet/wire ConnectionPool: the connection survives between
        rounds).  Raises on any failure — the scheduler counts it a
        miss and the worker's stored series go stale, which is exactly
        what the flatline watchdog rule watches."""
        row = self._scrape_pools[name].request(
            {"op": "stats", "format": "prometheus"},
            timeout=self.probe_timeout_s,
        )
        text = row.get("prometheus")
        if not isinstance(text, str):
            raise WireError(f"no prometheus text from {name}: {row}")
        return text

    def _watchdog_round(self) -> None:
        # runs at the end of every scrape round, on the ops executor
        self.watchdog.evaluate()

    def _default_watchdog_rules(self) -> list:
        """The stock fleet rule set: p99 jump on the routed latency
        histogram, scrape flatline per worker, saturation-approach on
        the bounded occupancy gauges.  Rules over series the fleet
        never stores simply never fire."""
        interval = max(self.scrape_interval_s, 0.05)
        rules = [
            RateJumpRule(
                "router_p99_latency_jump",
                "fleet_request_seconds",
                labels={self.merge_label: "router"},
                signal="quantile",
                q=0.99,
                window_s=max(4.0 * interval, 2.0),
                baseline_windows=8,
                min_baseline=4,
                z_threshold=4.5,
                min_value=0.005,
                description="routed p99 jumped vs its trailing baseline",
            ),
            SaturationRule(
                "edge_queue_saturation",
                "edge_queue_depth",
                threshold=64.0,
                description="HTTP edge queue depth approaching overflow",
            ),
            SaturationRule(
                "pipeline_featurize_saturation",
                "pipeline_featurize_busy",
                threshold=0.95,
                description="featurize lane occupancy near saturation",
            ),
        ]
        for name in self.backends:
            rules.append(FlatlineRule(
                f"worker_scrape_flatline_{name}",
                "tsdb_scrape_up",
                labels={self.merge_label: name},
                stale_after_s=max(3.5 * interval, 5.0),
                description=(
                    f"worker {name} stopped answering telemetry scrapes"
                ),
            ))
        return rules

    # -- lifecycle --

    def start(self) -> None:
        """Start the loop and the probe machinery; returns once the
        first probe round has resolved (success or failure) for every
        backend, so ``pick()`` has a health view immediately.
        Idempotent: a second start() (manual start + ``__enter__``)
        must not arm a SECOND self-rescheduling probe/sweep chain."""
        if self._started:
            return
        self._started = True
        self.loop.start()
        self.loop.call_soon_threadsafe(self._probe_tick)
        self.loop.call_soon_threadsafe(self._arm_timeout_sweep)
        if self.scrape_interval_s > 0:
            self.scraper.start()
        self._first_probe_round.wait(self.probe_timeout_s + 2.0)

    def close(self) -> None:
        self.scraper.stop()
        try:
            self.loop.run_sync(self._shutdown_on_loop)
        except (LoopClosedError, TimeoutError):
            pass
        self.loop.stop()
        self._ops.shutdown(wait=False)
        self.collector.close()
        for pool in self._scrape_pools.values():
            pool.close()

    def _shutdown_on_loop(self) -> None:
        self._closing = True
        if self._probe_timer is not None:
            self._probe_timer.cancel()
            self._probe_timer = None
        if self._timeout_sweep_timer is not None:
            self._timeout_sweep_timer.cancel()
            self._timeout_sweep_timer = None
        # answer EVERY waiting client before the loop stops: requests
        # still in the admission queue, and admitted requests parked on
        # a repick timer (no attempt in any FIFO — close_conns would
        # never reach them, and loop.stop() drops their timers)
        while self._admission:
            req = self._admission.popleft()
            row = {"id": req.rid, "error": "router_closed"}
            if req.trace is not None:
                self.obs.tracer.finish(req.trace, "router_closed")
            if req.wire_trace is not None:
                row["trace"] = req.wire_trace
            self._deliver(req, row, admitted=False)
        for req in list(self._inflight):
            self._finish_error(req, "router_closed")
        for backend in self.backends.values():
            backend.close_conns()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- health probes (event-loop state machine) --

    def _probe_tick(self) -> None:
        """One probe pass: time out overdue probes, send fresh ones on
        the persistent per-backend probe connections."""
        if self._closing:
            return
        now = time.perf_counter()
        for backend in self.backends.values():
            if backend.probe_inflight:
                if now >= backend.probe_deadline:
                    self._probe_failed(backend, close_conn=True)
            else:
                self._probe_send(backend)
        self._probe_timer = self.loop.call_later(
            self.probe_interval_s, self._probe_tick
        )

    def _probe_send(self, backend: Backend) -> None:
        backend.probe_inflight = True
        backend.probe_deadline = (
            time.perf_counter() + self.probe_timeout_s
        )
        if backend.probe_conn is None:
            if backend.probe_abort is None:
                backend.probe_abort = connect_target(
                    self.loop, backend.socket_path, self.probe_timeout_s,
                    lambda sock, b=backend: self._probe_connected(b, sock),
                    lambda exc, b=backend: self._probe_conn_failed(b),
                )
            return
        try:
            backend.probe_conn.write_line('{"op": "stats"}')
        except OSError:
            self._probe_failed(backend, close_conn=True)

    def _probe_connected(self, backend: Backend, sock) -> None:
        backend.probe_abort = None
        backend.probe_conn = LineConn(
            self.loop, sock,
            on_line=lambda text, b=backend: self._probe_line(b, text),
            on_close=lambda reason, b=backend: self._probe_closed(b),
        )
        if backend.probe_inflight:
            try:
                backend.probe_conn.write_line('{"op": "stats"}')
            except OSError:
                self._probe_failed(backend, close_conn=True)

    def _probe_conn_failed(self, backend: Backend) -> None:
        backend.probe_abort = None
        if backend.probe_inflight:
            self._probe_failed(backend, close_conn=False)

    def _probe_closed(self, backend: Backend) -> None:
        backend.probe_conn = None
        if backend.probe_inflight:
            self._probe_failed(backend, close_conn=False)

    def _probe_line(self, backend: Backend, text: str) -> None:
        try:
            row = json.loads(text)
            stats = row.get("stats") or {}
            sched = stats.get("scheduler") or {}
            load = int(sched.get("queue_depth") or 0) + int(
                sched.get("in_flight") or 0
            )
        except (ValueError, TypeError, AttributeError):
            self._probe_failed(backend, close_conn=True)
            return
        backend.probe_inflight = False
        backend.probe_failures = 0
        backend.healthy = True
        backend.probed_load = load
        backend.last_stats = stats
        self._probe_round_done(backend)

    def _probe_failed(self, backend: Backend, close_conn: bool) -> None:
        backend.probe_inflight = False
        backend.probe_failures += 1
        backend.healthy = False
        if close_conn:
            if backend.probe_conn is not None:
                conn, backend.probe_conn = backend.probe_conn, None
                conn.on_close = drop_close
                conn.close("probe failed")
            if backend.probe_abort is not None:
                abort, backend.probe_abort = backend.probe_abort, None
                abort()
        self._probe_round_done(backend)

    def _probe_round_done(self, backend: Backend) -> None:
        backend.probe_rounds += 1
        if all(b.probe_rounds > 0 for b in self.backends.values()):
            self._first_probe_round.set()

    # -- dispatch decision (loop thread; public facade below) --

    def _pick(self, exclude=frozenset(), pool=None) -> str | None:
        # a single hand-rolled min pass: this runs once per request at
        # saturation, where two list comprehensions plus a keyed min
        # were measurable
        supervisor = self.supervisor
        best_name = None
        best_load = 0
        for name, b in self.backends.items():
            if name in exclude or not b.healthy:
                continue
            if pool is not None and b.pool != pool:
                # tenancy isolation: failover and hedging never leave
                # the request's pool — a worker on another corpus
                # fingerprint is not a replica, whatever its load
                continue
            if supervisor is not None and not supervisor.dispatchable(
                name
            ):
                continue
            load = b.probed_load + b.outstanding
            if (
                best_name is None
                or load < best_load
                or (load == best_load and name < best_name)
            ):
                best_name = name
                best_load = load
        return best_name

    def pick(self, exclude=frozenset(), pool=None) -> str | None:
        """The least-loaded healthy, non-draining worker outside
        ``exclude`` — the dispatch decision: the router's probed health
        view plus the supervisor's drain/stop veto (confined to
        ``pool`` on a multi-pool fleet)."""
        try:
            return self.loop.run_sync(self._pick, exclude, pool)
        except (LoopClosedError, TimeoutError):
            return self._pick(exclude, pool)

    # -- tenancy route table (written by ops threads; read per-request
    #    on the loop — replace-only dict updates, GIL-atomic) --

    def set_corpus_route(self, tag: str, pool: str) -> None:
        """Bind a corpus tag (tenant name, pool name, full or short
        fingerprint) to a pool; tagged rows and tenant-bound HTTP
        traffic route through this table."""
        self._corpus_routes[tag] = pool

    def drop_corpus_route(self, tag: str) -> None:
        self._corpus_routes.pop(tag, None)

    def set_pool_fingerprint(self, pool: str, fp: str | None) -> None:
        """The fingerprint responses from ``pool`` must stamp; a row
        answering with any other fingerprint is failed over inside the
        pool instead of ever reaching the client.  ``None`` disarms
        the fence (a mid-roll pool legitimately serves old AND new
        fingerprints until the roll completes)."""
        if fp is None:
            self._pool_fps.pop(pool, None)
        else:
            self._pool_fps[pool] = fp

    def pool_fingerprints(self) -> dict[str, str]:
        return dict(self._pool_fps)

    def resolve_pool(self, tag: str | None) -> str | None:
        """Corpus tag -> pool, or None for an unroutable tag (the
        default pool when untagged)."""
        if tag is None:
            return self.default_pool if self.pools_active else None
        return self._corpus_routes.get(tag)

    def outstanding(self, name: str | None = None) -> int:
        """Routed requests currently in flight (one worker, or all) —
        the supervisor's drain barrier reads this."""

        def _read() -> int:
            if name is not None:
                backend = self.backends.get(name)
                return backend.outstanding if backend is not None else 0
            return sum(b.outstanding for b in self.backends.values())

        try:
            return self.loop.run_sync(_read)
        except (LoopClosedError, TimeoutError):
            return _read()

    # -- the request state machine (loop thread) --

    def _submit(self, msg: dict | None, raw_line: str, on_done,
                pool: str | None = None) -> None:
        """Loop-thread entry: admit one routed request.  ``msg`` may be
        None (the front session's no-parse fast path); the request id
        is then recovered lazily, only on paths that need it.  ``pool``
        pins the request to one tenant pool (the HTTP edge resolves it
        from the bearer token's tenant binding); JSONL rows resolve
        their own ``"corpus"`` tag below."""
        self._counters["requests"] += 1
        # cross-tier trace ADOPTION: a line that already carries a
        # valid 16-hex trace (a FRONT router federating this one, or
        # any upstream hop) keeps it — this router re-minting would
        # break the upstream tier's pipelining cross-check AND split
        # the assembled telemetry tree at the host boundary.  Same
        # adoption grammar the worker applies (serve/server.py).
        adopted = None
        if '"trace"' in raw_line:
            if msg is None:
                # a line carrying "trace" anywhere must be PARSED: the
                # worker adopts the TOP-LEVEL field, and a textual scan
                # (json_str_field) cannot tell a nested occurrence
                # apart — adopting a value the worker will not echo
                # would burn the pipelined connection on every
                # cross-check.  Only trace-carrying lines pay this
                # parse; plain content rows keep the no-parse path.
                try:
                    parsed = json.loads(raw_line)
                    msg = parsed if isinstance(parsed, dict) else {}
                except ValueError:
                    msg = {}
            tid = msg.get("trace")
            if isinstance(tid, str) and _TRACE_ID_RE.match(tid):
                adopted = tid
        if self._mint_only:
            # head sampling is off: no Trace object can ever be
            # retained at start, so mint the wire-correlation ID from
            # the loop-owned counter and skip the tracer entirely
            trace = None
            if adopted is not None:
                wire_trace = adopted
            else:
                self._wire_seq += 1
                wire_trace = (
                    f"{(self._wire_base + self._wire_seq) & _WIRE_MASK:016x}"
                )
        else:
            if msg is None:
                try:
                    parsed = json.loads(raw_line)
                    msg = parsed if isinstance(parsed, dict) else {}
                except ValueError:
                    msg = {}
            trace = self.obs.tracer.start(msg.get("id"), trace_id=adopted)
            wire_trace = trace.trace_id if trace is not None else None
        if wire_trace is None or adopted is not None:
            # adopted: the line already carries this exact trace —
            # splicing would only duplicate it
            wire_line = raw_line
        else:
            # splice the minted trace into the raw line instead of
            # re-serializing the whole object (a dict copy + dumps per
            # request is measurable at saturation).  A client-supplied
            # "trace" key becomes a duplicate; JSON parsers take the
            # LAST occurrence, so the router's ID still wins — same
            # override {**msg, "trace": ...} used to perform.
            stripped = raw_line.rstrip()
            if stripped.endswith("}") and not stripped.endswith("{}"):
                wire_line = (
                    f'{stripped[:-1]},"trace":"{wire_trace}"}}'
                )
            else:
                wire_line = json.dumps(
                    {**(msg or {}), "trace": wire_trace}
                )
        if self.pools_active:
            if pool is None and '"corpus"' in raw_line:
                # corpus-tagged row: the tag must be PARSED for the
                # same reason a trace-carrying line is (a textual scan
                # cannot tell a nested occurrence apart) — only tagged
                # rows pay this parse, untagged traffic keeps the
                # no-parse fast path and lands on the default pool
                if msg is None:
                    try:
                        parsed = json.loads(raw_line)
                        msg = parsed if isinstance(parsed, dict) else {}
                    except ValueError:
                        msg = {}
                tag = msg.get("corpus")
                if isinstance(tag, str) and tag:
                    pool = self._corpus_routes.get(tag)
                    if pool is None:
                        self._counters["unknown_corpus"] += 1
                        if trace is not None:
                            self.obs.tracer.finish(
                                trace, "unknown_corpus"
                            )
                        req = _Request(
                            msg, wire_line, trace, wire_trace, on_done
                        )
                        self._deliver(req, {
                            "id": req.rid,
                            "error": f"unknown_corpus: no pool serves "
                            f"corpus tag {tag!r}",
                        }, admitted=False)
                        return
            if pool is None:
                pool = self.default_pool
        else:
            pool = None
        req = _Request(msg, wire_line, trace, wire_trace, on_done, pool)
        if self._closing:
            self._deliver(req, {"id": req.rid, "error": "router_closed"},
                          admitted=False)
            return
        if self._active >= self.max_concurrency:
            self._admission.append(req)
            return
        self._begin(req)

    def _begin(self, req: _Request) -> None:
        self._active += 1
        self._inflight.add(req)
        req.t0 = time.perf_counter()
        req.deadline = req.t0 + self.dispatch_wait_s
        self._dispatch_round(req)

    def _dispatch_round(self, req: _Request) -> None:
        req.repick_timer = None
        if req.finished:
            return
        if self._closing:
            self._finish_error(req, "router_closed")
            return
        now = time.perf_counter()
        if now >= req.deadline:
            self._finish_deadline(req)
            return
        name = self._pick(exclude=req.tried, pool=req.pool)
        if name is None:
            if req.queue_full_rows:
                # no untried replica left and at least one answered
                # queue_full: surface the backpressure NOW — the
                # client's retry_after backoff beats burning the
                # dispatch window hammering shedding workers
                self._finish_queue_full(req)
                return
            if req.tried:
                # every current backend failed this request; a restart
                # may bring one back before the deadline
                req.tried.clear()
            req.repick_timer = self.loop.call_later(
                _REPICK_DELAY_S, self._dispatch_round, req
            )
            return
        if not req.first_round:
            self._counters["retries"] += 1
        req.first_round = False
        self._send_arm(req, name, is_hedge=False)

    def _send_arm(self, req: _Request, name: str, is_hedge: bool) -> None:
        req.tried.add(name)
        backend = self.backends[name]
        if req.trace is not None:
            req.trace.add_span(
                "hedge" if is_hedge else "route", 0.0,
                note=f"to={name} load={backend.load()}",
            )
        attempt = _Attempt(req, backend, is_hedge)
        req.arms.append(attempt)
        backend.outstanding += 1
        backend.dispatched += 1
        # deadline BEFORE send: a synchronously-failing send resolves
        # the attempt re-entrantly; the periodic sweep only ever sees
        # unresolved FIFO entries, each already stamped
        attempt.deadline = time.perf_counter() + self.request_timeout_s
        backend.acquire_conn(self).send(attempt)
        if attempt.resolved or req.finished:
            return
        if not is_hedge and not req.hedge_started:
            delay = self._hedge_delay_s()
            if delay is not None:
                req.hedge_timer = self.loop.call_later(
                    delay, self._hedge_fire, req
                )

    def _arm_timeout_sweep(self) -> None:
        """(Re)arm the attempt-timeout sweep.  One periodic timer for
        the whole router replaces a ``call_later`` + ``cancel`` per
        request — at saturation that heap churn was one of the largest
        single per-request costs.  FIFO order makes the sweep O(pool):
        attempts on one connection share a timeout, so only each FIFO
        HEAD can be the oldest — precision is the sweep period (at most
        ``request_timeout_s/8``), fine for a seconds-scale backstop."""
        if self._closing:
            return
        period = max(0.05, min(self.request_timeout_s / 8.0, 0.5))
        self._timeout_sweep_timer = self.loop.call_later(
            period, self._timeout_sweep
        )

    def _timeout_sweep(self) -> None:
        now = time.perf_counter()
        for backend in self.backends.values():
            for conn in list(backend.conns):
                fifo = conn.fifo
                if fifo and fifo[0].deadline <= now:
                    self._attempt_timeout(fifo[0])
        self._arm_timeout_sweep()

    def _attempt_timeout(self, attempt: _Attempt) -> None:
        if attempt.resolved:
            return
        conn = attempt.conn
        if conn is not None and conn.state != "closed":
            # the connection is head-of-line blocked on this request:
            # closing it fails this attempt AND everything queued
            # behind it over to other replicas
            conn.close(
                f"request timeout after {self.request_timeout_s}s"
            )
        if not attempt.resolved:
            # belt and braces: an attempt must NEVER outlive its
            # deadline unresolved (a stranded request would hang its
            # client)
            self._attempt_resolved(
                attempt, "fail",
                f"{attempt.backend.name}: request timeout after "
                f"{self.request_timeout_s}s",
            )

    def _hedge_fire(self, req: _Request) -> None:
        req.hedge_timer = None
        if req.finished or self._closing:
            return
        second = self._pick(exclude=req.tried, pool=req.pool)
        if second is None:
            return
        self._counters["hedges_started"] += 1
        req.hedge_started = True
        self._send_arm(req, second, is_hedge=True)

    def _hedge_delay_s(self) -> float | None:
        """Seconds to wait before hedging, or None (hedging off / not
        enough samples yet for the auto p95)."""
        if self.hedge_ms is None or len(self.backends) < 2:
            return None
        if self.hedge_ms != "auto":
            return float(self.hedge_ms) / 1000.0
        # the auto p95 snapshot sorts the latency reservoir — too much
        # per-request work at saturation, so memoize for 50 ms
        now = time.perf_counter()
        cached = self._hedge_p95_cache
        if cached is not None and now - cached[0] < 0.05:
            return cached[1]
        snap = self._latency.snapshot()
        if (snap["count"] or 0) < self.hedge_min_samples:
            delay = None
        else:
            delay = max(snap["p95_ms"], self.hedge_floor_ms) / 1000.0
        self._hedge_p95_cache = (now, delay)
        return delay

    def _attempt_resolved(
        self, attempt: _Attempt, outcome: str, payload, text=None
    ) -> None:
        """One arm came back: a response row ("ok"/"queue_full") or a
        death ("fail", payload is the reason string).  ``text`` is the
        raw response line when one exists — the serialization fast path
        for front sessions."""
        if attempt.resolved:
            return
        attempt.resolved = True
        backend = attempt.backend
        backend.outstanding -= 1
        # tenancy's last line of defense: a row answering with the
        # wrong corpus fingerprint (a worker mid-roll, a stale pool)
        # must NEVER reach the client — fail it over inside the pool
        # like a dead backend.  The fence is read LIVE at completion
        # time (not captured at submit): an onboarding roll disarms/
        # re-arms it mid-flight, and a request admitted before the
        # roll must be judged against what the pool serves NOW, not
        # what it served when the request was queued.
        want_fp = (
            self._pool_fps.get(attempt.request.pool)
            if attempt.request.pool is not None else None
        )
        if (
            outcome == "ok"
            and want_fp is not None
            and not attempt.request.finished
        ):
            # fast path (payload is None): extract the system-minted
            # stamp textually, exactly like the HTTP edge's X-Corpus
            # echo
            got = (
                payload.get("corpus") if payload is not None
                else json_str_field(text, "corpus") if text is not None
                else None
            )
            if (
                isinstance(got, str) and got
                and not _fp_compatible(got, want_fp)
            ):
                self._bump_pool(attempt.request.pool, "corpus_mismatch")
                outcome = "fail"
                payload = (
                    f"corpus fingerprint mismatch (want "
                    f"{want_fp[:12]}, row stamps {got[:12]})"
                )
                text = None
        if outcome == "ok":
            backend.ok += 1
        elif outcome == "queue_full":
            backend.queue_full += 1
        else:
            backend.failed += 1
            backend.healthy = False  # fail fast until a probe clears it
        req = attempt.request
        if req.finished:
            return  # a hedge loser's late answer: discarded
        if outcome == "ok":
            self._finish_ok(req, payload, attempt, text)
            return
        if outcome == "queue_full":
            req.queue_full_rows.append(payload)
            self._counters["queue_full_failovers"] += 1
            if req.trace is not None:
                req.trace.add_span(
                    "failover", 0.0,
                    note=f"queue_full from {backend.name}",
                )
        else:
            req.last_reason = str(payload)
            self._counters["failovers"] += 1
            if req.trace is not None:
                req.trace.add_span(
                    "failover", 0.0,
                    note=f"{backend.name}: {req.last_reason[:120]}",
                )
        if any(not a.resolved for a in req.arms):
            return  # a twin is still racing: let it finish
        if req.hedge_timer is not None:
            req.hedge_timer.cancel()
            req.hedge_timer = None
        # every arm is dead: the next retry round starts from scratch
        # and may arm a FRESH hedge (the per-round racing semantics of
        # the old inline core) — the post-failover straggler window is
        # exactly where tail-cutting pays
        req.hedge_started = False
        self._dispatch_round(req)

    # -- finishing --

    def _finish_ok(self, req: _Request, payload: dict,
                   attempt: _Attempt, text=None) -> None:
        if req.hedge_started:
            self._counters[
                "hedges_won" if attempt.is_hedge else "hedges_lost"
            ] += 1
        dt = time.perf_counter() - req.t0
        self._latency.record(dt)
        # the wire trace ID rides as the histogram bucket's exemplar:
        # the exposition's slowest-bucket `# {trace_id="..."}` then
        # resolves via `traces --id` to this request's assembled tree
        self._latency_hist.observe(dt, exemplar=req.wire_trace)
        if req.pool is not None:
            pool_hist = self._pool_hists.get(req.pool)
            if pool_hist is not None:
                pool_hist.observe(dt)
            self._bump_pool(req.pool, "ok")
        self._counters["ok"] += 1
        if req.trace is not None:
            self.obs.tracer.finish(req.trace, "ok")
        elif self._mint_only and dt * 1000.0 >= self.obs.tracer.slow_ms:
            # no Trace object on the mint-only path — retain the slow
            # exemplar (span-less) from the measured latency instead
            self.obs.tracer.note_slow(
                req.wire_trace, req.rid, req.t0, dt
            )
        # the serialization fast path: splice "worker" into the raw
        # response line instead of parsing + re-dumping the row — front
        # sessions write this text verbatim, and the blocking
        # dispatch() facade parses it on ITS thread, never the loop.
        # ``payload is None`` marks the fast path (_on_line verified
        # the line carries id + matching trace and no error field).
        if payload is None:
            out_text = (
                f'{text[:-1]},"worker":"{attempt.backend.name}"}}'
            )
            self._deliver(req, None, out_text)
            return
        payload.setdefault("id", req.rid)
        payload["worker"] = attempt.backend.name
        out_text = None
        if (
            text is not None
            and text.endswith("}")
            and '"id"' in text
        ):
            out_text = (
                f'{text[:-1]},"worker":"{attempt.backend.name}"}}'
            )
        self._deliver(req, payload, out_text)

    def _finish_queue_full(self, req: _Request) -> None:
        self._counters["queue_full_returned"] += 1
        if req.trace is not None:
            self.obs.tracer.finish(req.trace, "queue_full")
        row = min(
            req.queue_full_rows,
            key=lambda r: r.get("retry_after") or float("inf"),
        )
        row.setdefault("id", req.rid)
        self._deliver(req, row)

    def _finish_deadline(self, req: _Request) -> None:
        if req.queue_full_rows:
            self._finish_queue_full(req)
            return
        self._counters["no_backend"] += 1
        if req.trace is not None:
            self.obs.tracer.finish(req.trace, "no_backend")
        row = {
            "id": req.rid,
            "error": f"no_backend_available: {req.last_reason}",
        }
        if req.wire_trace is not None:
            row["trace"] = req.wire_trace
        self._deliver(req, row)

    def _finish_error(self, req: _Request, error: str) -> None:
        row = {"id": req.rid, "error": error}
        if req.trace is not None:
            self.obs.tracer.finish(req.trace, error)
        if req.wire_trace is not None:
            row["trace"] = req.wire_trace
        self._deliver(req, row)

    def _deliver(self, req: _Request, row: dict, text=None,
                 admitted: bool = True) -> None:
        if req.finished:
            return
        req.finished = True
        for timer in (req.hedge_timer, req.repick_timer):
            if timer is not None:
                timer.cancel()
        req.hedge_timer = req.repick_timer = None
        if admitted:
            self._active -= 1
            self._inflight.discard(req)
            if not self._draining:
                # a synchronously-finishing _begin (shutdown, instant
                # error) re-enters _deliver; the guard leaves the drain
                # to the OUTERMOST frame so a deep admission backlog
                # cannot grow the stack
                self._draining = True
                try:
                    while (
                        self._admission
                        and self._active < self.max_concurrency
                    ):
                        self._begin(self._admission.popleft())
                finally:
                    self._draining = False
        try:
            req.on_done(row, text)
        except Exception:  # noqa: BLE001 — a dead client must not kill the loop
            pass

    # -- blocking facade (any thread) --

    def dispatch(self, msg: dict) -> dict:
        """Route one classification request and block for its row —
        the cross-thread facade over the event-loop state machine.
        Always returns a response row for the client."""
        if not self._started:
            # no loop thread exists to run the state machine — fail
            # fast instead of stalling out the dispatch budget
            return {"id": msg.get("id"), "error": "router_not_started"}
        done = threading.Event()
        box: dict = {}

        def on_done(row, text=None) -> None:
            # fast-path deliveries carry only the spliced line; the
            # parse happens HERE, on the caller's thread, not the loop
            box["row"] = row
            box["text"] = text
            done.set()

        raw_line = json.dumps(msg)
        if not self.loop.call_soon_threadsafe(
            self._submit, msg, raw_line, on_done
        ):
            return {"id": msg.get("id"), "error": "router_closed"}
        # the state machine always answers by dispatch deadline +
        # request timeout; the margin covers admission queueing
        budget = self.dispatch_wait_s + self.request_timeout_s + 60.0
        if not done.wait(budget):
            return {
                "id": msg.get("id"),
                "error": f"internal_error: dispatch stalled > {budget}s",
            }
        row = box["row"]
        if row is None:
            try:
                row = json.loads(box["text"])
            except ValueError:
                # a worker line that slipped the fast-path substring
                # heuristics but is not JSON: an error row, never an
                # exception out of the blocking facade
                row = {"id": msg.get("id"),
                       "error": "internal_error: unparseable worker "
                       "response"}
        return row

    # -- ops surface (front-socket verbs + CLI) --

    def stats(self) -> dict:
        def _snapshot() -> dict:
            return {
                "counters": dict(self._counters),
                "backends": {
                    name: b.as_dict()
                    for name, b in self.backends.items()
                },
                "active": self._active,
                "admission_queued": len(self._admission),
            }

        try:
            snap = self.loop.run_sync(_snapshot)
        except (LoopClosedError, TimeoutError):
            snap = _snapshot()
        backends = snap["backends"]
        host_health = None
        if self.supervisor is not None:
            sup = self.supervisor.status()
            for name, row in backends.items():
                row["supervisor"] = sup.get(name)
            host_health = self.supervisor.host_health()
        # domain load in WORKER-stats shape: a front router federating
        # this router over TCP probes it with the exact depth math it
        # uses on a worker (fleet/router._probe_line reads
        # stats.scheduler.queue_depth + in_flight) — queue_depth is the
        # admission backlog plus every probed/outstanding request in
        # the domain, in_flight is the router's active count
        domain_depth = snap["admission_queued"] + sum(
            (row["probed_load"] + row["outstanding"])
            for row in backends.values()
        )
        result = {
            "uptime_s": self.obs.uptime_s(),
            "scheduler": {
                "queue_depth": domain_depth,
                "in_flight": snap["active"],
                "completed": snap["counters"]["ok"],
            },
            "host": host_health,
            "router": {
                **snap["counters"],
                "latency_ms": self._latency.snapshot(),
                "hedge_ms": self.hedge_ms,
                "active": snap["active"],
                "admission_queued": snap["admission_queued"],
                "loop_lag_ms": self.loop.lag_ms(),
                "loop_max_lag_ms": self.loop.max_lag_ms(),
                "pool_per_worker": self.pool_per_worker,
            },
            "backends": backends,
            "tracing": self.obs.tracer.stats(),
            # the fleet SLO verdict (multi-window burn over the router
            # counters) + the trace collector's accounting
            "slo": self.slo.snapshot(),
            "collector": self.collector.stats(),
            # the retained telemetry plane: store occupancy, scrape
            # cadence health, and the watchdog's active-alert count
            # (full alert detail is the {"op": "alerts"} verb)
            "tsdb": {
                **self.store.stats(),
                "scrape": self.scraper.stats(),
            },
            "alerts": {
                "active": len(self.watchdog.active()),
                "fired_total": self.watchdog.snapshot()["fired_total"],
            },
        }
        if self.pools_active:
            pools: dict[str, dict] = {}
            for name, row in backends.items():
                pool = row.get("pool")
                if pool is None:
                    continue
                entry = pools.setdefault(
                    pool,
                    {"workers": [],
                     "fingerprint": self._pool_fps.get(pool)},
                )
                entry["workers"].append(name)
            result["tenancy"] = {
                "default_pool": self.default_pool,
                "pools": pools,
                "corpus_routes": len(self._corpus_routes),
                "events": {
                    f"{pool}:{event}": v
                    for (pool, event), v in sorted(
                        self._pool_counts.items()
                    )
                },
            }
        return result

    def prometheus(self) -> str:
        """The FLEET exposition: the router's own registry plus a live
        scrape of every backend's exposition, merged with one label per
        source (obs/export.py) — ``worker`` on a single-host fleet,
        ``host`` on the federation tier, where each backend's scrape is
        already worker-labeled and the merge nests host outside
        worker."""
        per_source = {"router": self.obs.prometheus()}
        for name, backend in self.backends.items():
            try:
                # a fleet scrape IS a synchronous fan-out by contract:
                # it runs on the ops executor (front sessions) or the
                # caller's thread (CLI), never on the event loop — the
                # cross-module walk proves no loop callback reaches
                # here (ops-executor thunks are not loop edges)
                row = oneshot(
                    backend.socket_path,
                    {"op": "stats", "format": "prometheus"},
                    self.probe_timeout_s,
                )
            except WireError:
                continue  # a dead worker exports nothing this scrape
            text = row.get("prometheus")
            if isinstance(text, str):
                per_source[name] = text
        return merge_expositions(per_source, label=self.merge_label)

    def trace_tail(self, n: int = 20) -> list[dict]:
        return self.obs.tracer.tail(n)

    def _pull_worker_tail(self, backend: Backend) -> list[dict]:
        """One worker's retained-trace tail for the collector; a dead
        or restarting worker contributes nothing this pull."""
        try:
            row = oneshot(
                backend.socket_path, {"op": "trace", "n": 200},
                self.probe_timeout_s,
            )
        except WireError:
            return []
        tail = row.get("traces")
        return tail if isinstance(tail, list) else []

    def assembled_traces(
        self, n: int = 20, *, trace_id: str | None = None
    ) -> list[dict]:
        """The cross-process telemetry view: pull every tail, join by
        trace ID, return assembled trees (slowest first) with
        critical-path self-times (the ``{"op": "traces"}`` front verb
        and the ``licensee-tpu-torch traces`` CLI).  Blocking fan-out — ops
        executor or a caller thread, never the event loop."""
        self.collector.pull()
        return self.collector.assembled(n, trace_id=trace_id)

    def reload_fleet(self, corpus: str, pool: str | None = None) -> dict:
        """The front-door rolling corpus reload: delegates to the
        attached supervisor's health-gated, rollback-capable
        ``reload_fleet`` (fleet/supervisor.py) — one ops verb swaps the
        whole fleet with zero downtime.  On a multi-pool fleet
        (tenancy/pools.py) ``pool`` confines the roll to one tenant's
        workers; the other pools keep serving untouched."""
        if self.supervisor is None:
            raise RuntimeError(
                "no supervisor attached; reload workers directly"
            )
        if pool is not None:
            return self.supervisor.reload_fleet(corpus, pool=pool)
        return self.supervisor.reload_fleet(corpus)



# front-session inbound flow control: above HIGH queued response slots
# the client socket read pauses (the kernel buffer then pushes back on
# an open-loop client outrunning the fleet), resuming below LOW
_SESSION_HIGH = 1024
_SESSION_LOW = 256


class _FrontSession:
    """One client session on the front socket, entirely on the router's
    event loop: parse lines, dispatch concurrently, answer IN REQUEST
    ORDER (same contract as a worker session, so clients cannot tell a
    router from a worker).

    Each request occupies one slot in an ordered queue; content rows
    dispatch immediately and fill their slot whenever they finish,
    while ops verbs (stats/trace/prometheus/reload) start only when
    their slot reaches the HEAD — so a stats row reports "as of this
    point in the session", exactly like the old writer thread."""

    def __init__(self, router: Router, server: "FrontServer",
                 conn: LineConn):
        self.router = router
        self.server = server
        self.conn = conn
        self.slots: deque[dict] = deque()
        self.paused = False
        conn.on_line = self.handle_line
        conn.on_close = self._on_close

    def _on_close(self, _reason) -> None:
        self.server.forget_connection(self.conn)
        self.slots.clear()  # in-flight fills find no slot: dropped

    def _push(self, kind: str, payload=None, row=None) -> None:
        self.slots.append(
            {"kind": kind, "payload": payload, "row": row,
             "text": None, "started": False}
        )
        if not self.paused and len(self.slots) > _SESSION_HIGH:
            self.paused = True
            self.conn.pause_reading()
        self._flush()

    def _submit_content(self, line: str, msg: dict | None = None) -> None:
        """Queue a content row's slot and dispatch it — unlike _push
        the slot is born started (routing begins now, not at the head)
        and nothing flushes until the dispatch fills it."""
        slot = {"kind": "content", "payload": None, "row": None,
                "text": None, "started": True}
        self.slots.append(slot)
        if not self.paused and len(self.slots) > _SESSION_HIGH:
            self.paused = True
            self.conn.pause_reading()
        self.router._submit(
            msg, line,
            lambda row, text=None, s=slot: self._fill(s, row, text),
        )

    def _fill(self, slot: dict, row: dict, text=None) -> None:
        slot["row"] = row
        slot["text"] = text
        self._flush()

    def _flush(self) -> None:
        """Write every ready head slot; start the head ops verb when it
        surfaces.  Iterative (never recursive): a burst of inline ops
        verbs must not grow the stack."""
        while self.slots:
            head = self.slots[0]
            if head["row"] is None and head["text"] is None:
                if not head["started"]:
                    self._start_op(head)  # inline ops fill head now
                if head["row"] is None and head["text"] is None:
                    return  # waiting on a dispatch or a deferred op
            self.slots.popleft()
            try:
                # the router spliced a ready-to-write line for routed
                # content rows; ops verbs and error rows serialize here
                self.conn.write_line_on_loop(
                    head["text"] or json.dumps(head["row"])
                )
            except OSError:
                return  # client went away; _on_close drops the rest
            if self.paused and len(self.slots) < _SESSION_LOW:
                self.paused = False
                self.conn.resume_reading()

    def handle_line(self, line: str) -> None:
        line = line.strip()
        if not line:
            return
        if (
            '"op"' not in line
            and line.startswith("{")
            and line.endswith("}")
        ):
            # content-row fast path: without the '"op"' substring the
            # line cannot carry an ops verb, so skip the parse entirely
            # — the WORKER validates the payload anyway (one validator,
            # serve/server.py), including lines that turn out to be
            # malformed JSON.  At saturation the per-request
            # ``json.loads`` here was the single largest loop cost.
            self._submit_content(line)
            return
        try:
            msg = json.loads(line)
            if not isinstance(msg, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as exc:
            self._push("raw",
                       row={"id": None, "error": f"bad_request: {exc}"})
            return
        rid = msg.get("id")
        op = msg.get("op")
        if op is None:
            # content row: the WORKER validates the payload (one
            # validator, serve/server.py) — the router only owns routing
            self._submit_content(line, msg)
            return
        if op == "diff":
            # the word-diff verb is stateless, idempotent, and
            # answered by any worker from its serving corpus — relay
            # it exactly like a content row (the WORKER validates the
            # payload and echoes the spliced trace; failover/hedging
            # semantics apply unchanged)
            self._submit_content(line, msg)
            return
        if op == "stats":
            fmt = msg.get("format")
            if fmt not in (None, "json", "prometheus"):
                self._push("raw", row={
                    "id": rid,
                    "error": f"bad_request: unknown stats format {fmt!r}",
                })
            else:
                self._push(
                    "prometheus" if fmt == "prometheus" else "stats", rid
                )
        elif op == "trace":
            n = msg.get("n", 20)
            if isinstance(n, bool) or not isinstance(n, int) or n < 0:
                self._push("raw", row={
                    "id": rid,
                    "error": "bad_request: n must be a non-negative int",
                })
            else:
                self._push("trace", (rid, n))
        elif op == "traces":
            # the telemetry plane: assembled cross-process trace trees
            # (router tail + every worker tail joined by trace ID)
            n = msg.get("n", 20)
            tid = msg.get("trace_id")
            if isinstance(n, bool) or not isinstance(n, int) or n < 0:
                self._push("raw", row={
                    "id": rid,
                    "error": "bad_request: n must be a non-negative int",
                })
            elif tid is not None and not isinstance(tid, str):
                self._push("raw", row={
                    "id": rid,
                    "error": "bad_request: trace_id must be a hex "
                    "string prefix",
                })
            else:
                self._push("traces", (rid, n, tid))
        elif op == "reload":
            corpus = msg.get("corpus")
            pool = msg.get("pool")
            if not isinstance(corpus, str) or not corpus:
                self._push("raw", row={
                    "id": rid,
                    "error": "bad_request: reload needs a 'corpus' "
                    "source string",
                })
            elif pool is not None and (
                not isinstance(pool, str) or not pool
            ):
                self._push("raw", row={
                    "id": rid,
                    "error": "bad_request: reload 'pool' must be a "
                    "pool name string",
                })
            else:
                self._push("reload", (rid, corpus, pool))
        elif op == "query":
            # the telemetry-store verb: server-side rate/delta/quantile
            # over retained series (obs/tsdb.py) — param validation is
            # the store's (QueryError carries the wire error code)
            params = {
                k: v for k, v in msg.items() if k not in ("op", "id")
            }
            self._push("query", (rid, params))
        elif op == "alerts":
            self._push("alerts", rid)
        else:
            self._push("raw", row={
                "id": rid, "error": f"bad_request: unknown op {op!r}",
            })

    def _start_op(self, slot: dict) -> None:
        """Run the head slot's ops verb — it starts only once every
        earlier response has been written, so a stats row reports "as
        of this point in the session".  Cheap loop-state snapshots
        (trace) run inline; stats (supervisor lock), the fan-out
        scrape, and the rolling reload can block and go to the ops
        executor, filling their slot back via
        ``call_soon_threadsafe``."""
        slot["started"] = True
        kind = slot["kind"]
        if kind == "stats":
            rid = slot["payload"]
            # stats consults the supervisor, whose lock the monitor
            # thread holds ACROSS a worker respawn's fork+exec — a
            # stats verb landing in that window must wait on the ops
            # executor, never on the loop thread
            self._defer(slot, lambda: {
                "id": rid, "stats": self.router.stats()
            })
        elif kind == "trace":
            rid, n = slot["payload"]
            slot["row"] = {
                "id": rid, "traces": self.router.trace_tail(n)
            }
        elif kind == "traces":
            # the assembled-tree verb pulls every worker tail — a
            # blocking fan-out, ops executor only (like the scrape)
            rid, n, tid = slot["payload"]
            self._defer(slot, lambda: {
                "id": rid,
                "traces": self.router.assembled_traces(
                    n, trace_id=tid
                ),
            })
        elif kind == "prometheus":
            rid = slot["payload"]
            self._defer(slot, lambda: {
                "id": rid, "prometheus": self.router.prometheus()
            })
        elif kind == "reload":
            rid, corpus, pool = slot["payload"]

            def run_reload() -> dict:
                try:
                    return {"id": rid,
                            "reload": self.router.reload_fleet(
                                corpus, pool=pool
                            )}
                except Exception as exc:  # noqa: BLE001 — session containment
                    return {"id": rid, "error": f"reload_failed: {exc}"}

            self._defer(slot, run_reload)
        elif kind == "query":
            rid, params = slot["payload"]

            def run_query() -> dict:
                row = {"id": rid}
                try:
                    row["query"] = self.router.store.query(params)
                except QueryError as exc:
                    if exc.code == "unknown_series":
                        row["error"] = f"unknown_series: {exc}"
                    else:
                        row["error"] = f"bad_request: {exc}"
                return row

            self._defer(slot, run_query)
        elif kind == "alerts":
            rid = slot["payload"]

            def run_alerts() -> dict:
                row = {"id": rid}
                row["alerts"] = self.router.watchdog.snapshot()
                return row

            self._defer(slot, run_alerts)

    def _defer(self, slot: dict, fn) -> None:
        loop = self.router.loop

        def run() -> None:
            try:
                row = fn()
            except Exception as exc:  # noqa: BLE001 — session containment
                row = {"id": None, "error": f"internal_error: {exc}"}
            loop.call_soon_threadsafe(self._fill, slot, row)

        self.router._ops.submit(run)


class FrontServer(LoopJsonlServer):
    """The client-facing Unix socket: one JSONL session per connection,
    all sharing one router AND its event loop — accepts, reads, writes,
    dispatch, and slowloris reaping are all callbacks on the router's
    single loop thread."""

    def __init__(self, path: str, router: Router,
                 stall_timeout_s: float = 30.0):
        self.router = router
        router.loop.start()  # idempotent; the loop must carry accepts
        super().__init__(
            path, loop=router.loop, stall_timeout_s=stall_timeout_s
        )

    def handle_connection(self, sock) -> None:
        conn = LineConn(
            self.loop, sock, on_line=drop_line, on_close=drop_close
        )
        self.track_connection(conn)
        _FrontSession(self.router, self, conn)

