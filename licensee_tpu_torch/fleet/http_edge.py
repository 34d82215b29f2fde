"""The HTTP/1.1 network edge: a keep-alive front end for the fleet
router, carried entirely by the router's single-threaded event loop
(serve/eventloop.py) — no threads, no new dependencies, stdlib only.

``POST /classify`` maps one JSON body onto the existing JSONL request
schema (the body IS the content row; the router and workers validate it
exactly as they validate a socket line), pipelined over keep-alive
connections and answered strictly in request order — the same session
contract the JSONL front socket keeps.  The edge owns the three
client-facing policies the wire tier never needed:

* **auth** — per-client bearer tokens (``Authorization: Bearer <t>``);
  with tokens configured, a missing or unknown token answers 401 and
  the client identity for everything below is the token's name.
* **rate limits** — one token bucket per client (``rate_per_client``
  req/s, ``burst`` deep); an over-rate request answers 429 with a
  ``Retry-After`` naming the refill horizon.
* **fair queuing** — admitted requests drain through deficit
  round-robin per client (quantum in BODY BYTES, so a client posting
  fat blobs cannot crowd out one posting small ones), bounded by
  ``max_inflight`` dispatches into the router.

Backpressure translates, it never disconnects: the fleet's
``queue_full`` contract becomes 429 + ``Retry-After`` (the worker's
``retry_after`` hint, rounded up), router shutdown becomes 503.
Responses echo ``X-Trace-Id`` and ``X-Corpus`` headers from the wire
row, so the telemetry plane (the ``traces`` verb) spans the
edge: the header value IS the 16-hex trace handle the assembled trees
join on.  ``GET /healthz`` (unauthenticated — load-balancer probes)
reports domain health; ``GET /metrics`` serves the merged fleet
Prometheus exposition.

Framing errors answer then burn: an invalid request line, an oversized
body, or a malformed header block gets its status row and THEN the
connection closes — a peer whose framing is broken can never poison
the responses queued behind it.  Header or body dribble is reaped by
the same stall sweep that kills JSONL slowloris clients
(LoopJsonlServer; mid-body counts as mid-line).

The HTTP surface is declared as data (``ROUTES`` / ``STATUS_TEXT``) so
the wire-protocol contract checker (analysis/rules_protocol.py) diffs
it against ``protocol_schema.HTTP_ROUTES`` / ``HTTP_STATUS_CODES`` the
same way it diffs JSONL ops — editing the edge protocol is a two-place
change by design.

Threading contract: every callback here runs on the router's loop
thread and blocks on nothing; the one blocking verb (the fan-out
``/metrics`` scrape) runs on the router's ops executor, exactly like
the JSONL front session's stats verb.  House rules (script/lint):
monotonic clocks only, no print.
"""

from __future__ import annotations

import json
import math
import time
import urllib.parse
from collections import deque

from licensee_tpu_torch.obs.tsdb import QueryError

# the header-echo fast path shares the router's hot-path extractor
from licensee_tpu_torch.fleet.wire import json_str_field as _field_from_line
from licensee_tpu_torch.serve.eventloop import (
    LineConn,
    LoopJsonlServer,
    drop_close,
    drop_line,
)

# the declared HTTP surface: (method, path) -> the wire-level meaning.
# The protocol checker holds this table equal to
# protocol_schema.HTTP_ROUTES, both directions.  ``{id}`` paths are
# templates: runtime matching parses the job id out of the path
# (_job_template) and answers under the template's declared route.
ROUTES: dict[tuple[str, str], str] = {
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

# every status the edge may mint; _respond looks codes up here, so an
# undeclared code is a KeyError in tests before it is drift in CI.
# Checked equal to protocol_schema.HTTP_STATUS_CODES.
STATUS_TEXT: dict[int, str] = {
    200: "OK",
    202: "Accepted",
    400: "Bad Request",
    401: "Unauthorized",
    403: "Forbidden",
    404: "Not Found",
    405: "Method Not Allowed",
    409: "Conflict",
    413: "Payload Too Large",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
}

# the jobs tier's error vocabulary, spelled as module-level dict
# literals so every mint site is one the wire-protocol contract
# checker reads (an f-string body would hide the code)
_JOBS_DISABLED = {
    "error": "jobs_disabled: this edge serves no jobs tier "
             "(start the fleet with --jobs-dir)",
}
_JOB_NOT_FOUND = {"error": "job_not_found: no such job id"}
_JOB_NOT_DONE = {
    "error": "job_not_done: the job has not completed; poll its "
             "status first",
}

# the tenancy tier's error vocabulary, same contract: module-level
# dict literals so every mint site is checker-visible
_TENANCY_DISABLED = {
    "error": "tenancy_disabled: this edge serves no tenant registry "
             "(start the fleet with --tenants)",
}
_UNKNOWN_TENANT = {
    "error": "unknown_tenant: this client is bound to no tenant "
             "(corpus onboarding needs a registry-listed bearer token)",
}

# error-code prefixes (the JSONL "error" field) -> HTTP status classes;
# spelled as explicit branches in _finish_content so every mint site is
# a literal the contract checker can see
_FEDERATION_DOWN_CODES = ("router_closed", "router_not_started",
                          "no_backend_available")

# per-connection pipelining bound: above HIGH un-answered requests the
# client socket read pauses (kernel buffer pushes back), resuming
# below LOW — the JSONL front session's flow control, HTTP-sized
_EDGE_HIGH = 256
_EDGE_LOW = 64

_MAX_HEADERS = 64


def _job_template(path: str) -> tuple[str, str] | None:
    """Parse a ``/jobs/<id>[...]`` path into its declared route
    template + the job id, or None when the shape is not a job path.
    Ids are the executor's lowercase-hex mints; refusing anything
    else keeps arbitrary client bytes out of filesystem joins."""
    if not path.startswith("/jobs/"):
        return None
    rest = path[len("/jobs/"):]
    job_id, _, tail = rest.partition("/")
    if not job_id or not all(
        c in "0123456789abcdef" for c in job_id
    ) or len(job_id) > 32:
        return None
    if tail == "":
        return "/jobs/{id}", job_id
    if tail == "results":
        return "/jobs/{id}/results", job_id
    if tail == "containers":
        return "/jobs/{id}/containers", job_id
    return None


class _TokenBucket:
    """One client's rate limiter: ``take()`` returns 0.0 when a token
    was available, else the seconds until one refills (the Retry-After
    horizon).  Loop-thread owned — no lock."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = time.perf_counter()

    def take(self) -> float:
        now = time.perf_counter()
        self.tokens = min(
            self.burst, self.tokens + (now - self.stamp) * self.rate
        )
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        if self.rate <= 0:
            return 60.0
        return (1.0 - self.tokens) / self.rate




class _EdgeRequest:
    """One admitted ``/classify`` request parked in the DRR queue:
    the session slot it answers into, the raw JSON body (the wire
    line), the client identity it queues under, and its fair-queuing
    cost in body bytes."""

    __slots__ = ("session", "slot", "line", "client", "cost", "pool")

    def __init__(self, session: "_EdgeSession", slot: dict, line: str,
                 client: str, pool: str | None = None):
        self.session = session
        self.slot = slot
        self.line = line
        self.client = client
        self.cost = max(1, len(line))
        # the client's tenant pool (bearer-token binding): rides into
        # router._submit so dispatch/failover stay inside the pool
        self.pool = pool


class _EdgeSession:
    """One keep-alive HTTP connection's parser + response writer, as
    loop callbacks on a mixed-framing LineConn: request line, header
    lines, then a Content-Length body blob, then back to line framing.
    Responses go out strictly in request arrival order (the ``slots``
    deque), whatever order the router answers in."""

    def __init__(self, server: "HttpEdgeServer", conn: LineConn,
                 peer: str):
        self.server = server
        self.conn = conn
        self.peer = peer
        self.slots: deque[dict] = deque()
        self.paused = False
        self.burned = False
        self.closed = False
        # per-request parse state
        self._pending_slot: dict | None = None
        self.state = "request"  # "request" | "headers"
        self.method = ""
        self.path = ""
        self.keep_alive = True
        self.headers: dict[str, str] = {}
        self.n_headers = 0
        conn.on_line = self._on_line
        conn.on_blob = self._on_body
        conn.on_close = self._on_close

    # -- teardown --

    def _on_close(self, _reason) -> None:
        self.closed = True
        self.server.forget_connection(self.conn)
        self.slots.clear()  # late router fills find no slot: dropped

    # -- parsing (loop thread) --

    def _on_line(self, line: str) -> None:
        if self.burned or self.closed:
            return
        line = line.rstrip("\r")
        if self.state == "request":
            if not line:
                return  # leading CRLF between pipelined requests: ignore
            self._parse_request_line(line)
            return
        # header block
        if line:
            self._parse_header_line(line)
        else:
            self._end_of_headers()

    def _parse_request_line(self, line: str) -> None:
        parts = line.split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            slot = self._new_slot("error")
            self._respond(
                slot, 400,
                _err_body("bad_request", "malformed request line"),
                burn=True,
            )
            return
        self.method, self.path, version = parts
        # keep-alive is the 1.1 default; 1.0 closes unless asked
        self.keep_alive = version != "HTTP/1.0"
        self.headers = {}
        self.n_headers = 0
        self.state = "headers"

    def _parse_header_line(self, line: str) -> None:
        name, sep, value = line.partition(":")
        if not sep or not name.strip():
            slot = self._new_slot("error")
            self._respond(
                slot, 400,
                _err_body("bad_request", "malformed header line"),
                burn=True,
            )
            return
        self.n_headers += 1
        if self.n_headers > _MAX_HEADERS:
            slot = self._new_slot("error")
            self._respond(
                slot, 400,
                _err_body("bad_request",
                          f"more than {_MAX_HEADERS} headers"),
                burn=True,
            )
            return
        self.headers[name.strip().lower()] = value.strip()

    def _end_of_headers(self) -> None:
        self.state = "request"
        headers = self.headers
        conn_opt = headers.get("connection", "").lower()
        if conn_opt == "close":
            self.keep_alive = False
        elif conn_opt == "keep-alive":
            self.keep_alive = True
        raw_len = headers.get("content-length", "0")
        try:
            length = int(raw_len)
            if length < 0:
                raise ValueError
        except ValueError:
            slot = self._new_slot("error")
            self._respond(
                slot, 400,
                _err_body("bad_request",
                          f"bad Content-Length {raw_len!r}"),
                burn=True,
            )
            return
        slot = self._new_slot("content")
        slot["method"] = self.method
        slot["path"] = self.path
        slot["keep_alive"] = self.keep_alive
        # job submissions and corpus uploads carry whole artifacts:
        # they get the fat body budget, every other route keeps the
        # wire-row one
        limit = (
            self.server.max_job_body_bytes
            if (self.method, self.path.partition("?")[0])
            in (("POST", "/jobs"), ("POST", "/corpus"))
            else self.server.max_body_bytes
        )
        if length > limit:
            # refusing to READ the body breaks framing by definition:
            # answer and burn
            self._respond(
                slot, 413,
                _err_body(
                    "bad_request",
                    f"body {length} bytes over the "
                    f"{limit}-byte limit",
                ),
                burn=True,
            )
            return
        if headers.get("expect", "").lower() == "100-continue":
            try:
                self.conn.write_bytes_on_loop(
                    b"HTTP/1.1 100 Continue\r\n\r\n"
                )
            except OSError:
                return
        # the route verdict is computed now but ANSWERED only once the
        # body is drained — keep-alive framing survives a 401/404/429
        slot["verdict"] = self._route_verdict(slot)
        if length:
            self._pending_slot = slot
            self.conn.expect_blob(length)
        else:
            self._finish_request(slot, b"")

    def _on_body(self, blob: bytes) -> None:
        if self.burned or self.closed:
            return
        slot = self._pending_slot
        self._pending_slot = None
        self._finish_request(slot, blob)

    # -- routing --

    def _route_verdict(self, slot: dict) -> tuple:
        """("dispatch"|"health"|"metrics", client), ("jobs", client,
        route, job_id), or ("error", responder args) — decided at
        end-of-headers, delivered at end-of-body."""
        server = self.server
        method, raw_path = slot["method"], slot["path"]
        # the query string is transport detail, not route identity:
        # /metrics/history?series=… routes as /metrics/history, the
        # params ride in the slot for the handler
        path, _, slot["query_string"] = raw_path.partition("?")
        job_id = None
        route = ROUTES.get((method, path))
        if route is None:
            template = _job_template(path)
            if template is not None:
                route = ROUTES.get((method, template[0]))
                job_id = template[1]
            if route is None:
                known_path = any(
                    p == path for _m, p in ROUTES
                ) or template is not None
                if known_path:
                    return ("error", 405,
                            _err_body("bad_request",
                                      f"method {method} not allowed"))
                return ("error", 404,
                        _err_body("bad_request", f"no route {path}"))
        if route == "health":
            return ("health", None)
        client = self.peer
        if server.tokens is not None:
            auth = self.headers.get("authorization", "")
            scheme, _, value = auth.partition(" ")
            client = server.tokens.get(value.strip())
            if scheme.lower() != "bearer" or client is None:
                server.count_throttle("auth")
                return ("error", 401,
                        _err_body("bad_request",
                                  "missing or unknown bearer token"),
                        [("WWW-Authenticate", "Bearer")])
        if route == "prometheus":
            return ("metrics", client)
        if route == "metrics_history":
            return ("metrics_history", client)
        wait = server.bucket_for(client).take()
        if wait > 0.0:
            server.count_throttle("rate_limit")
            return ("error", 429,
                    _err_body("queue_full",
                              "client over its request rate"),
                    [("Retry-After", str(max(1, math.ceil(wait))))])
        if route.startswith("job_"):
            if server.jobs is None:
                return ("error", 503,
                        json.dumps(_JOBS_DISABLED).encode("utf-8"))
            return ("jobs", client, route, job_id)
        if route == "corpus_upload":
            if server.tenancy is None:
                return ("error", 503,
                        json.dumps(_TENANCY_DISABLED).encode("utf-8"))
            if server.tenancy.tenant_for(client) is None:
                # authenticated (or auth-less peer-named) but bound to
                # no tenant: 403, not 401 — the token may be perfectly
                # valid for /classify yet own no corpus
                server.count_throttle("auth")
                return ("error", 403,
                        json.dumps(_UNKNOWN_TENANT).encode("utf-8"))
            return ("corpus", client)
        pool = (
            server.tenancy.pool_for_client(client)
            if server.tenancy is not None else None
        )
        return ("dispatch", client, pool)

    def _finish_request(self, slot: dict, body: bytes) -> None:
        verdict = slot.pop("verdict")
        kind = verdict[0]
        if kind == "error":
            code, payload = verdict[1], verdict[2]
            extra = verdict[3] if len(verdict) > 3 else ()
            self._respond(slot, code, payload, extra_headers=extra)
            return
        if kind == "health":
            self._finish_health(slot)
            return
        if kind == "metrics":
            self._defer_metrics(slot)
            return
        if kind == "metrics_history":
            self._defer_history(slot)
            return
        if kind == "jobs":
            self._defer_job(slot, verdict[2], verdict[3], body)
            return
        if kind == "corpus":
            self._defer_corpus(slot, verdict[1], body)
            return
        line = body.decode("utf-8", errors="replace").strip()
        if not line or "\n" in line:
            # an empty body is not a content row; an embedded newline
            # would smuggle a second JSONL frame through the splice
            self._respond(
                slot, 400,
                _err_body("bad_request",
                          "body must be one JSON content row"),
            )
            return
        self.server.enqueue(
            _EdgeRequest(self, slot, line, verdict[1] or self.peer,
                         pool=verdict[2] if len(verdict) > 2 else None)
        )

    def _finish_health(self, slot: dict) -> None:
        router = self.server.router
        healthy = sum(
            1 for b in router.backends.values() if b.healthy
        )
        ok = healthy > 0 and not router._closing
        payload = json.dumps({
            "ok": ok,
            "backends_healthy": healthy,
            "backends_total": len(router.backends),
        }).encode("utf-8")
        if ok:
            self._respond(slot, 200, payload)
        else:
            self._respond(slot, 503, payload)

    def _defer_metrics(self, slot: dict) -> None:
        """The fan-out Prometheus scrape blocks BY DESIGN — ops
        executor, never the loop (the JSONL front session's contract,
        fleet/router._FrontSession._defer)."""
        server = self.server
        loop = server.router.loop

        def run() -> None:
            try:
                text = server.router.prometheus()
                resp = (200, text.encode("utf-8"), "text/plain")
            except Exception as exc:  # noqa: BLE001 — session containment
                resp = (
                    500,
                    _err_body("internal_error", str(exc)[:200]),
                    "application/json",
                )

            def fill() -> None:
                code, payload, ctype = resp
                if code == 200:
                    self._respond(slot, 200, payload, ctype=ctype)
                else:
                    self._respond(slot, 500, payload)

            loop.call_soon_threadsafe(fill)

        server.router._ops.submit(run)

    def _defer_history(self, slot: dict) -> None:
        """GET /metrics/history: a telemetry-store query.  Store reads
        take the series lock — ops executor, never the loop, same
        contract as the metrics scrape.  Param decoding happens HERE
        (loop thread, pure string work) so a malformed number answers
        400 without burning an ops hop."""
        server = self.server
        loop = server.router.loop
        try:
            params = _history_params(slot.get("query_string", ""))
        except ValueError as exc:
            self._respond(
                slot, 400, _err_body("bad_request", str(exc)[:200])
            )
            return

        def run() -> None:
            try:
                result = server.router.store.query(params)
                resp = (200, json.dumps(result).encode("utf-8"))
            except QueryError as exc:
                if exc.code == "unknown_series":
                    resp = (404,
                            _err_body("unknown_series", str(exc)[:200]))
                else:
                    resp = (400,
                            _err_body("bad_request", str(exc)[:200]))
            except Exception as exc:  # noqa: BLE001 — session containment
                resp = (500, _err_body("internal_error", str(exc)[:200]))

            def fill() -> None:
                code, payload = resp
                self._respond(slot, code, payload)

            loop.call_soon_threadsafe(fill)

        server.router._ops.submit(run)

    def _defer_job(self, slot: dict, route: str, job_id: str | None,
                   body: bytes) -> None:
        """Every jobs verb blocks (journal fsync, manifest/result file
        I/O) — ops executor, never the loop, same contract as the
        metrics scrape."""
        server = self.server
        loop = server.router.loop

        def run() -> None:
            try:
                resp = _job_response(server, route, job_id, body)
            except Exception as exc:  # noqa: BLE001 — session containment
                resp = (
                    500,
                    _err_body("internal_error", str(exc)[:200]),
                    (), "application/json",
                )

            def fill() -> None:
                code, payload, extra, ctype = resp
                self._respond(
                    slot, code, payload, extra_headers=extra, ctype=ctype
                )

            loop.call_soon_threadsafe(fill)

        server.router._ops.submit(run)

    def _defer_corpus(self, slot: dict, client: str | None,
                      body: bytes) -> None:
        """POST /corpus: the whole onboarding pipeline (stage the
        artifact, run the validation gate, roll the tenant's pool)
        blocks for seconds — ops executor, never the loop."""
        server = self.server
        loop = server.router.loop

        def run() -> None:
            try:
                resp = _corpus_upload(server, client, body)
            except Exception as exc:  # noqa: BLE001 — session containment
                resp = (500, _err_body("internal_error", str(exc)[:200]))

            def fill() -> None:
                code, payload = resp
                self._respond(slot, code, payload)

            loop.call_soon_threadsafe(fill)

        server.router._ops.submit(run)

    # -- the router answer path --

    def fill_content(self, slot: dict, row, text) -> None:
        """One routed answer (loop thread): map the wire row onto an
        HTTP status + echo headers.  ``text`` is the router's spliced
        fast-path line (only ever a non-error row)."""
        if text is not None:
            extra = _echo_headers(text)
            self._respond(slot, 200, text.encode("utf-8"), extra_headers=extra)
            return
        err = row.get("error")
        payload = json.dumps(row).encode("utf-8")
        extra = []
        trace = row.get("trace")
        if trace:
            extra.append(("X-Trace-Id", str(trace)))
        corpus = row.get("corpus")
        if corpus:
            extra.append(("X-Corpus", str(corpus)))
        if not isinstance(err, str):
            self._respond(slot, 200, payload, extra_headers=extra)
            return
        code = err.split(":", 1)[0]
        if code == "queue_full":
            # the fleet's backpressure contract, translated: the
            # smallest retry_after the routed replicas offered becomes
            # the HTTP pacing header
            self.server.count_throttle("backpressure")
            retry = row.get("retry_after")
            try:
                after = max(1, math.ceil(float(retry)))
            except (TypeError, ValueError):
                after = 1
            extra.append(("Retry-After", str(after)))
            self._respond(slot, 429, payload, extra_headers=extra)
        elif code == "bad_request":
            self._respond(slot, 400, payload, extra_headers=extra)
        elif code in _FEDERATION_DOWN_CODES:
            # router shutdown / a fleet with no dispatchable backend:
            # the edge stays up and says so honestly
            self._respond(slot, 503, payload, extra_headers=extra)
        else:
            self._respond(slot, 500, payload, extra_headers=extra)

    # -- response writing (loop thread, in arrival order) --

    def _new_slot(self, kind: str) -> dict:
        slot = {"kind": kind, "resp": None, "keep_alive": self.keep_alive}
        self.slots.append(slot)
        if not self.paused and len(self.slots) > _EDGE_HIGH:
            self.paused = True
            self.conn.pause_reading()
        return slot

    def _respond(
        self, slot: dict, code: int, payload: bytes,
        extra_headers=(), ctype: str = "application/json",
        burn: bool = False,
    ) -> None:
        if burn:
            # answer then burn: the framing after this request is
            # unknowable — parse nothing further, close once the
            # queued responses (this one included) have flushed
            self.burned = True
            slot["keep_alive"] = False
        slot["resp"] = (code, payload, tuple(extra_headers), ctype)
        self._flush()

    def _flush(self) -> None:
        while self.slots:
            head = self.slots[0]
            if head["resp"] is None:
                return  # in-order contract: wait for the head answer
            self.slots.popleft()
            code, payload, extra, ctype = head["resp"]
            close_after = not head["keep_alive"]
            parts = [
                f"HTTP/1.1 {code} {STATUS_TEXT[code]}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
            ]
            for name, value in extra:
                parts.append(f"{name}: {value}\r\n")
            if close_after:
                parts.append("Connection: close\r\n")
            parts.append("\r\n")
            head_bytes = "".join(parts).encode("utf-8")
            self.server.count_response(code)
            try:
                self.conn.write_bytes_on_loop(head_bytes + payload)
            except OSError:
                return  # client went away; _on_close drops the rest
            if close_after:
                self.conn.close_when_drained(5.0)
                return
            if self.paused and len(self.slots) < _EDGE_LOW:
                self.paused = False
                self.conn.resume_reading()


def _err_body(code: str, detail: str) -> bytes:
    return json.dumps({"error": f"{code}: {detail}"}).encode("utf-8")


def _history_params(query_string: str) -> dict:
    """Decode ``?series=…&window=…&fn=…`` into a TsdbStore.query params
    dict.  Labels ride as ``labels=name:value,name:value``; numeric
    fields convert here so the store only ever sees typed params (its
    own validation then covers ranges and vocabulary)."""
    params: dict = {}
    for key, value in urllib.parse.parse_qsl(
        query_string, keep_blank_values=True
    ):
        if key in ("series", "fn", "by", "match"):
            params[key] = value
        elif key in ("window", "q"):
            try:
                params[key] = float(value)
            except ValueError:
                raise ValueError(
                    f"{key} must be a number, got {value!r}"
                ) from None
        elif key == "limit":
            try:
                params[key] = int(value)
            except ValueError:
                raise ValueError(
                    f"limit must be an integer, got {value!r}"
                ) from None
        elif key == "list":
            params[key] = value.lower() not in ("", "0", "false", "no")
        elif key == "labels":
            labels: dict[str, str] = {}
            for pair in value.split(","):
                if not pair:
                    continue
                name, sep, lval = pair.partition(":")
                if not sep or not name:
                    raise ValueError(
                        f"labels pair {pair!r} is not name:value"
                    )
                labels[name] = lval
            params["labels"] = labels
        else:
            raise ValueError(f"unknown query parameter {key!r}")
    return params


def _bad_spec(detail: str) -> tuple:
    return (400, _err_body("bad_request", detail), (), "application/json")


def _job_submit(server: "HttpEdgeServer", body: bytes) -> tuple:
    """POST /jobs on an ops thread: decode the spec, stage an uploaded
    archive into the jobs dir (the manifest then references it through
    the ingest ``::*`` container grammar), validate, submit.  The edge
    records its submit span under the SAME trace id the job adopts, so
    the assembled tree runs edge -> executor -> stripes."""
    import base64
    import binascii

    from licensee_tpu_torch.jobs.executor import validate_spec

    jobs = server.jobs
    try:
        row = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        return _bad_spec("body must be a JSON job spec")
    if not isinstance(row, dict):
        return _bad_spec("job spec must be a JSON object")
    archive_b64 = row.get("archive_b64")
    if archive_b64 is not None:
        if not isinstance(archive_b64, str):
            return _bad_spec("archive_b64 must be a base64 string")
        try:
            blob = base64.b64decode(archive_b64, validate=True)
        except (binascii.Error, ValueError):
            return _bad_spec("archive_b64 does not decode")
        name = row.get("archive_name")
        if not isinstance(name, str) or not name.strip():
            name = "archive.tar"
        saved = jobs.save_upload(name, blob)
        if "manifest" not in row:
            row = {**row, "manifest": [f"{saved}::*"]}
    spec, problem = validate_spec(row)
    if spec is None:
        return _bad_spec(problem)
    corpus_opt = (spec.get("options") or {}).get("corpus")
    if corpus_opt is not None:
        # fail the bad corpus source at submit time (400), not hours
        # later when a stripe crashes on it
        from licensee_tpu_torch.corpus.artifact import (
            ArtifactError, check_corpus_source,
        )
        try:
            check_corpus_source(corpus_opt)
        except (ArtifactError, OSError) as exc:
            return _bad_spec(f"corpus: {exc}")
    trace_in = row.get("trace")
    tracer = server.router.obs.tracer
    trace = tracer.start(
        None,
        trace_id=(
            trace_in if isinstance(trace_in, str) and trace_in else None
        ),
    )
    try:
        job, created = jobs.submit(spec, trace_id=trace.trace_id)
    except RuntimeError as exc:
        tracer.finish(trace, "error")
        return (
            503, _err_body("jobs_disabled", str(exc)[:200]),
            (), "application/json",
        )
    trace.add_span(
        "edge.job_submit",
        time.perf_counter() - trace.t_start,
        t0=trace.t_start,
    )
    tracer.finish(trace, "ok" if created else "duplicate")
    resp = {
        "job_id": job.job_id,
        "state": job.state,
        "duplicate": not created,
    }
    extra = []
    if job.trace_id:
        resp["trace"] = job.trace_id
        extra.append(("X-Trace-Id", str(job.trace_id)))
    return (
        202 if created else 200,
        json.dumps(resp).encode("utf-8"),
        extra, "application/json",
    )


def _job_response(server: "HttpEdgeServer", route: str,
                  job_id: str | None, body: bytes) -> tuple:
    """One jobs verb on an ops thread -> (code, payload, headers,
    content type).  Unknown ids answer 404; results before completion
    answer 409 (poll the status verb); the merged JSONL and the
    container sidecar serve as raw bytes — the byte-identity contract
    with a direct ``batch-detect --stripes`` run is the whole point."""
    jobs = server.jobs
    if route == "job_submit":
        return _job_submit(server, body)
    status = jobs.status(job_id)
    if status is None:
        return (
            404, json.dumps(_JOB_NOT_FOUND).encode("utf-8"),
            (), "application/json",
        )
    extra = []
    trace = status.get("trace")
    if trace:
        extra.append(("X-Trace-Id", str(trace)))
    if route == "job_status":
        return (
            200, json.dumps(status).encode("utf-8"),
            extra, "application/json",
        )
    if route == "job_cancel":
        row = jobs.cancel(job_id) or status
        return (
            202, json.dumps(row).encode("utf-8"),
            extra, "application/json",
        )
    if status.get("state") != "completed":
        row = dict(_JOB_NOT_DONE)
        row["state"] = status.get("state")
        return (
            409, json.dumps(row).encode("utf-8"),
            extra, "application/json",
        )
    results = jobs.results_path(job_id)
    if route == "job_containers":
        try:
            with open(f"{results}.containers.jsonl", "rb") as f:
                payload = f.read()
        except OSError:
            payload = b""  # loose-file jobs have no container sidecar
        return (200, payload, extra, "application/jsonl")
    try:
        with open(results, "rb") as f:
            payload = f.read()
    except OSError as exc:
        return (
            500, _err_body("internal_error", str(exc)[:200]),
            (), "application/json",
        )
    return (200, payload, extra, "application/jsonl")


def _corpus_upload(server: "HttpEdgeServer", client: str | None,
                   body: bytes) -> tuple:
    """POST /corpus on an ops thread -> (code, payload).  The verdict
    already proved the client maps to a tenant; here the artifact
    bytes decode, the onboarding pipeline runs (stage -> validate ->
    journal -> roll -> persist), and OnboardError codes map onto HTTP
    statuses: invalid artifacts 400, a roll already in flight 409
    (retryable), a failed roll 500."""
    import base64
    import binascii

    from licensee_tpu_torch.tenancy import OnboardError

    try:
        row = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        return (400, _err_body("bad_request",
                               "body must be a JSON corpus upload"))
    if not isinstance(row, dict):
        return (400, _err_body("bad_request",
                               "corpus upload must be a JSON object"))
    artifact_b64 = row.get("artifact_b64")
    if not isinstance(artifact_b64, str) or not artifact_b64:
        return (400, _err_body(
            "bad_request", "artifact_b64 must be a base64 string"
        ))
    try:
        blob = base64.b64decode(artifact_b64, validate=True)
    except (binascii.Error, ValueError):
        return (400, _err_body("bad_request",
                               "artifact_b64 does not decode"))
    name = row.get("name")
    if name is not None and not isinstance(name, str):
        return (400, _err_body("bad_request", "name must be a string"))
    try:
        result = server.tenancy.upload(client, blob, name)
    except OnboardError as exc:
        if exc.code == "unknown_tenant":
            return (403, json.dumps(_UNKNOWN_TENANT).encode("utf-8"))
        if exc.code == "corpus_invalid":
            return (400, json.dumps(
                {"error": f"corpus_invalid: {exc.detail}"}
            ).encode("utf-8"))
        if exc.code == "fleet_reload_in_progress":
            return (409, _err_body(exc.code, exc.detail[:200]))
        return (500, _err_body("internal_error", str(exc)[:200]))
    return (200, json.dumps({"corpus": result}).encode("utf-8"))


def _echo_headers(text: str) -> list[tuple[str, str]]:
    out = []
    trace = _field_from_line(text, "trace")
    if trace:
        out.append(("X-Trace-Id", trace))
    corpus = _field_from_line(text, "corpus")
    if corpus:
        out.append(("X-Corpus", corpus))
    return out


class HttpEdgeServer(LoopJsonlServer):
    """The network edge listener: usually an AF_INET target
    (``host:port``) on the router's own event loop, every connection an
    :class:`_EdgeSession`.  Owns the cross-session policy state — auth
    tokens, per-client token buckets, and the DRR dispatch queue —
    all loop-thread-only, no locks.

    ``tokens`` maps bearer token -> client name (None disables auth:
    every client is its peer address).  ``rate_per_client``/``burst``
    shape each client's token bucket; ``quantum_bytes`` is the DRR
    quantum; ``max_inflight`` bounds concurrent dispatches into the
    router (admitted-but-waiting requests sit in the fair queue, not
    in the router's admission queue, so one greedy client cannot fill
    the shared funnel)."""

    def __init__(
        self,
        target: str,
        router,
        *,
        tokens: dict[str, str] | None = None,
        rate_per_client: float = 1000.0,
        burst: float | None = None,
        quantum_bytes: int = 8192,
        max_inflight: int = 1024,
        max_body_bytes: int = 1 << 20,
        max_job_body_bytes: int = 32 << 20,
        stall_timeout_s: float = 30.0,
        jobs=None,
        tenancy=None,
    ):
        self.router = router
        # the jobs tier (licensee_tpu_torch.jobs.JobExecutor), or None: the
        # /jobs routes then answer 503 jobs_disabled
        self.jobs = jobs
        # the tenancy tier (licensee_tpu_torch.tenancy.CorpusOnboarder), or
        # None: POST /corpus answers 503 tenancy_disabled and content
        # dispatch carries no client-derived pool
        self.tenancy = tenancy
        router.loop.start()  # idempotent; the loop must carry accepts
        super().__init__(
            target, loop=router.loop, stall_timeout_s=stall_timeout_s
        )
        self.tokens = dict(tokens) if tokens else None
        self.rate_per_client = float(rate_per_client)
        self.burst = float(
            burst if burst is not None else max(1.0, rate_per_client)
        )
        self.quantum_bytes = int(quantum_bytes)
        self.max_inflight = int(max_inflight)
        self.max_body_bytes = int(max_body_bytes)
        self.max_job_body_bytes = int(max_job_body_bytes)
        # DRR state (loop-thread only)
        self._queues: dict[str, deque[_EdgeRequest]] = {}
        self._ring: deque[str] = deque()
        self._deficit: dict[str, float] = {}
        self._buckets: dict[str, _TokenBucket] = {}
        self._inflight = 0
        self._queued = 0
        self._pumping = False
        self._register_metrics()

    # -- metrics --

    def _register_metrics(self) -> None:
        reg = self.router.obs.registry
        requests = reg.counter(
            "edge_http_requests_total",
            "HTTP edge responses by status code",
            labels=("code",),
        )
        # children resolved once per code: family.labels() is a dict
        # build per call, measurable at saturation on the loop thread
        children: dict = {}

        def count_response(code: int) -> None:
            child = children.get(code)
            if child is None:
                child = children[code] = requests.labels(code=str(code))
            child.inc()

        self.count_response = count_response
        throttled = reg.counter(
            "edge_http_throttled_total",
            "HTTP edge throttle events (auth, rate_limit, backpressure)",
            labels=("reason",),
        )
        t_children: dict = {}

        def count_throttle(reason: str) -> None:
            child = t_children.get(reason)
            if child is None:
                child = t_children[reason] = throttled.labels(
                    reason=reason
                )
            child.inc()

        self.count_throttle = count_throttle
        reg.gauge(
            "edge_http_connections",
            "Open HTTP edge connections",
        ).set_fn(self.connection_count)
        reg.gauge(
            "edge_queue_depth",
            "Requests parked in the edge's per-client DRR fair queue",
        ).set_fn(lambda: self._queued)
        reg.gauge(
            "edge_inflight",
            "Edge requests currently dispatched into the router",
        ).set_fn(lambda: self._inflight)

    # -- per-client state (loop thread) --

    def bucket_for(self, client: str) -> _TokenBucket:
        bucket = self._buckets.get(client)
        if bucket is None:
            bucket = self._buckets[client] = _TokenBucket(
                self.rate_per_client, self.burst
            )
        return bucket

    # -- DRR fair queue (loop thread) --

    def enqueue(self, item: _EdgeRequest) -> None:
        client = item.client
        queue = self._queues.get(client)
        if queue is None:
            queue = self._queues[client] = deque()
            self._ring.append(client)
        queue.append(item)
        self._queued += 1
        self._pump()

    def _pump(self) -> None:
        """Drain the fair queue into the router: classic deficit
        round-robin — each ring visit grants the client one quantum of
        body-byte credit, requests dispatch while credit and the
        ``max_inflight`` bound allow, and an emptied client leaves the
        ring with its credit forfeited (the DRR anti-hoarding rule).
        Iterative and re-entrancy-guarded: router answers landing
        synchronously re-enter via their completion callback."""
        if self._pumping:
            return
        self._pumping = True
        try:
            while self._ring and self._inflight < self.max_inflight:
                client = self._ring[0]
                queue = self._queues.get(client)
                if not queue:
                    self._ring.popleft()
                    self._queues.pop(client, None)
                    self._deficit.pop(client, None)
                    continue
                credit = self._deficit.get(client, 0.0) + self.quantum_bytes
                while (
                    queue
                    and credit >= queue[0].cost
                    and self._inflight < self.max_inflight
                ):
                    item = queue.popleft()
                    self._queued -= 1
                    credit -= item.cost
                    self._dispatch(item)
                if queue:
                    self._deficit[client] = credit
                    self._ring.rotate(-1)
                    if self._inflight >= self.max_inflight:
                        return
                else:
                    self._ring.popleft()
                    self._queues.pop(client, None)
                    self._deficit.pop(client, None)
        finally:
            self._pumping = False

    def _dispatch(self, item: _EdgeRequest) -> None:
        session = item.session
        if session.closed:
            return  # the client left while queued: answer nobody
        # a BURNED session still owes every response admitted before
        # the burn: the 400 that closes the connection is queued
        # behind them, and an unfilled earlier slot would strand it
        # (answer-then-burn is the framing contract)
        self._inflight += 1

        def on_done(row, text=None) -> None:
            self._inflight -= 1
            if not session.closed:
                session.fill_content(item.slot, row, text)
            self._pump()

        self.router._submit(None, item.line, on_done, pool=item.pool)

    # -- connections --

    def handle_connection(self, sock) -> None:
        try:
            peer = sock.getpeername()
        except OSError:
            peer = None
        peer_name = (
            peer[0] if isinstance(peer, tuple) and peer else "local"
        )
        conn = LineConn(
            self.loop, sock, on_line=drop_line, on_close=drop_close,
            max_line_bytes=64 << 10,
        )
        self.track_connection(conn)
        _EdgeSession(self, conn, peer_name)
