"""Fleet-side JSONL wire helpers: one-shot control requests, and the
pooled probe path the supervisor's health checks ride.

Every worker speaks the serve transport (serve/server.py): one JSON
object per line in, one per line out, in request order.  The fleet tier
talks to workers over the same contract — a probe is just a session of
one ``{"op": "stats"}`` line.  Targets go through
``serve.eventloop.parse_target``: a Unix socket path, or ``host:port``
for the TCP federation tier (pooled TCP connections disable Nagle —
TCP_NODELAY — before the first byte).  Pooled connections carry ONE in-flight
request at a time, so the worker's in-order response guarantee is
trivially the caller's per-request correctness; a sick connection is
closed, never reused.  (The ROUTER's request path no longer lives here:
it pipelines over non-blocking per-worker pools on the event loop —
fleet/router.py.)

Probes reuse a parked connection instead of dialing per probe: N
workers × a fast probe interval used to cost a fresh socket (and three
syscalls) every round, and the timeout path could strand the fd.
``ConnectionPool.request`` now guarantees the connection is either
parked healthy or CLOSED — every exception path, timeout included,
releases the fd — and retries ONCE on a fresh dial when a REUSED
connection fails at the connection level (the parked socket had gone
stale across a worker restart; a liveness verdict should not flap for
that).  Timeouts are never retried: a wedged worker's probe must cost
one timeout, not two.

House rules (script/lint): monotonic clocks only, no print.
"""

from __future__ import annotations

import errno
import json
import socket
import threading
import time
from collections import deque

from licensee_tpu_torch.serve.eventloop import parse_target


def json_str_field(text: str, key: str) -> str | None:
    """Pull a string field's value out of a serialized JSON row without
    parsing it — the hot-path extractor the router (inbound-trace
    adoption) and the HTTP edge (X-Trace-Id/X-Corpus echo) share.

    Only sound for fields whose values the SYSTEM mints (16-hex trace
    IDs, 12-hex corpus fingerprints): their values never contain
    escapes, and client-controlled text cannot forge the unescaped
    ``"key":`` byte pattern through json.dumps (its quotes arrive
    backslash-escaped).  Callers validate the extracted value against
    the field's grammar before trusting it."""
    marker = f'"{key}"'
    i = text.rfind(marker)
    if i < 0:
        return None
    i += len(marker)
    n = len(text)
    while i < n and text[i] in " \t":
        i += 1
    if i >= n or text[i] != ":":
        return None
    i += 1
    while i < n and text[i] in " \t":
        i += 1
    if i >= n or text[i] != '"':
        return None
    i += 1
    j = text.find('"', i)
    if j <= i:
        return None
    return text[i:j]


class WireError(OSError):
    """The backend could not answer: connect/send/recv failed or timed
    out, or the response line was not JSON.  ``kind`` says which
    failure class: "connect" (dial failed), "refused" (ECONNREFUSED —
    a provably dead listener; callers fail over rather than retry),
    "timeout" (the peer is there but silent), "closed" (peer hung up),
    or "protocol" (bad response line) — the pool's retry policy keys
    off it."""

    def __init__(self, message: str, kind: str = "io"):
        super().__init__(message)
        self.kind = kind


class Connection:
    """One JSONL control connection: send a line, read a line.

    ``target`` is a :func:`parse_target` target — a Unix socket path,
    or ``host:port`` for TCP (TCP_NODELAY set before the dial: a
    request/response line protocol dies under Nagle + delayed ACK).
    The dial distinguishes the two connect-failure classes that demand
    opposite reactions: EAGAIN means the listener's backlog is full
    and the connect never STARTED — retried inside the dial budget —
    while ECONNREFUSED means a provably dead host (kind "refused",
    never retried here: failing over is the caller's job)."""

    def __init__(self, path: str, timeout: float):
        self.path = path
        kind, addr = parse_target(path)
        family = (
            socket.AF_INET if kind == "tcp" else socket.AF_UNIX
        )
        address = addr if kind == "tcp" else path
        deadline = time.perf_counter() + max(0.05, float(timeout))
        while True:
            self._sock = socket.socket(family, socket.SOCK_STREAM)
            try:
                self._sock.settimeout(timeout)
                if kind == "tcp":
                    self._sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                self._sock.connect(address)
                self._file = self._sock.makefile("rwb")
                return
            except OSError as exc:
                self._sock.close()
                if (
                    exc.errno == errno.EAGAIN
                    and time.perf_counter() < deadline
                ):
                    # backlog full: this connect never started — a
                    # short blocking retry inside the budget (this is
                    # the blocking wire layer; the loop-side twin is
                    # eventloop._connect_stream's timer retry)
                    time.sleep(0.02)
                    continue
                raise WireError(
                    f"connect {path!r}: {exc}",
                    kind=(
                        "refused"
                        if exc.errno == errno.ECONNREFUSED
                        else "connect"
                    ),
                ) from exc

    def request(self, line: str, timeout: float) -> dict:
        """Send one request line, block for one response row."""
        try:
            self._sock.settimeout(timeout)
            self._file.write(line.encode("utf-8") + b"\n")
            self._file.flush()
            raw = self._file.readline()
        except socket.timeout as exc:
            raise WireError(
                f"io {self.path!r}: {exc}", kind="timeout"
            ) from exc
        except OSError as exc:
            raise WireError(f"io {self.path!r}: {exc}") from exc
        if not raw:
            raise WireError(
                f"{self.path!r}: peer closed the connection",
                kind="closed",
            )
        try:
            row = json.loads(raw.decode("utf-8", errors="replace"))
            if not isinstance(row, dict):
                raise ValueError("response must be a JSON object")
        except ValueError as exc:
            raise WireError(
                f"{self.path!r}: bad response: {exc}", kind="protocol"
            ) from exc
        return row

    def close(self) -> None:
        try:
            self._file.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# WireError kinds where a parked connection's failure says "this socket
# went stale" (worker restarted under us) rather than "the worker is
# sick" — worth one fresh dial before reporting failure.  "refused" is
# deliberately absent: ECONNREFUSED is a provably dead listener (a dead
# HOST, on the TCP federation tier) and the right reaction is failing
# over, not dialing the corpse again; "timeout" stays out so a wedged
# worker costs one probe timeout, not two.
_RETRY_FRESH_KINDS = ("connect", "closed", "io")


class ConnectionPool:
    """Idle-connection stack for one backend socket.

    ``checkout`` reuses the most recently parked connection (warmest
    path through the worker's per-connection session threads) or dials
    a fresh one; ``checkin`` parks a HEALTHY connection back, up to
    ``max_idle``; a connection that saw any error is closed instead —
    its stream position is unknowable, and the next request would read
    the previous one's orphaned response."""

    def __init__(
        self, path: str, *, max_idle: int = 8, connect_timeout: float = 2.0
    ):
        self.path = path
        self.max_idle = int(max_idle)
        self.connect_timeout = float(connect_timeout)
        self._idle: deque[Connection] = deque()
        self._lock = threading.Lock()

    def checkout(self) -> Connection:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return Connection(self.path, self.connect_timeout)

    def checkin(self, conn: Connection) -> None:
        with self._lock:
            if len(self._idle) < self.max_idle:
                self._idle.append(conn)
                return
        conn.close()

    def discard(self, conn: Connection) -> None:
        conn.close()

    def close(self) -> None:
        with self._lock:
            idle, self._idle = list(self._idle), deque()
        for conn in idle:
            conn.close()

    def request(
        self, payload: dict, timeout: float, *, retry_fresh: bool = True
    ) -> dict:
        """Pooled single request/response round trip — the probe
        primitive (supervisor health checks ride this every interval).

        The connection is either parked back healthy or CLOSED: every
        exception path — the probe-timeout path included — releases the
        fd in ``finally``, so a fast probe cadence can never leak
        sockets.  When a REUSED connection fails at the connection
        level (stale park across a worker restart), one fresh dial
        retries before the failure is reported; a "timeout" is never
        retried — a wedged worker must cost one probe timeout, not
        two."""
        line = json.dumps(payload)
        reused = False
        with self._lock:
            conn = self._idle.pop() if self._idle else None
            reused = conn is not None
        if conn is None:
            conn = Connection(self.path, self.connect_timeout)
        ok = False
        try:
            row = conn.request(line, timeout)
            ok = True
            return row
        except WireError as exc:
            if not (
                reused
                and retry_fresh
                and exc.kind in _RETRY_FRESH_KINDS
            ):
                raise
        finally:
            if ok:
                self.checkin(conn)
            else:
                conn.close()
        # the stale-park retry: one fresh dial, same guarantees
        conn = Connection(self.path, self.connect_timeout)
        ok = False
        try:
            row = conn.request(line, timeout)
            ok = True
            return row
        finally:
            if ok:
                self.checkin(conn)
            else:
                conn.close()


def oneshot(path: str, payload: dict, timeout: float = 2.0) -> dict:
    """Un-pooled request/response on a fresh connection — for one-off
    control verbs (CLI scrapes, reload verbs with their own long
    timeouts).  The socket is closed in ``finally`` on every path.
    Recurring probes should ride ``ConnectionPool.request`` instead:
    a fresh dial per probe interval is measurable churn at fleet
    scale."""
    conn = Connection(path, timeout)
    try:
        return conn.request(json.dumps(payload), timeout)
    finally:
        conn.close()
