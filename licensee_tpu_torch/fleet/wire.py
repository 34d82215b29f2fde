"""Fleet-side JSONL wire helpers: one-shot control requests to a
serving worker (`diff --socket` rides ``oneshot``).

Every worker speaks the serve transport (serve/server.py): one JSON
object per line in, one per line out, in request order.  Targets go
through ``serve.eventloop.parse_target``: a Unix socket path, or
``host:port`` for TCP (TCP_NODELAY set before the first byte).  The
port's copy of `licensee_tpu/fleet/wire.py` keeps only the one-shot
path; the pooled probe path waits for the fleet tier.

House rules (script/lint): monotonic clocks only, no print.
"""

from __future__ import annotations

import errno
import json
import socket
import time

from licensee_tpu_torch.serve.eventloop import parse_target


class WireError(OSError):
    """The backend could not answer: connect/send/recv failed or timed
    out, or the response line was not JSON.  ``kind`` says which
    failure class: "connect" (dial failed), "refused" (ECONNREFUSED —
    a provably dead listener; callers fail over rather than retry),
    "timeout" (the peer is there but silent), "closed" (peer hung up),
    or "protocol" (bad response line)."""

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


def oneshot(path: str, payload: dict, timeout: float = 2.0) -> dict:
    """Un-pooled request/response on a fresh connection — for one-off
    control verbs (CLI scrapes, reload verbs with their own long
    timeouts).  The socket is closed in ``finally`` on every path."""
    conn = Connection(path, timeout)
    try:
        return conn.request(json.dumps(payload), timeout)
    finally:
        conn.close()
