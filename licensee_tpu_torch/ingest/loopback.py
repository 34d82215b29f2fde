"""A loopback HTTP blob host for selftests, tests and the card smoke.

The port's copy of `licensee_tpu/ingest/loopback.py`.  Serves an
in-memory name -> bytes map over real HTTP on ``127.0.0.1:0`` (stdlib
``http.server``, threaded, daemonized; no network), speaking just
enough of the artifact-hosting dialect the remote ingest tier
(remote.py) depends on:

* ``Accept-Ranges: bytes`` + single-range ``206``/``416`` answers
* strong ``ETag`` (content sha1) and a fixed ``Last-Modified``
* ``If-Match`` -> 412 on mismatch; ``If-Range`` -> 200-full-body on
  mismatch (the two republish fences)

and the scripted FAULTS the failure-model tests need:

* ``fail_next(name, times, status=503)`` — the next N requests for
  that path answer ``status`` (the 503-then-recover rung)
* ``truncate_next(name, nbytes)`` — the next GET advertises the full
  Content-Length but tears the body after ``nbytes`` (a torn remote)
* ``latency_s`` — a per-request sleep, the injected round-trip time
  the prefetch window is meant to hide
* ``no_range = True`` — Range support vanishes (submit-probe tests)
* ``set_content(name, data)`` — republish: the ETag flips, fenced
  reads must refuse

Per-path request/range logs (``hits``, ``ranges``) let tests assert
request COUNTS — that coalescing collapsed a thousand tiny members
into few ranged reads, and that the prefetch window actually
overlapped them.
"""

from __future__ import annotations

import hashlib
import threading
import time


class LoopbackBlobHost:
    """``with LoopbackBlobHost({"a.tar": blob}) as host:`` ->
    ``host.url("a.tar")`` is a live ``http://127.0.0.1:<port>/a.tar``."""

    def __init__(self, content: dict[str, bytes] | None = None,
                 latency_s: float = 0.0):
        self._lock = threading.Lock()
        self._content: dict[str, bytes] = dict(content or {})
        self._etag: dict[str, str] = {}
        for name, data in self._content.items():
            self._etag[name] = self._make_etag(data)
        self.latency_s = latency_s
        self.no_range = False
        self.hits: dict[str, int] = {}
        self.ranges: dict[str, list[tuple[int, int]]] = {}
        self._fail: dict[str, list] = {}      # name -> [times, status]
        self._truncate: dict[str, int] = {}   # name -> body bytes kept
        self._server = None
        self._thread = None

    @staticmethod
    def _make_etag(data: bytes) -> str:
        return '"%s"' % hashlib.sha1(
            data, usedforsecurity=False
        ).hexdigest()

    # -- scripting -----------------------------------------------------

    def set_content(self, name: str, data: bytes) -> None:
        """(Re)publish a blob; the ETag flips with the bytes."""
        with self._lock:
            self._content[name] = data
            self._etag[name] = self._make_etag(data)

    def fail_next(self, name: str, times: int, status: int = 503) -> None:
        with self._lock:
            self._fail[name] = [times, status]

    def truncate_next(self, name: str, nbytes: int,
                      times: int = 1) -> None:
        with self._lock:
            self._truncate[name] = [times, nbytes]

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "LoopbackBlobHost":
        from http.server import (
            BaseHTTPRequestHandler,
            ThreadingHTTPServer,
        )

        host = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY: a response is written as headers, then body;
            # with Nagle on, the body waits for the client's delayed ACK
            # of the headers (~40 ms a request on loopback)
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # noqa: D102 — silent
                pass

            def do_HEAD(self):  # noqa: N802 — http.server dispatch
                host._serve(self, body=False)

            def do_GET(self):  # noqa: N802 — http.server dispatch
                host._serve(self, body=True)

        class Server(ThreadingHTTPServer):
            # several readers, each with its own keep-alive pool, dial at
            # once: the default listen backlog of 5 refuses some
            request_queue_size = 128

            def handle_error(self, request, client_address):
                # a client that drops its connection mid-response (the
                # remote reader discards a connection it gives up on) is
                # no fault of the host's
                import sys

                if not isinstance(sys.exc_info()[1], ConnectionError):
                    super().handle_error(request, client_address)

        self._server = Server(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="loopback-blob-host",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def url(self, name: str) -> str:
        return f"http://127.0.0.1:{self.port}/{name}"

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "LoopbackBlobHost":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the request path ----------------------------------------------

    def _serve(self, handler, body: bool) -> None:
        if self.latency_s > 0:
            time.sleep(self.latency_s)
        name = handler.path.lstrip("/").split("?", 1)[0]
        with self._lock:
            self.hits[name] = self.hits.get(name, 0) + 1
            data = self._content.get(name)
            etag = self._etag.get(name)
            fail = self._fail.get(name)
            if fail is not None and fail[0] > 0:
                fail[0] -= 1
                status = fail[1]
            else:
                status = None
            truncate = None
            if body:
                tr = self._truncate.get(name)
                if tr is not None and tr[0] > 0:
                    tr[0] -= 1
                    truncate = tr[1]
        if status is not None:
            self._answer(handler, status, b"scripted fault")
            return
        if data is None:
            self._answer(handler, 404, b"no such blob")
            return
        if_match = handler.headers.get("If-Match")
        if if_match is not None and if_match != etag:
            self._answer(handler, 412, b"precondition failed")
            return
        rng = None
        if not self.no_range:
            rng = self._parse_range(
                handler.headers.get("Range"), len(data)
            )
            if rng == "bad":
                handler.send_response(416)
                handler.send_header(
                    "Content-Range", f"bytes */{len(data)}"
                )
                handler.send_header("Content-Length", "0")
                handler.end_headers()
                return
            if_range = handler.headers.get("If-Range")
            if rng is not None and if_range is not None and (
                if_range != etag
            ):
                rng = None  # fence tripped: full (new) body, 200
        status = 206 if rng is not None else 200
        lo, hi = rng if rng is not None else (0, len(data) - 1)
        payload = data[lo:hi + 1] if data else b""
        with self._lock:
            if rng is not None:
                self.ranges.setdefault(name, []).append((lo, hi))
        handler.send_response(status)
        handler.send_header("ETag", etag)
        handler.send_header("Last-Modified",
                            "Thu, 01 Jan 2026 00:00:00 GMT")
        if not self.no_range:
            handler.send_header("Accept-Ranges", "bytes")
        if rng is not None:
            handler.send_header(
                "Content-Range", f"bytes {lo}-{hi}/{len(data)}"
            )
        handler.send_header("Content-Length", str(len(payload)))
        handler.end_headers()
        if body:
            if truncate is not None and truncate < len(payload):
                # a torn body: full Content-Length promised, fewer
                # bytes delivered, connection dropped
                try:
                    handler.wfile.write(payload[:truncate])
                    handler.wfile.flush()
                finally:
                    handler.close_connection = True
                    try:
                        handler.connection.close()
                    except OSError:
                        pass
                return
            handler.wfile.write(payload)

    @staticmethod
    def _parse_range(header, size: int):
        """``bytes=a-b`` -> (a, b) clamped; None when absent/ignorable;
        ``"bad"`` for an unsatisfiable range (-> 416)."""
        if not header or not header.startswith("bytes=") or "," in header:
            return None
        spec = header[len("bytes="):]
        lo_s, _, hi_s = spec.partition("-")
        try:
            if lo_s == "":
                n = int(hi_s)  # suffix range: last n bytes
                if n <= 0:
                    return "bad"
                return max(0, size - n), size - 1
            lo = int(lo_s)
            hi = int(hi_s) if hi_s else size - 1
        except ValueError:
            return None
        if lo >= size or hi < lo:
            return "bad"
        return lo, min(hi, size - 1)

    @staticmethod
    def _answer(handler, status: int, msg: bytes) -> None:
        handler.send_response(status)
        handler.send_header("Content-Length", str(len(msg)))
        handler.end_headers()
        handler.wfile.write(msg)
