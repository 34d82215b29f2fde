"""Newline-delimited-JSON transports for the micro-batcher, plus the
``stats`` control verb and the CLI selftest.

The port's copy of `licensee_tpu/serve/server.py`: the same protocol,
byte for byte, over stdio and Unix or TCP sockets; the selftests take
the ``device`` their batcher runs on (the card unless asked otherwise).

One request per line; one response line per request, IN REQUEST ORDER
(a pipe consumer can zip its input to the output without ids, and ids
are still echoed for clients that want them).  Ordering costs nothing:
a reader thread admits requests as fast as they arrive (so the batcher
coalesces them), while a writer thread blocks only on the OLDEST
in-flight request — completed younger requests queue behind it.

Request lines:
  {"content": "...", "id": ..., "filename": ..., "deadline_ms": ...,
   "trace": "16-hex"}                # trace: adopt an upstream hop's
                                     # trace ID (the fleet router's)
  {"content_b64": "...", ...}        # raw bytes, base64
  {"op": "stats", "id": ...}         # dump scheduler/cache/latency JSON
  {"op": "stats", "format": "prometheus", "id": ...}  # text exposition
  {"op": "trace", "n": 20, "id": ...}  # recent retained traces
  {"op": "reload", "corpus": "...", "id": ...}  # blue/green corpus swap
                                     # (vendored | spdx | SPDX dir |
                                     # artifact path; validated, atomic)
  {"op": "diff", "content": "...", "license": "mit", "id": ...}
                                     # normalized blob vs closest (or
                                     # named) template, inline word diff
Response lines:
  {"id": ..., "key": ..., "matcher": ..., "confidence": ...,
   "cached": ..., "trace": "16-hex trace id"}
  {"id": ..., "error": "queue_full", "retry_after": 1.25,
   "trace": ...}                     # backpressure
  {"id": ..., "stats": {...}} / {"id": ..., "prometheus": "..."} /
  {"id": ..., "traces": [...]}

Every classification (and backpressure) row echoes the trace ID minted
for its request at admission — the handle that joins a client-side log
line to the server-side exemplar trace (obs/tracing.py).

The same session loop runs over stdio (``licensee-tpu serve``) and over
a Unix domain socket (``--socket PATH``, one session per connection) —
the HTTP layer of a later PR sits on the same batcher."""

from __future__ import annotations

import base64
import json
import os
import queue
import re
import threading
from collections import deque

from licensee_tpu_torch.corpus.artifact import short_fingerprint
from licensee_tpu_torch.serve.eventloop import (
    LineConn,
    LoopJsonlServer,
    SocketInUseError,
    drop_close,
    drop_line,
    prepare_unix_socket_path,
)
from licensee_tpu_torch.serve.scheduler import MicroBatcher, QueueFullError

__all__ = [
    "serve_session", "serve_stdio", "serve_unix", "selftest",
    "selftest_reload", "JsonlUnixServer", "UnixServer", "TcpServer",
    "SocketInUseError", "prepare_unix_socket_path",
]

# an upstream hop's trace ID (the fleet router's): 16 lowercase hex
TRACE_ID_RE = re.compile(r"\A[0-9a-f]{16}\Z")


def _parse_content(msg: dict):
    """(content, error) for the ``content`` / ``content_b64`` body the
    classification row and the ``diff`` verb share."""
    if "content_b64" in msg:
        try:
            return base64.b64decode(msg["content_b64"]), None
        except (ValueError, TypeError) as exc:
            return None, f"bad_request: {exc}"
    content = msg.get("content")
    if not isinstance(content, str):
        return None, (
            "bad_request: missing 'content' (or 'content_b64') string"
        )
    return content, None


def _render_result(req) -> dict:
    row = {"id": req.request_id, **req.result.as_dict()}
    if req.result.error:
        row["error"] = req.result.error
    row["cached"] = req.cached
    if req.trace_id is not None:
        row["trace"] = req.trace_id
    if req.corpus_fp is not None:
        # the corpus epoch that produced this verdict (display form) —
        # the attribution handle the reload drills gate on: every
        # answer names exactly one fingerprint, old or new
        row["corpus"] = short_fingerprint(req.corpus_fp)
    return row


class _ReloadHandle:
    """One in-flight reload verb: the swap runs on its own thread (a
    compile takes seconds and must not block this session's reader from
    admitting traffic), the writer waits on ``done`` like any request."""

    def __init__(self, batcher, rid, source: str):
        self.row: dict = {"id": rid, "error": "internal_error: no result"}
        self.done = threading.Event()
        self._batcher = batcher
        self._rid = rid
        self._source = source
        threading.Thread(
            target=self._run, name="serve-reload", daemon=True
        ).start()

    def _run(self) -> None:
        from licensee_tpu_torch.serve.reload import (
            ReloadInProgressError,
            ReloadRejectedError,
        )

        try:
            self.row = {
                "id": self._rid,
                "reload": self._batcher.reload_corpus(self._source),
            }
        except ReloadInProgressError:
            self.row = {"id": self._rid, "error": "reload_in_progress"}
        except ReloadRejectedError as exc:
            self.row = {
                "id": self._rid,
                "error": f"reload_failed: {exc}",
                "problems": exc.problems,
            }
        except Exception as exc:  # noqa: BLE001 — session containment
            self.row = {
                "id": self._rid, "error": f"internal_error: {exc}"
            }
        finally:
            self.done.set()


class _Session:
    """One transport session: parse lines, admit requests, emit ordered
    responses via a writer thread."""

    def __init__(self, batcher: MicroBatcher, write_line):
        self.batcher = batcher
        self._write_line = write_line
        self._pending: deque = deque()  # ("req", ServeRequest) | ("raw", dict)
        self._cond = threading.Condition()
        self._closed = False
        self.requests = 0
        self.responses = 0
        self._writer = threading.Thread(
            target=self._drain, name="serve-writer", daemon=True
        )
        self._writer.start()

    def _emit(self, kind, payload) -> None:
        with self._cond:
            self._pending.append((kind, payload))
            self._cond.notify_all()

    def _drain(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending and self._closed:
                    return
                kind, payload = self._pending.popleft()
            if kind == "req":
                payload.done.wait()
                row = _render_result(payload)
            elif kind == "reload":
                payload.done.wait()
                row = payload.row
            elif kind == "stats":
                # snapshot at WRITE time, not parse time: every earlier
                # request in the stream has answered by now, so the verb
                # reports "stats as of this point in the session"
                rid, fmt = payload
                if fmt == "prometheus":
                    row = {"id": rid, "prometheus": self.batcher.prometheus()}
                else:
                    row = {"id": rid, "stats": self.batcher.stats()}
            elif kind == "trace":
                rid, n = payload
                row = {"id": rid, "traces": self.batcher.trace_tail(n)}
            elif kind == "diff":
                # computed at write time like stats (host-side Dice
                # ranking + word diff, a few ms — a diagnostics verb,
                # not the scoring hot path)
                from licensee_tpu_torch.serve.diffverb import (
                    UnknownLicenseError,
                    diff_payload,
                )

                rid, content, filename, license_key, trace_id = payload
                # ONE classifier snapshot: pool fence and the corpus
                # stamp must name the same blue/green epoch
                clf = self.batcher.classifier
                corpus = getattr(clf, "corpus", None)
                try:
                    row = {
                        "id": rid,
                        "diff": diff_payload(
                            content, filename, license_key, corpus=corpus
                        ),
                    }
                    if corpus is not None:
                        from licensee_tpu_torch.corpus.artifact import (
                            corpus_fingerprint,
                        )

                        row["corpus"] = short_fingerprint(
                            corpus_fingerprint(corpus)
                        )
                except UnknownLicenseError as exc:
                    row = {"id": rid, "error": f"unknown_license: {exc}"}
                except Exception as exc:  # noqa: BLE001 — session containment
                    row = {"id": rid, "error": f"internal_error: {exc}"}
                if trace_id is not None:
                    # echo the upstream hop's trace like content rows
                    # do — the fleet router's pipelining cross-check
                    # rides this field on relayed diff verbs
                    row["trace"] = trace_id
            else:
                row = payload
            try:
                self._write_line(json.dumps(row))
            except (OSError, ValueError):
                return  # peer went away: drop the rest of the session
            self.responses += 1

    def handle_line(self, line: str) -> None:
        line = line.strip()
        if not line:
            return
        self.requests += 1
        try:
            msg = json.loads(line)
            if not isinstance(msg, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as exc:
            self._emit(
                "raw", {"id": None, "error": f"bad_request: {exc}"}
            )
            return
        rid = msg.get("id")
        op = msg.get("op")
        if op == "stats":
            fmt = msg.get("format")
            if fmt not in (None, "json", "prometheus"):
                self._emit(
                    "raw",
                    {"id": rid,
                     "error": f"bad_request: unknown stats format {fmt!r}"},
                )
                return
            self._emit("stats", (rid, fmt))
            return
        if op == "trace":
            n = msg.get("n", 20)
            if isinstance(n, bool) or not isinstance(n, int) or n < 0:
                self._emit(
                    "raw",
                    {"id": rid,
                     "error": "bad_request: n must be a non-negative int"},
                )
                return
            self._emit("trace", (rid, n))
            return
        if op == "reload":
            source = msg.get("corpus")
            if not isinstance(source, str) or not source:
                self._emit(
                    "raw",
                    {"id": rid,
                     "error": "bad_request: reload needs a 'corpus' "
                     "source string"},
                )
                return
            self._emit("reload", _ReloadHandle(self.batcher, rid, source))
            return
        if op == "diff":
            # the normalized-blob-vs-template word diff (diffverb.py):
            # same content body as a classification row, plus an
            # optional "license" key naming the comparison target
            content, err = _parse_content(msg)
            if err is not None:
                self._emit("raw", {"id": rid, "error": err})
                return
            size = (
                len(content)
                if isinstance(content, bytes)
                else len(content.encode("utf-8"))
            )
            if size > 64 * 1024:
                # the same MAX_LICENSE_SIZE cap every ingestion path
                # enforces — measured in BYTES whichever encoding the
                # content arrived in — and the bound that keeps the
                # word-diff's worst case (adversarial repetitive text
                # vs the widest template) to ~0.3 s on the session
                # writer
                self._emit(
                    "raw",
                    {"id": rid,
                     "error": "bad_request: diff content exceeds the "
                     "64 KiB MAX_LICENSE_SIZE cap"},
                )
                return
            filename = msg.get("filename")
            if filename is not None and not isinstance(filename, str):
                self._emit(
                    "raw",
                    {"id": rid,
                     "error": "bad_request: filename must be a string"},
                )
                return
            license_key = msg.get("license")
            if license_key is not None and not isinstance(license_key, str):
                self._emit(
                    "raw",
                    {"id": rid,
                     "error": "bad_request: license must be a string"},
                )
                return
            trace_id = msg.get("trace")
            if trace_id is not None and (
                not isinstance(trace_id, str)
                or not TRACE_ID_RE.match(trace_id)
            ):
                self._emit(
                    "raw",
                    {"id": rid,
                     "error": "bad_request: trace must be 16 lowercase "
                     "hex"},
                )
                return
            self._emit(
                "diff", (rid, content, filename, license_key, trace_id)
            )
            return
        if op is not None:
            self._emit(
                "raw", {"id": rid, "error": f"bad_request: unknown op {op!r}"}
            )
            return
        content, err = _parse_content(msg)
        if err is not None:
            self._emit("raw", {"id": rid, "error": err})
            return
        # client-controlled fields are type-checked HERE: a malformed
        # value must cost its sender one error line, never the server
        filename = msg.get("filename")
        if filename is not None and not isinstance(filename, str):
            self._emit(
                "raw",
                {"id": rid, "error": "bad_request: filename must be a string"},
            )
            return
        deadline_ms = msg.get("deadline_ms")
        if deadline_ms is not None and (
            isinstance(deadline_ms, bool)
            or not isinstance(deadline_ms, (int, float))
            or not deadline_ms >= 0  # rejects negatives AND NaN
        ):
            self._emit(
                "raw",
                {
                    "id": rid,
                    "error": "bad_request: deadline_ms must be a "
                    "non-negative number",
                },
            )
            return
        trace_id = msg.get("trace")
        if trace_id is not None and (
            not isinstance(trace_id, str) or not TRACE_ID_RE.match(trace_id)
        ):
            self._emit(
                "raw",
                {"id": rid,
                 "error": "bad_request: trace must be 16 lowercase hex"},
            )
            return
        try:
            req = self.batcher.submit(
                content,
                filename=filename,
                request_id=rid,
                deadline_ms=deadline_ms,
                trace_id=trace_id,
            )
        except QueueFullError as exc:
            row = {
                "id": rid,
                "error": "queue_full",
                "retry_after": exc.retry_after,
            }
            if exc.trace_id is not None:
                row["trace"] = exc.trace_id
            self._emit("raw", row)
            return
        except Exception as exc:  # noqa: BLE001 — session containment
            # a week-long worker answers an error row and keeps serving;
            # it never lets one request tear the session (or process) down
            self._emit(
                "raw", {"id": rid, "error": f"internal_error: {exc}"}
            )
            return
        self._emit("req", req)

    def finish(self) -> None:
        """EOF: let the writer drain every pending response, then stop."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._writer.join()


def serve_session(batcher: MicroBatcher, lines, write_line) -> dict:
    """Run one session: ``lines`` is an iterable of request lines,
    ``write_line(str)`` emits one response line.  Returns counts."""
    session = _Session(batcher, write_line)
    try:
        for line in lines:
            session.handle_line(line)
    finally:
        session.finish()
    return {"requests": session.requests, "responses": session.responses}


def serve_stdio(batcher: MicroBatcher, stdin=None, stdout=None) -> dict:
    """The pipe transport: JSONL in on stdin, JSONL out on stdout."""
    import sys

    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    lock = threading.Lock()

    def write_line(line: str) -> None:
        with lock:
            stdout.write(line + "\n")
            stdout.flush()

    return serve_session(batcher, stdin, write_line)


# sentinel marking end-of-stream on a session inbox
_EOF = object()

# inbound flow control: pause the socket read above HIGH queued lines,
# resume below LOW — the kernel socket buffer then pushes back on a
# client outrunning its session, exactly as blocking reads once did
_INBOX_HIGH = 1024
_INBOX_LOW = 256


class _SessionPump:
    """Glue between one LineConn (loop thread) and one session thread:
    lines flow loop -> inbox -> session, responses flow session ->
    ``conn.write_line`` -> loop.  The socket never parks the session
    thread, and the session never parks the loop."""

    def __init__(self, server: "JsonlUnixServer", conn: LineConn):
        self.server = server
        self.conn = conn
        self.inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._paused = False  # loop-thread written, session-thread read
        conn.on_line = self._on_line
        conn.on_close = self._on_close
        self.thread = threading.Thread(
            target=self._run_session_thread,
            name="serve-session",
            daemon=True,
        )
        self.thread.start()

    # -- loop side --

    def _on_line(self, line: str) -> None:
        self.inbox.put(line)
        if not self._paused and self.inbox.qsize() > _INBOX_HIGH:
            self._paused = True
            self.conn.pause_reading()

    def _on_close(self, _reason) -> None:
        self.server.forget_connection(self.conn)
        self.inbox.put(_EOF)

    # -- session side --

    def _lines(self):
        while True:
            item = self.inbox.get()
            if item is _EOF:
                return
            if self._paused and self.inbox.qsize() < _INBOX_LOW:
                self._paused = False
                self.conn.resume_reading_soon()
            yield item

    def _run_session_thread(self) -> None:
        try:
            self.server.run_session(self._lines(), self.conn.write_line)
        except OSError:
            pass  # peer (or server) went away mid-session
        finally:
            # flush the already-queued responses, then close
            self.conn.close_when_drained()


class JsonlUnixServer(LoopJsonlServer):
    """A Unix-socket JSONL server whose socket I/O rides the event loop
    (serve/eventloop.py): accepts, reads, writes, and slow-client
    reaping are loop callbacks, so a client that dribbles bytes or
    stops reading can never hold a thread.  Each connection still gets
    ONE session thread running ``run_session(lines, write_line)`` — the
    session may block on batcher results; the transport never blocks on
    the session's behalf.  Subclasses implement ``run_session`` — the
    serve worker runs the batcher session over this plumbing."""

    def __init__(
        self,
        path: str,
        *,
        loop=None,
        stall_timeout_s: float = 30.0,
    ):
        super().__init__(path, loop=loop, stall_timeout_s=stall_timeout_s)

    def handle_connection(self, sock) -> None:
        conn = LineConn(
            self.loop, sock, on_line=drop_line, on_close=drop_close
        )
        self.track_connection(conn)
        _SessionPump(self, conn)

    def run_session(self, lines, write_line) -> None:
        raise NotImplementedError



class UnixServer(JsonlUnixServer):
    """One JSONL session per connection, all sharing one batcher (and
    therefore one cache and one device pipeline).  Exposes the
    transport's event-loop lag as ``serve_loop_lag_ms`` on the
    batcher's registry — the gauge that says whether the I/O core
    itself ever stalls."""

    def __init__(self, path: str, batcher: MicroBatcher, **kwargs):
        self.batcher = batcher
        super().__init__(path, **kwargs)
        try:
            batcher.obs.registry.gauge(
                "serve_loop_lag_ms",
                "Smoothed transport event-loop lag (heartbeat lateness)",
            ).set_fn(self.loop.lag_ms)
        except (AttributeError, ValueError):
            pass  # a bare batcher stub without obs, or a re-bind

    def run_session(self, lines, write_line) -> None:
        serve_session(self.batcher, lines, write_line)


class TcpServer(UnixServer):
    """The serve worker on an AF_INET listener — the federation tier's
    worker transport.  ``UnixServer`` already routes ``host:port``
    targets to a TCP listener through ``parse_target`` (TCP_NODELAY on
    every accepted connection); this name makes the cross-host worker
    tier explicit and pins the port picked for a ``host:0`` bind as
    ``bound_port``."""


def serve_unix(batcher: MicroBatcher, path: str) -> None:
    """Serve forever on a Unix domain socket (Ctrl-C or SIGTERM to
    stop).  SIGTERM triggers a clean shutdown — the fleet supervisor's
    drain protocol ends with SIGTERM and expects the socket file
    unlinked and in-flight sessions completed, not an abort."""
    import signal

    with UnixServer(path, batcher) as server:
        def _term(*_):
            # shutdown() blocks until serve_forever exits, and the
            # handler runs ON serve_forever's thread — spawn the call
            # or the two deadlock waiting on each other
            threading.Thread(target=server.shutdown, daemon=True).start()

        try:
            # only the main thread may set signal handlers; anywhere
            # else (tests driving serve_unix from a thread) skip it
            signal.signal(signal.SIGTERM, _term)
        except ValueError:
            pass
        try:
            server.serve_forever(poll_interval=0.2)
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass


def selftest(verbose: bool = True, device="cuda") -> int:
    """End-to-end smoke of the whole serving stack on ``device``: exact
    prefilter, a Dice-scored micro-batch
    (deadline flush — the session is 3 requests, far under max_batch),
    a content-hash cache hit, the stats verb, the Prometheus exposition
    (every line must match the text-format grammar), trace propagation
    (every classification row echoes its request's trace ID), and a
    slow-request exemplar of a forced device failure with the slow
    threshold at 0.  On the CPU the failure falls back to the host
    algebra and its trace carries all five spans (cache_probe /
    featurize / queue_wait / device / fallback); on the card it answers
    a ``device_error`` row and its trace carries the first four, the
    device span naming the error.  Returns 0 on success — the CI gate
    and the `licensee-tpu serve --selftest` command."""
    import io
    import re

    from licensee_tpu_torch.corpus.license import License
    from licensee_tpu_torch.obs import check_exposition

    body = re.sub(
        r"\[(\w+)\]", "example", License.find("mit").content or ""
    )
    variant = body + "\nzqxa zqxb\n"
    session_lines = [
        json.dumps({"id": 1, "content": body, "filename": "LICENSE"}),
        json.dumps({"id": 2, "content": variant, "filename": "LICENSE"}),
        json.dumps({"id": 3, "content": variant, "filename": "LICENSE"}),
        json.dumps({"id": 4, "op": "stats"}),
        json.dumps({"id": 5, "op": "stats", "format": "prometheus"}),
        json.dumps({"id": 6, "op": "trace"}),
    ]
    out = io.StringIO()
    problems = []
    with MicroBatcher(
        max_batch=64, max_delay_ms=10.0, trace_sample=1.0,
        trace_slow_ms=0.0, device=device,
    ) as batcher:
        counts = serve_session(
            batcher, session_lines, lambda line: out.write(line + "\n")
        )
        # -- the degradation exemplar: a forced device failure, which
        # the CPU batcher answers through the host fallback (ALL FIVE
        # span kinds) and the card's with a device_error row;
        # trace_slow_ms=0 makes it a slow exemplar -- the flush path's
        # device seam is the async submit
        original = batcher.classifier.dispatch_chunks_async
        batcher.classifier.dispatch_chunks_async = _raise_injected
        try:
            fb = batcher.classify(body + "\nzqfb zqfc\n", "LICENSE")
        finally:
            batcher.classifier.dispatch_chunks_async = original
        on_card = batcher.classifier.device.type == "cuda"
        spans = {"cache_probe", "featurize", "queue_wait", "device"}
        if on_card:
            want_error = f"device_error: {_INJECTED}"
            if (fb.key, fb.matcher, fb.error) != (None, None, want_error):
                problems.append(f"device failure row: {fb.as_dict()}")
        else:
            spans.add("fallback")
            if (fb.key, fb.matcher) != ("mit", "dice"):
                problems.append(f"fallback verdict: {fb.as_dict()}")
        exemplar = None
        for t in batcher.trace_tail(50):
            names = {s["name"] for s in t.get("spans", ())}
            notes = [s.get("note") or "" for s in t.get("spans", ())
                     if s["name"] == "device"]
            if spans <= names and any(
                    n.startswith(f"error: {_INJECTED}") for n in notes):
                exemplar = t
                break
        if exemplar is None:
            problems.append(
                f"no slow-request exemplar with the spans {sorted(spans)} "
                f"in {batcher.trace_tail(50)}"
            )
        if batcher.stats()["scheduler"]["fallbacks"] != 1:
            problems.append(
                f"fallbacks: {batcher.stats()['scheduler']['fallbacks']}"
            )
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    if counts != {"requests": 6, "responses": 6}:
        problems.append(f"bad session counts: {counts}")
    else:
        by_id = {r["id"]: r for r in rows}
        if (by_id[1].get("key"), by_id[1].get("matcher")) != ("mit", "exact"):
            problems.append(f"exact prefilter: {by_id[1]}")
        if (by_id[2].get("key"), by_id[2].get("matcher")) != ("mit", "dice"):
            problems.append(f"dice micro-batch: {by_id[2]}")
        cached_row = {
            k: v for k, v in by_id[3].items() if k != "trace"
        }
        want = {
            k: v for k, v in by_id[2].items() if k != "trace"
        }
        if want != {**cached_row, "id": 2, "cached": False}:
            problems.append(f"cache hit disagrees: {by_id[3]} vs {by_id[2]}")
        if not by_id[3].get("cached"):
            problems.append(f"duplicate not cached: {by_id[3]}")
        # every classification row carries its own trace id
        trace_ids = [by_id[i].get("trace") for i in (1, 2, 3)]
        if not all(trace_ids) or len(set(trace_ids)) != 3:
            problems.append(f"trace ids missing/shared: {trace_ids}")
        stats = by_id[4].get("stats") or {}
        sched = stats.get("scheduler") or {}
        if sched.get("device_batches") != 1 or sched.get("device_rows") != 1:
            problems.append(f"scheduler counters: {sched}")
        # the duplicate deduplicated either way: a cache hit (flush won
        # the race) or an in-flight coalesce (the duplicate arrived
        # inside the same flush window) — both answer without a second
        # device row
        deduped = sched.get("cache_hits", 0) + sched.get("coalesced", 0)
        if deduped != 1:
            problems.append(f"duplicate not deduplicated: {sched}")
        for gauge in ("queue_depth", "in_flight"):
            if sched.get(gauge) != 0:
                problems.append(f"{gauge} gauge: {sched.get(gauge)!r}")
        if not isinstance(stats.get("uptime_s"), (int, float)):
            problems.append(f"uptime_s missing: {stats.get('uptime_s')!r}")
        exposition = by_id[5].get("prometheus") or ""
        grammar = check_exposition(exposition)
        if not exposition or grammar:
            problems.append(f"prometheus exposition: {grammar[:3]}")
        if "serve_stage_seconds_bucket" not in exposition:
            problems.append("exposition missing serve_stage_seconds")
        if not by_id[6].get("traces"):
            problems.append("trace verb returned no traces")
    if verbose:
        summary = {
            "selftest": "ok" if not problems else "FAIL",
            "problems": problems,
            "responses": len(rows),
        }
        print(json.dumps(summary))
    return 0 if not problems else 1


_INJECTED = "selftest: injected device failure"


def _raise_injected(*args, **kwargs):
    raise RuntimeError(_INJECTED)


def selftest_reload(verbose: bool = True, device="cuda") -> int:
    """End-to-end smoke of the corpus hot-swap path on ``device`` (the
    `serve --selftest-reload` CI gate): build a corpus
    artifact, serve live traffic from the vendored corpus, reload to
    the artifact UNDER that traffic, and assert

    * the reload verb answers ok and the fingerprint flipped;
    * zero traffic errors across the swap, every response carrying
      exactly one known fingerprint (old or new, never anything else);
    * post-swap answers are re-validated: the first post-swap repeat of
      a pre-swap-cached blob is NOT served from cache (the fingerprint
      fence), yet still classifies correctly under the new corpus;
    * a corrupt artifact and an unloadable source are both refused
      while the worker keeps serving, fingerprint unchanged.
    """
    import re
    import tempfile
    import time

    from licensee_tpu_torch.corpus.artifact import write_artifact
    from licensee_tpu_torch.corpus.license import License
    from licensee_tpu_torch.corpus.spdx import spdx_corpus

    problems: list[str] = []
    body = re.sub(
        r"\[(\w+)\]", "example", License.find("mit").content or ""
    )
    with tempfile.TemporaryDirectory(prefix="licensee-reload-") as tmp:
        artifact = os.path.join(tmp, "spdx.corpus.npz")
        write_artifact(artifact, spdx_corpus(None), source="spdx")
        corrupt = os.path.join(tmp, "corrupt.corpus.npz")
        with open(corrupt, "wb") as f:
            f.write(b"not a corpus artifact at all")
        stop = threading.Event()
        rows: list = []
        errors: list = []

        with MicroBatcher(
            max_batch=32, max_delay_ms=5.0, corpus_source="vendored",
            device=device,
        ) as batcher:
            fp_old = batcher.corpus_fingerprint

            def traffic() -> None:
                i = 0
                while not stop.is_set():
                    blob = f"{body}\nzqswap{i} zqdrill{i % 7}\n"
                    try:
                        rows.append(batcher.submit(blob, "LICENSE"))
                    except Exception as exc:  # noqa: BLE001 — the gate counts these
                        errors.append(str(exc))
                    i += 1
                    time.sleep(0.002)

            t = threading.Thread(target=traffic, daemon=True)
            t.start()
            time.sleep(0.1)  # real in-flight load during the swap
            # -- cache-fence seed: classify + repeat (cached) pre-swap --
            seed = body + "\nzqfence zqfence2\n"
            first = batcher.classify(seed, "LICENSE")
            again = batcher.submit(seed, "LICENSE")
            again_res = again.wait(60.0)
            if (first.key, again_res.key) != ("mit", "mit"):
                problems.append(
                    f"pre-swap verdicts: {first.key} / {again_res.key}"
                )
            if not again.cached:
                problems.append("pre-swap repeat was not served cached")
            # -- the swap, under traffic --
            out = batcher.reload_corpus(artifact)
            fp_new = out["fingerprint"]
            if not out.get("ok") or fp_new == fp_old:
                problems.append(f"reload did not flip: {out}")
            if batcher.corpus_fingerprint != fp_new:
                problems.append("active fingerprint is not the new one")
            # -- post-swap: the pre-swap cached verdict must NOT serve --
            post = batcher.submit(seed, "LICENSE")
            post_res = post.wait(60.0)
            if post.cached:
                problems.append(
                    "post-swap repeat served a pre-swap cached verdict"
                )
            if post_res.key != "mit":
                problems.append(f"post-swap verdict: {post_res.key!r}")
            if post.corpus_fp != fp_new:
                problems.append(
                    f"post-swap answer not attributed to the new corpus: "
                    f"{post.corpus_fp}"
                )
            # -- refusal paths: corrupt artifact, unloadable source --
            from licensee_tpu_torch.serve.reload import ReloadRejectedError

            for bad in (corrupt, os.path.join(tmp, "missing.npz")):
                try:
                    batcher.reload_corpus(bad)
                    problems.append(f"reload of {bad!r} was not refused")
                except ReloadRejectedError:
                    pass
            if batcher.corpus_fingerprint != fp_new:
                problems.append("refused reload changed the fingerprint")
            check = batcher.classify(body + "\nzqafter zqbad\n", "LICENSE")
            if check.key != "mit":
                problems.append(f"post-refusal verdict: {check.key}")
            stop.set()
            t.join(timeout=10.0)
            # -- the traffic gate: zero errors, single-fingerprint rows --
            unfinished = 0
            for req in rows:
                if not req.done.wait(60.0):
                    unfinished += 1
                    continue
                if req.result is not None and req.result.error:
                    errors.append(req.result.error)
                if req.corpus_fp not in (fp_old, fp_new):
                    problems.append(
                        f"row attributed to unknown corpus {req.corpus_fp}"
                    )
                elif req.result is not None and req.result.key != "mit":
                    errors.append(f"wrong verdict {req.result.key}")
            if unfinished:
                problems.append(f"{unfinished} requests never finished")
            if errors:
                problems.append(
                    f"{len(errors)} traffic errors, e.g. {errors[:3]}"
                )
            stats = batcher.stats()
            if stats["scheduler"].get("reloads") != 1:
                problems.append(f"reload counter: {stats['scheduler']}")
            if stats["corpus"].get("fingerprint") != fp_new:
                problems.append(f"stats corpus: {stats['corpus']}")
    if verbose:
        print(json.dumps({
            "reload_selftest": "ok" if not problems else "FAIL",
            "problems": problems,
            "requests": len(rows),
        }))
    return 0 if not problems else 1
