"""Fault injection for the fleet: kill / hang / slow-walk live worker
processes, plus a protocol-faithful STUB WORKER for harness runs that
don't need a device path.

The faults are real OS-level faults against real processes — SIGKILL
(crash), SIGSTOP (wedge: alive but silent), and a SIGSTOP/SIGCONT duty
cycle (slow-walk: the brownout that health checks miss but tail
latency exposes) — plus :class:`Slowloris`, the slow/partial-WRITER
client (dribbled bytes, or a half-close mid-line) that a correct
event-loop server must reap without spending a thread or a pool slot
on it.  The selftest (fleet/selftest.py) drives them under live
traffic and asserts the client never sees an error.

The stub worker (``python -m licensee_tpu_torch.fleet.faults --socket P``)
speaks the serve JSONL contract — content rows, ``stats``/``trace``/
``reload`` verbs, trace-ID adoption, ``queue_full`` shedding, corpus
fingerprints on stats and content rows — with configurable misbehavior
(``--service-ms``, ``--hang-after``, ``--exit-after``, ``--queue-full``,
``--fingerprint``, ``--reload-deny``, and scripted reload values:
``slow:MS:FP`` sleeps mid-swap, ``fail:``/``corrupt:`` refuse,
``hang`` wedges), so router/supervisor tests and the rolling-upgrade
drills exercise real processes, real sockets, and real SIGKILL in
milliseconds instead of paying a torch import per worker.

House rules (script/lint): monotonic clocks only, no print — the stub
talks through its socket and reports errors on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import socket
import socketserver
import sys
import threading
import time
from collections import deque

from licensee_tpu_torch.obs.flight import (
    FlightRecorder,
    flight_path_for_socket,
)
from licensee_tpu_torch.serve.eventloop import parse_target


def kill(pid: int) -> None:
    """The crash fault: SIGKILL, no cleanup, no goodbye — the worker's
    socket file stays behind (the stale-socket fix reclaims it)."""
    os.kill(pid, signal.SIGKILL)


def hang(pid: int) -> None:
    """The wedge fault: SIGSTOP freezes the process mid-whatever; it
    stays alive (poll() sees nothing) but answers no probe."""
    os.kill(pid, signal.SIGSTOP)


def resume(pid: int) -> None:
    os.kill(pid, signal.SIGCONT)


def _dial_stream(
    target: str, timeout_s: float | None = None
) -> socket.socket:
    """Blocking harness-side dial of a parse_target target: the right
    address family, TCP_NODELAY on AF_INET, connected (or OSError).
    The load generators and fault clients all go through here so every
    drill runs unchanged against Unix sockets and TCP endpoints."""
    kind, addr = parse_target(target)
    family = socket.AF_INET if kind == "tcp" else socket.AF_UNIX
    sock = socket.socket(family, socket.SOCK_STREAM)
    try:
        if timeout_s is not None:
            sock.settimeout(timeout_s)
        if kind == "tcp":
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.connect(addr if kind == "tcp" else target)
    except OSError:
        sock.close()
        raise
    return sock


class SlowWalker:
    """The brownout fault: duty-cycle SIGSTOP/SIGCONT so the worker
    still answers — eventually.  ``duty`` is the STOPPED fraction of
    each ``period_s``."""

    def __init__(self, pid: int, *, duty: float = 0.8,
                 period_s: float = 0.1):
        if not (0.0 < duty < 1.0):
            raise ValueError(f"duty must be in (0, 1), got {duty!r}")
        self.pid = pid
        self.duty = float(duty)
        self.period_s = float(period_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._walk, name="fleet-slowwalk", daemon=True
        )
        self._thread.start()

    def _walk(self) -> None:
        while not self._stop.is_set():
            try:
                os.kill(self.pid, signal.SIGSTOP)
                if self._stop.wait(self.period_s * self.duty):
                    break
                os.kill(self.pid, signal.SIGCONT)
                if self._stop.wait(self.period_s * (1.0 - self.duty)):
                    break
            except ProcessLookupError:
                return  # the victim died: nothing left to torment
        try:
            os.kill(self.pid, signal.SIGCONT)  # never leave it frozen
        except ProcessLookupError:
            pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class Slowloris:
    """The slow/partial-writer fault against a JSONL socket server: a
    client that starts a request line and never finishes it.

    ``mode="dribble"`` sends one byte of a request every
    ``byte_interval_s`` — forever mid-line, never a newline.
    ``mode="half_close"`` sends half a line then shuts down its write
    side (the torn client).  Either way a correct event-loop server
    must REAP the connection once the partial line has stalled past its
    ``stall_timeout_s`` — without holding a session, a thread, or a
    backend pool slot meanwhile.

    ``run()`` blocks until the server closes the connection or
    ``give_up_s`` passes, and returns ``{"reaped", "elapsed_s",
    "sent_bytes"}`` — the selftest's gate is ``reaped=True`` while
    normal traffic on OTHER connections kept answering.

    ``path`` is a parse_target target (Unix path or ``host:port``) and
    ``payload`` the never-finished request — the default is a JSONL
    content row; the HTTP edge drill dribbles a header block instead
    (same sweep, same reap)."""

    def __init__(self, path: str, *, mode: str = "dribble",
                 byte_interval_s: float = 0.2, give_up_s: float = 30.0,
                 payload: bytes | None = None):
        if mode not in ("dribble", "half_close"):
            raise ValueError(f"unknown slowloris mode {mode!r}")
        self.path = path
        self.mode = mode
        self.byte_interval_s = float(byte_interval_s)
        self.give_up_s = float(give_up_s)
        self.payload = (
            payload if payload is not None
            else b'{"content": "never finished'
        )

    def run(self) -> dict:
        import socket as socketlib

        payload = self.payload
        sent = 0
        t0 = time.perf_counter()
        sock = None
        try:
            sock = _dial_stream(self.path, timeout_s=self.give_up_s)
            if self.mode == "half_close":
                sock.sendall(payload)
                sent = len(payload)
                sock.shutdown(socketlib.SHUT_WR)
            deadline = t0 + self.give_up_s
            poll_s = (
                self.byte_interval_s if self.mode == "dribble" else 0.2
            )
            while time.perf_counter() < deadline:
                if self.mode == "dribble":
                    try:
                        sock.sendall(payload[sent % len(payload):][:1])
                        sent += 1
                    except OSError:
                        # EPIPE/reset on send: the server dropped us
                        return self._result(True, t0, sent)
                # a read tells us whether the server hung up: EOF (or
                # reset) == reaped; timeout == still tolerated
                sock.settimeout(poll_s)
                try:
                    if sock.recv(4096) == b"":
                        return self._result(True, t0, sent)
                    # any actual bytes would be a protocol violation —
                    # the server must never answer a half request; keep
                    # watching, the gate is the close
                except socketlib.timeout:
                    continue
                except OSError:
                    return self._result(True, t0, sent)
            return self._result(False, t0, sent)
        except OSError:
            return self._result(False, t0, sent)
        finally:
            if sock is not None:
                sock.close()

    def _result(self, reaped: bool, t0: float, sent: int) -> dict:
        return {
            "reaped": reaped,
            "elapsed_s": round(time.perf_counter() - t0, 3),
            "sent_bytes": sent,
        }


def open_loop_client(
    path: str,
    rate: float,
    duration_s: float,
    timeout_s: float = 30.0,
) -> dict:
    """One open-loop JSONL client connection for the saturation bench:
    request lines go out at a fixed TARGET RATE regardless of how the
    server is doing (real-traffic arrival — a struggling server does
    not slow its users down), responses are counted (and latency-
    stamped) from raw chunks.  Runs as a SUBPROCESS (``python -m
    licensee_tpu_torch.fleet.faults --open-loop-client ...``) so the load
    generator never shares the router process's GIL — in-process client
    threads were the measurement fighting the measured.

    Returns ``{"sent", "answered", "stalled", "elapsed_s",
    "send_elapsed_s", "lats_ms"}`` — per-request latencies in
    milliseconds, matched to send stamps by response order (the session
    answers in request order).  ``send_elapsed_s`` covers only the send
    window: ``sent / send_elapsed_s`` is the OFFERED arrival rate,
    while ``elapsed_s`` additionally spans the queue drain after the
    last send."""
    line = (json.dumps({"content": "saturation probe"}) + "\n").encode(
        "utf-8"
    )
    stamps: deque = deque()
    lats: list[float] = []
    state = {"sent": 0, "answered": 0, "stalled": False}
    final: dict = {"n": None}
    t0 = time.perf_counter()
    sock = None
    try:
        try:
            sock = _dial_stream(path, timeout_s=timeout_s)
        except OSError:
            state["stalled"] = True
            return {**state, "elapsed_s": 0.0, "lats_ms": []}

        def read_loop() -> None:
            # responses are ordered per session: counting newlines in
            # raw chunks matches them to send stamps without a readline
            # (or a parse) per row
            while True:
                if final["n"] is not None and state["answered"] >= final["n"]:
                    return
                try:
                    chunk = sock.recv(1 << 16)
                except OSError:  # timeout: a stalled client
                    state["stalled"] = True
                    return
                if not chunk:
                    state["stalled"] = True
                    return
                k = chunk.count(b"\n")
                if k:
                    now = time.perf_counter()
                    for _ in range(k):
                        lats.append((now - stamps.popleft()) * 1000.0)
                    state["answered"] += k

        reader = threading.Thread(target=read_loop, daemon=True)
        reader.start()
        tick_s = 0.01
        per_tick = rate * tick_s
        credit = 0.0
        next_tick = t0
        try:
            while time.perf_counter() - t0 < duration_s:
                credit += per_tick
                n = int(credit)
                credit -= n
                if n:
                    now = time.perf_counter()
                    stamps.extend([now] * n)
                    state["sent"] += n
                    sock.sendall(line * n)  # the tick's burst, one write
                next_tick += tick_s
                delay = next_tick - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            # the drain sentinel: sent AFTER the loop, then final["n"]
            # is armed — the reader always has one more response coming
            # and exits exactly when everything (sentinel included)
            # answered
            stamps.append(time.perf_counter())
            sock.sendall(line)
            state["sent"] += 1
        except OSError:
            state["stalled"] = True
        send_elapsed = time.perf_counter() - t0
        final["n"] = state["sent"]
        reader.join(timeout=timeout_s + 5.0)
        if reader.is_alive() or state["answered"] < state["sent"]:
            state["stalled"] = True
        return {
            **state,
            "elapsed_s": round(time.perf_counter() - t0, 4),
            "send_elapsed_s": round(send_elapsed, 4),
            "lats_ms": [round(x, 2) for x in lats],
        }
    finally:
        try:
            if sock is not None:
                sock.close()
        except OSError:
            pass


# an HTTP/1.1 status line's head: how responses are counted without a
# full parse (response bodies are JSON rows — the marker cannot appear
# inside one)
_HTTP_STATUS_RE = re.compile(rb"HTTP/1\.[01] (\d{3})")


def open_loop_http_client(
    path: str,
    rate: float,
    duration_s: float,
    token: str | None = None,
    timeout_s: float = 30.0,
) -> dict:
    """The HTTP twin of :func:`open_loop_client` for the edge
    saturation bench: pipelined keep-alive ``POST /classify`` requests
    at a fixed TARGET RATE on one TCP connection, responses counted
    (and latency-stamped, matched by order — HTTP/1.1 answers in
    request order) from status lines in raw chunks.  Also a
    SUBPROCESS, for the same GIL-isolation reason.  Returns the
    open_loop_client dict plus ``non_200`` (any non-200 status fails
    the rung — the edge contract under saturation is 200 or a paced
    429, and the bench offers under the admission cap)."""
    body = json.dumps({"content": "saturation probe"}).encode("utf-8")
    auth = f"Authorization: Bearer {token}\r\n" if token else ""
    line = (
        f"POST /classify HTTP/1.1\r\n"
        f"Host: edge\r\n{auth}"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\n\r\n"
    ).encode("utf-8") + body
    stamps: deque = deque()
    lats: list[float] = []
    state = {"sent": 0, "answered": 0, "non_200": 0, "stalled": False}
    final: dict = {"n": None}
    t0 = time.perf_counter()
    sock = None
    try:
        try:
            sock = _dial_stream(path, timeout_s=timeout_s)
        except OSError:
            state["stalled"] = True
            return {**state, "elapsed_s": 0.0, "lats_ms": []}

        def read_loop() -> None:
            tail = b""
            while True:
                if (
                    final["n"] is not None
                    and state["answered"] >= final["n"]
                ):
                    return
                try:
                    chunk = sock.recv(1 << 16)
                except OSError:  # timeout: a stalled client
                    state["stalled"] = True
                    return
                if not chunk:
                    state["stalled"] = True
                    return
                buf = tail + chunk
                k = 0
                last_end = 0
                for m in _HTTP_STATUS_RE.finditer(buf):
                    k += 1
                    last_end = m.end()
                    if m.group(1) != b"200":
                        state["non_200"] += 1
                # keep only unmatched trailing bytes (a status line
                # split across chunks) — never bytes of a counted match
                tail = buf[max(last_end, len(buf) - 11):]
                if k:
                    now = time.perf_counter()
                    for _ in range(min(k, len(stamps))):
                        lats.append((now - stamps.popleft()) * 1000.0)
                    state["answered"] += k

        reader = threading.Thread(target=read_loop, daemon=True)
        reader.start()
        tick_s = 0.01
        per_tick = rate * tick_s
        credit = 0.0
        next_tick = t0
        try:
            while time.perf_counter() - t0 < duration_s:
                credit += per_tick
                n = int(credit)
                credit -= n
                if n:
                    now = time.perf_counter()
                    stamps.extend([now] * n)
                    state["sent"] += n
                    sock.sendall(line * n)
                next_tick += tick_s
                delay = next_tick - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            stamps.append(time.perf_counter())
            sock.sendall(line)  # the drain sentinel
            state["sent"] += 1
        except OSError:
            state["stalled"] = True
        send_elapsed = time.perf_counter() - t0
        final["n"] = state["sent"]
        reader.join(timeout=timeout_s + 5.0)
        if reader.is_alive() or state["answered"] < state["sent"]:
            state["stalled"] = True
        return {
            **state,
            "elapsed_s": round(time.perf_counter() - t0, 4),
            "send_elapsed_s": round(send_elapsed, 4),
            "lats_ms": [round(x, 2) for x in lats],
        }
    finally:
        try:
            if sock is not None:
                sock.close()
        except OSError:
            pass


def _client_main(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="licensee-tpu-torch-open-loop-client",
        description="Open-loop saturation client (bench harness)",
    )
    parser.add_argument("--open-loop-client", metavar="TARGET")
    parser.add_argument("--open-loop-http", metavar="TARGET")
    parser.add_argument("--rate", type=float, required=True)
    parser.add_argument("--duration-s", type=float, required=True)
    parser.add_argument("--timeout-s", type=float, default=30.0)
    parser.add_argument("--token", default=None)
    args = parser.parse_args(argv)
    if args.open_loop_http:
        out = open_loop_http_client(
            args.open_loop_http, args.rate, args.duration_s,
            token=args.token, timeout_s=args.timeout_s,
        )
    else:
        out = open_loop_client(
            args.open_loop_client, args.rate, args.duration_s,
            timeout_s=args.timeout_s,
        )
    sys.stdout.write(json.dumps(out) + "\n")
    return 0


# -- the stub worker ---------------------------------------------------


class _StubState:
    """Shared across stub sessions: counters, the trace ring, and the
    scripted misbehavior."""

    def __init__(self, args):
        self.args = args
        self.name = args.name
        self.t0 = time.perf_counter()
        self.lock = threading.Lock()
        self.completed = 0
        self.in_flight = 0
        self.admitted = 0
        # --slow-span START:COUNT:MS parsed once: (start, count, ms)
        self.slow_span = None
        if getattr(args, "slow_span", None):
            start, count, ms = args.slow_span.split(":")
            self.slow_span = (int(start), int(count), float(ms))
        # 256 deep: the SIGKILL drill assembles a failover trace from
        # this tail AFTER the remaining stream drained onto the
        # surviving worker — 64 evicted the evidence
        self.traces: deque = deque(maxlen=256)
        self.hang_forever = threading.Event()
        # the stub keeps a real flight recorder (obs/flight.py) on the
        # same black-box convention as a serve worker, so the fleet
        # drills exercise the supervisor's SIGKILL harvest in
        # milliseconds without a torch boot
        self.flight = FlightRecorder(
            flight_path_for_socket(args.socket),
            proc=args.name,
            flush_interval_s=0.05,
        ).start()
        # the corpus-lifecycle twin: a fingerprint/source pair the
        # reload verb swaps, echoed on stats and content rows exactly
        # like a real serve worker — the fleet reload drills ride this
        self.fingerprint = args.fingerprint
        self.corpus_source = args.fingerprint
        self.reloads = 0
        self.reload_lock = threading.Lock()


def _stub_reload(state: _StubState, msg: dict) -> dict | None:
    """The stub's reload verb, protocol-identical to a serve worker's:

    * any value -> swap to that value as the new fingerprint+source;
    * ``slow:<ms>:<value>`` -> sleep mid-swap first (the window the
      SIGKILL-mid-swap drill aims at);
    * ``fail:...`` / ``corrupt:...`` or a value matching
      ``--reload-deny`` -> refuse like a failed validation gate, keep
      the old fingerprint;
    * ``hang`` -> never answer (the wedge);
    * a second concurrent reload -> ``reload_in_progress``."""
    rid = msg.get("id")
    corpus = msg.get("corpus")
    if not isinstance(corpus, str) or not corpus:
        return {"id": rid,
                "error": "bad_request: reload needs a 'corpus' "
                "source string"}
    if not state.reload_lock.acquire(blocking=False):
        return {"id": rid, "error": "reload_in_progress"}
    try:
        if corpus.startswith("slow:"):
            _, ms, corpus = corpus.split(":", 2)
            time.sleep(float(ms) / 1000.0)
        if corpus == "hang":
            return None
        deny = state.args.reload_deny
        if corpus.startswith(("fail:", "corrupt:")) or (
            deny and corpus.startswith(deny)
        ):
            return {
                "id": rid,
                "error": f"reload_failed: injected refusal of {corpus!r}",
                "problems": [f"injected refusal of {corpus!r}"],
            }
        with state.lock:
            previous = state.fingerprint
            state.fingerprint = corpus
            state.corpus_source = corpus
            state.reloads += 1
        state.flight.record(
            "reload_swap", fingerprint=corpus, previous=previous
        )
        return {
            "id": rid,
            "reload": {
                "ok": True,
                "fingerprint": corpus,
                "previous": previous,
                "unchanged": corpus == previous,
                "source": corpus,
            },
        }
    finally:
        state.reload_lock.release()


def _stub_answer(state: _StubState, msg: dict) -> dict | None:
    """One stub response row; None hangs the session (the wedge)."""
    args = state.args
    rid = msg.get("id")
    op = msg.get("op")
    if op == "stats":
        with state.lock:
            completed, in_flight = state.completed, state.in_flight
            fingerprint = state.fingerprint
            source = state.corpus_source
            reloads = state.reloads
        if msg.get("format") == "prometheus":
            text = (
                "# HELP stub_requests_total Stub worker requests.\n"
                "# TYPE stub_requests_total counter\n"
                f"stub_requests_total {completed}\n"
            )
            return {"id": rid, "prometheus": text}
        return {
            "id": rid,
            "stats": {
                "uptime_s": round(time.perf_counter() - state.t0, 3),
                "worker": state.name,
                "corpus": {
                    "fingerprint": fingerprint,
                    "source": source,
                    "reloads": reloads,
                },
                "scheduler": {
                    "queue_depth": args.report_load,
                    "in_flight": in_flight,
                    "completed": completed,
                },
            },
        }
    if op == "reload":
        return _stub_reload(state, msg)
    if op == "trace":
        with state.lock:
            tail = list(state.traces)[-int(msg.get("n", 20)):]
        return {"id": rid, "traces": tail}
    if op == "diff":
        # protocol-faithful, semantically canned (like the stub's
        # verdict rows): the real worker's word-diff verb answers a
        # "diff" object keyed by the comparison target, echoing the
        # router-spliced trace for the pipelining cross-check
        row = {
            "id": rid,
            "diff": {
                "key": "stub-mit",
                "similarity": 0.99,
                "identical": False,
                "diff": "{+stub+}",
            },
        }
        if msg.get("trace"):
            row["trace"] = msg["trace"]
        return row
    if op is not None:
        return {"id": rid, "error": f"bad_request: unknown op {op!r}"}
    # a content row
    if args.queue_full:
        state.flight.record("error", what="queue_full", id=rid)
        return {"id": rid, "error": "queue_full", "retry_after": 0.05}
    state.flight.record("admission", id=rid, trace=msg.get("trace"))
    with state.lock:
        state.in_flight += 1
        state.admitted += 1
        n_admit = state.admitted
    # the scripted latency fault: inside the --slow-span window this
    # row serves at the fault latency, not --service-ms — admission
    # order (not completion order) picks the victims so concurrent
    # rows cannot shrink the span
    delay_ms = args.service_ms
    span = state.slow_span
    if span is not None and span[0] < n_admit <= span[0] + span[1]:
        delay_ms = span[2]
    try:
        if delay_ms:
            time.sleep(delay_ms / 1000.0)
        with state.lock:
            state.completed += 1
            n = state.completed
            trace_id = msg.get("trace")
            if trace_id:
                # the same tail-row shape a real worker's tracer
                # serves: kind/proc tags + a dur so the fleet
                # collector joins and attributes without heuristics
                state.traces.append({
                    "trace": trace_id, "id": rid, "kind": "trace",
                    "proc": state.name, "status": "ok",
                    "dur_ms": float(delay_ms),
                    "spans": [{"name": "stub_serve", "t_ms": 0.0,
                               "dur_ms": float(delay_ms)}],
                })
    finally:
        with state.lock:
            state.in_flight -= 1
    if args.hang_after and n > args.hang_after:
        return None  # N answers delivered; silence from here on (wedge)
    if args.exit_after and n >= args.exit_after:
        # crash AFTER answering: the next request finds a dead socket
        threading.Timer(0.05, os._exit, args=(41,)).start()
    with state.lock:
        fingerprint = state.fingerprint
    row = {
        "id": rid, "key": "stub-mit", "matcher": "stub",
        "confidence": 99.0, "cached": False, "stub_worker": state.name,
        # one fingerprint per answer, like a real worker's corpus field
        "corpus": fingerprint,
    }
    if msg.get("trace"):
        row["trace"] = msg["trace"]
    return row


class _StubServer(socketserver.ThreadingMixIn,
                  socketserver.UnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class _StubTcpServer(socketserver.ThreadingMixIn,
                     socketserver.TCPServer):
    """The stub worker on an AF_INET listener (``--socket host:port``)
    — the TCP federation drills supervise stubs over loopback TCP with
    the exact machinery the Unix-socket drills use."""

    daemon_threads = True
    allow_reuse_address = True


class _StubHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        # responses are coalesced per read-batch — one sendall carries
        # every answer the batch produced, exactly like the real
        # worker's event-loop transport (serve/eventloop.py flushes
        # writes once per loop pass).  Per-line flushing made the STUB
        # the syscall bottleneck of the router saturation bench.
        state: _StubState = self.server.state
        sock = self.connection
        if sock.family == socket.AF_INET:
            try:
                # coalesced batch responses must not sit out a Nagle
                # delay against the router's pipelined reads
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        buf = bytearray()
        while True:
            try:
                chunk = sock.recv(65536)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            if b"\n" not in chunk:
                continue
            *lines, rest = buf.split(b"\n")
            buf = bytearray(rest)
            out = bytearray()
            for raw in lines:
                line = raw.decode("utf-8", errors="replace").strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    msg = {}
                row = _stub_answer(state, msg)
                if row is None:
                    # wedge: answers already produced still flush —
                    # same client view as the per-line writer gave
                    if out:
                        try:
                            sock.sendall(out)
                        except OSError:
                            return
                    state.hang_forever.wait()  # wedged, forever
                    return
                out += json.dumps(row).encode("utf-8") + b"\n"
            if out:
                try:
                    sock.sendall(out)
                except OSError:
                    return


def stub_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="licensee-tpu-torch-stub-worker",
        description="Protocol-faithful stub serve worker (fault harness)",
    )
    parser.add_argument("--socket", required=True)
    parser.add_argument("--name", default="stub")
    parser.add_argument("--service-ms", type=float, default=0.0)
    parser.add_argument(
        "--report-load", type=int, default=0,
        help="Static queue_depth to report in stats (routing tests)",
    )
    parser.add_argument(
        "--hang-after", type=int, default=0,
        help="After N answers, stop responding (stay alive): the wedge",
    )
    parser.add_argument(
        "--exit-after", type=int, default=0,
        help="After N answers, exit(41): the scripted crash",
    )
    parser.add_argument(
        "--queue-full", action="store_true",
        help="Answer every content row with queue_full backpressure",
    )
    parser.add_argument(
        "--fingerprint", default="stub-fp-0",
        help="The corpus fingerprint/source this stub reports until a "
        "reload verb swaps it (the corpus-lifecycle drills)",
    )
    parser.add_argument(
        "--reload-deny", default=None, metavar="PREFIX",
        help="Refuse reload verbs whose corpus value starts with "
        "PREFIX (the per-worker validation-failure script)",
    )
    parser.add_argument(
        "--slow-span", default=None, metavar="START:COUNT:MS",
        help="Scripted latency fault: after the START-th admitted "
        "content row, the next COUNT rows serve in MS milliseconds "
        "instead of --service-ms (the telemetry-plane p99 drill)",
    )
    args = parser.parse_args(argv)
    kind, addr = parse_target(args.socket)
    try:
        if kind == "tcp":
            server = _StubTcpServer(addr, _StubHandler)
        else:
            if os.path.exists(args.socket):
                os.unlink(args.socket)
            server = _StubServer(args.socket, _StubHandler)
    except OSError as exc:
        sys.stderr.write(f"stub worker: cannot bind: {exc}\n")
        return 1
    server.state = _StubState(args)
    try:
        server.serve_forever(poll_interval=0.1)
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.state.flight.stop()  # the clean-shutdown black box
        if kind == "unix":
            try:
                os.unlink(args.socket)
            except OSError:
                pass
    return 0


if __name__ == "__main__":
    if "--open-loop-client" in sys.argv or "--open-loop-http" in sys.argv:
        sys.exit(_client_main(sys.argv[1:]))
    sys.exit(stub_main())
