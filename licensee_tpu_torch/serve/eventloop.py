"""The non-blocking I/O core shared by the serve transport and the
fleet router: ONE single-threaded ``selectors`` event loop carrying
every client connection, every per-worker backend connection, and every
timer — so a slow or dead peer can never park a thread that other
connections need.

Three pieces, bottom up:

* :class:`EventLoop` — a thread-hosted ``selectors.DefaultSelector``
  loop with a self-pipe wakeup, monotonic timers
  (:meth:`EventLoop.call_later`), cross-thread submission
  (:meth:`EventLoop.call_soon_threadsafe`), and an always-armed
  heartbeat that prices loop responsiveness as a lag gauge
  (``lag_ms``): if a callback ever blocks the loop, the gauge says so
  before the tail latencies do.
* :class:`LineConn` — one non-blocking stream socket speaking JSONL:
  buffered reads split into lines, buffered writes flushed as the
  socket drains (a slow READER costs memory up to ``max_write_bytes``,
  then the connection — never a parked thread), and a
  ``partial_since`` stamp that marks a peer mid-line (the slowloris
  tell: bytes without a newline).
* :class:`LoopJsonlServer` — a listening socket on a loop; accepts are
  loop callbacks, each connection becomes a LineConn handed to
  ``handle_connection``, and a periodic sweep reaps connections whose
  partial line has stalled longer than ``stall_timeout_s`` (a client
  that dribbles bytes or half-closes mid-line is closed and forgotten —
  it never holds a session, a thread, or a pool slot).  The listener is
  a Unix socket OR an AF_INET one: every transport target in the tree
  goes through :func:`parse_target`, so ``"host:port"`` anywhere a
  socket path is accepted puts that endpoint on TCP (with TCP_NODELAY —
  a JSONL request/response protocol dies under Nagle+delayed-ACK) and
  the fleet tier federates across hosts on the very same loop
  machinery.

Everything here is loop-thread-disciplined: ``register``/``close``/
``write`` mutations happen on the loop thread (cross-thread callers go
through ``call_soon_threadsafe``), so the state machines need no locks
of their own.  The analyzer's ``blocking-call`` rule walks every
``_on_*`` callback in this file (rules_concurrency.py): blocking
primitives on the loop thread are findings, and the two sanctioned
non-blocking socket verbs below carry explicit pragmas.

House rules (script/lint): monotonic clocks only, no print.
"""

from __future__ import annotations

import errno
import heapq
import os
import socket
import stat
import threading
import time
from collections import deque
from itertools import islice

import selectors


class LoopClosedError(RuntimeError):
    """The event loop has been stopped; nothing further can run on it."""


def parse_target(target: str) -> tuple[str, object]:
    """Classify one transport target: ``("tcp", (host, port))`` for a
    ``host:port`` string, ``("unix", path)`` for everything else.

    The rule is conservative so no existing socket path changes
    meaning: a target counts as TCP only when it contains no path
    separator AND ends in ``:<digits>`` with a non-empty host.  A bare
    name ("w0.sock"), an absolute path, and a relative path all stay
    AF_UNIX."""
    if os.path.sep not in target:
        host, sep, port = target.rpartition(":")
        if sep and host and port.isdigit():
            return "tcp", (host, int(port))
    return "unix", target


class Timer:
    """Handle for one scheduled callback; ``cancel()`` is idempotent
    and safe from any thread."""

    __slots__ = ("when", "fn", "args", "cancelled")

    def __init__(self, when: float, fn, args):
        self.when = when
        self.fn = fn
        self.args = args
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class EventLoop:
    """A single-threaded selectors loop: fd callbacks, timers, and
    cross-thread submissions, with a heartbeat-driven lag gauge."""

    def __init__(self, name: str = "io-loop", heartbeat_s: float = 0.1):
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(
            self._wake_r, selectors.EVENT_READ, self._on_wake
        )
        self._lock = threading.Lock()
        self._ready: deque = deque()
        self._timers: list = []
        self._timer_seq = 0
        # cancelled timers stay in the heap until due (cancel() is
        # O(1) from any thread); at router saturation rates that is
        # thousands of dead entries per second, so the loop compacts
        # the heap whenever it outgrows this watermark
        self._timer_compact_at = 1024
        self._closed = False
        self._thread: threading.Thread | None = None
        self._tid: int | None = None
        self._heartbeat_s = float(heartbeat_s)
        # written only by the loop thread, read lock-free by gauges: a
        # torn read of a float is impossible under the GIL
        self._lag_ewma_s = 0.0
        self._lag_max_s = 0.0
        self.callback_errors = 0
        self.last_error: str | None = None
        # write coalescing (loop-thread only): connections whose write
        # buffers grew during THIS loop pass; flushed together at the
        # end of the pass so one send() syscall carries every line the
        # pass produced.  At saturation a pass resolves ~a-recv-full of
        # requests — per-line flushing cost one ~8us syscall each on
        # this VM, the single largest per-request item
        self._flush_set: set = set()

    # -- lifecycle --

    def start(self) -> None:
        """Start the loop thread (idempotent)."""
        with self._lock:
            if self._closed:
                raise LoopClosedError("event loop already stopped")
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run_loop, name=self.name, daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        """Stop the loop and join its thread.  Pending timers are
        dropped, but callbacks ``call_soon_threadsafe`` already
        accepted still run one final time before the thread exits;
        registered sockets are left for their owners to close."""
        with self._lock:
            if self._closed:
                thread = self._thread
            else:
                self._closed = True
                thread = self._thread
        self._wakeup()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=10.0)

    def in_loop(self) -> bool:
        return threading.get_ident() == self._tid

    def lag_ms(self) -> float:
        """Smoothed event-loop lag: how late the heartbeat timer fires.
        A healthy loop sits near 0; a blocked loop grows without
        bound."""
        return round(self._lag_ewma_s * 1000.0, 3)

    def max_lag_ms(self) -> float:
        return round(self._lag_max_s * 1000.0, 3)

    # -- submission --

    def call_soon_threadsafe(self, fn, *args) -> bool:
        """Queue ``fn(*args)`` on the loop thread; False when the loop
        is already stopped (the callback will never run)."""
        with self._lock:
            if self._closed:
                return False
            self._ready.append((fn, args))
        self._wakeup()
        return True

    def call_later(self, delay_s: float, fn, *args) -> Timer:
        """Schedule ``fn(*args)`` after ``delay_s`` seconds (monotonic).
        Returns a cancellable Timer; on a stopped loop the timer comes
        back pre-cancelled."""
        timer = Timer(time.perf_counter() + max(0.0, delay_s), fn, args)
        with self._lock:
            if self._closed:
                timer.cancelled = True
                return timer
            self._timer_seq += 1
            heapq.heappush(
                self._timers, (timer.when, self._timer_seq, timer)
            )
            if len(self._timers) > self._timer_compact_at:
                self._compact_timers_locked()
        if not self.in_loop():
            self._wakeup()
        return timer

    # the _locked suffix is the contract: the ONE caller (call_later)
    # already holds self._lock across the call — the analyzer proves
    # it (caller-holds-the-lock), no pragma needed
    def _compact_timers_locked(self) -> None:
        """Drop cancelled entries and re-heapify.  At router saturation
        every request arms (and instantly cancels) a timeout timer, so
        without this the heap carries tens of thousands of dead entries
        per timeout window.  The watermark doubles when live entries
        alone exceed it, keeping the rebuild amortized O(1) per push."""
        live = [t for t in self._timers if not t[2].cancelled]
        if len(live) > self._timer_compact_at // 2:
            self._timer_compact_at = max(
                self._timer_compact_at * 2, len(live) * 2
            )
        heapq.heapify(live)
        self._timers = live

    def run_sync(self, fn, *args, timeout: float = 10.0):
        """Run ``fn(*args)`` ON the loop thread and return its result —
        the cross-thread read/mutate primitive for loop-owned state.
        On a loop that was never started there is no loop thread to
        race (or to ever drain the queue): ``fn`` runs inline instead
        of stalling out the cross-thread timeout."""
        if self.in_loop():
            return fn(*args)
        with self._lock:
            never_started = self._thread is None and not self._closed
        if never_started:
            return fn(*args)
        done = threading.Event()
        box: dict = {}

        def _invoke() -> None:
            try:
                box["out"] = fn(*args)
            except Exception as exc:  # noqa: BLE001 — relayed to the caller
                box["exc"] = exc
            finally:
                done.set()

        if not self.call_soon_threadsafe(_invoke):
            raise LoopClosedError("event loop stopped")
        if not done.wait(timeout):
            raise TimeoutError(f"loop did not run {fn!r} in {timeout}s")
        if "exc" in box:
            raise box["exc"]
        return box.get("out")

    # -- fd registration (loop thread only) --

    def request_flush(self, conn) -> None:
        """Queue ``conn._flush_writes`` for the end of the current loop
        pass (loop thread only) — the write-coalescing hook LineConn
        rides instead of flushing per line."""
        self._flush_set.add(conn)

    def register(self, sock, events: int, callback) -> None:
        self._sel.register(sock, events, callback)

    def modify(self, sock, events: int, callback) -> None:
        self._sel.modify(sock, events, callback)

    def unregister(self, sock) -> None:
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass

    # -- internals --

    def _wakeup(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass  # pipe full == a wakeup is already pending

    def _on_wake(self, _mask: int) -> None:
        try:
            # non-blocking drain of the self-pipe; EAGAIN ends the read
            # analysis: disable=blocking-call
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _beat(self) -> None:
        """The heartbeat: reschedules itself and measures how late the
        loop ran it — the lag gauge's sample."""
        self.call_later(self._heartbeat_s, self._beat)

    def _run_loop(self) -> None:
        self._tid = threading.get_ident()
        self._beat()
        final_ready: deque = deque()
        while True:
            with self._lock:
                if self._closed:
                    # callbacks accepted before the close landed
                    # (call_soon_threadsafe returned True under this
                    # same lock — a PROMISE the callback runs): execute
                    # them below instead of stranding their waiters
                    final_ready, self._ready = self._ready, deque()
                    break
                timeout = self._heartbeat_s
                if self._timers:
                    timeout = min(
                        timeout,
                        max(0.0, self._timers[0][0] - time.perf_counter()),
                    )
                if self._ready:
                    timeout = 0.0
            for key, mask in self._sel.select(timeout):
                self._safe(key.data, mask)
            now = time.perf_counter()
            due = []
            with self._lock:
                while self._timers and self._timers[0][0] <= now:
                    _, _, timer = heapq.heappop(self._timers)
                    if not timer.cancelled:
                        due.append(timer)
                ready, self._ready = self._ready, deque()
            for timer in due:
                lag = now - timer.when
                self._lag_ewma_s = 0.8 * self._lag_ewma_s + 0.2 * lag
                self._lag_max_s = max(self._lag_max_s * 0.999, lag)
                self._safe(timer.fn, *timer.args)
            for fn, args in ready:
                self._safe(fn, *args)
            # the coalesced-write pass: every line this pass queued
            # goes out now, one send() per connection
            while self._flush_set:
                flush, self._flush_set = self._flush_set, set()
                for conn in flush:
                    self._safe(conn._flush_writes)
        for fn, args in final_ready:
            self._safe(fn, *args)
        # the callbacks above may have queued coalesced writes (a
        # response row filled in the close race): flush them or the
        # row dies in a buffer the loop never drains again
        while self._flush_set:
            flush, self._flush_set = self._flush_set, set()
            for conn in flush:
                self._safe(conn._flush_writes)
        try:
            self._sel.unregister(self._wake_r)
        except (KeyError, ValueError):
            pass
        self._wake_r.close()
        self._wake_w.close()
        self._sel.close()

    def _safe(self, fn, *args) -> None:
        try:
            fn(*args)
        except Exception as exc:  # noqa: BLE001 — one callback must not kill the loop
            self.callback_errors += 1
            self.last_error = f"{type(exc).__name__}: {exc}"


def drop_line(_line: str) -> None:
    """No-op ``on_line`` placeholder for a LineConn whose real handler
    is bound right after construction (sessions rebind ``conn.on_line``
    once they exist)."""


def drop_close(_reason) -> None:
    """No-op ``on_close`` twin of :func:`drop_line`."""


class LineConn:
    """One non-blocking JSONL stream connection on an event loop.

    ``on_line(text)`` fires per complete line, ``on_close(reason)``
    exactly once when the connection dies (reason None == clean EOF).
    ``write_line`` is thread-safe; all other mutation is loop-thread
    only.  Construction registers the socket — construct on the loop
    thread."""

    def __init__(
        self,
        loop: EventLoop,
        sock: socket.socket,
        *,
        on_line,
        on_close,
        max_line_bytes: int = 4 << 20,
        max_write_bytes: int = 32 << 20,
    ):
        self._loop = loop
        self._sock = sock
        sock.setblocking(False)
        self.on_line = on_line
        self.on_close = on_close
        self.max_line_bytes = int(max_line_bytes)
        self.max_write_bytes = int(max_write_bytes)
        self._rbuf = bytearray()
        # mixed framing (the HTTP edge): while a blob is expected the
        # next N inbound bytes are raw payload delivered via
        # ``on_blob``, not lines — see expect_blob()
        self.on_blob = None
        self._blob_remaining = 0
        self._blob_buf = bytearray()
        self._wbuf: deque[memoryview] = deque()
        self._wbytes = 0
        self._events = selectors.EVENT_READ
        self._closed = False
        self._draining = False  # close once the write buffer empties
        self._paused = False
        # when the CURRENT partial (newline-less) inbound line began:
        # the slowloris tell the server sweep reaps on
        self.partial_since: float | None = None
        loop.register(sock, self._events, self._on_io)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- writing (any thread) --

    def write_line(self, text: str) -> None:
        """Queue one response line.  Raises OSError once the connection
        is closed — the session contract ("peer went away") callers
        already handle."""
        if self._closed:
            raise OSError("connection closed")
        data = text.encode("utf-8") + b"\n"
        if self._loop.in_loop():
            self._write_bytes(data)
        elif not self._loop.call_soon_threadsafe(self._write_bytes, data):
            raise OSError("event loop stopped")

    def write_line_on_loop(self, text: str) -> None:
        """``write_line`` for callers already ON the loop thread (the
        router's per-request paths): skips the cross-thread dispatch
        check, which is measurable at saturation.  Same closed-
        connection OSError contract."""
        if self._closed:
            raise OSError("connection closed")
        self._write_bytes(text.encode("utf-8") + b"\n")

    def write_bytes_on_loop(self, data: bytes) -> None:
        """Queue raw bytes (no newline framing) — the HTTP edge's
        response writer; loop thread only.  Same coalesced-flush and
        closed-connection contracts as ``write_line_on_loop``."""
        if self._closed:
            raise OSError("connection closed")
        self._write_bytes(bytes(data))

    def _write_bytes(self, data: bytes) -> None:
        if self._closed:
            return
        self._wbuf.append(memoryview(data))
        self._wbytes += len(data)
        # flush COALESCED at the end of this loop pass (request_flush),
        # not per line: one send() syscall then carries every response
        # the pass produced — per-line flushing was the largest single
        # per-request cost at saturation
        self._loop.request_flush(self)
        if self._wbytes > self.max_write_bytes and not self._closed:
            # a reader this slow is withholding acknowledgement of
            # megabytes of answers: drop it rather than grow forever
            self.close(f"write buffer over {self.max_write_bytes} bytes "
                       "(slow reader)")

    def _flush_writes(self) -> None:
        if self._closed:
            return  # closed between queueing and the coalesced flush
        while self._wbuf:
            try:
                if len(self._wbuf) == 1:
                    sent = self._sock.send(self._wbuf[0])
                else:
                    # vectored write: every coalesced line in ONE
                    # syscall (bounded by IOV_MAX; 512 is safely under
                    # any platform's limit)
                    sent = self._sock.sendmsg(
                        list(islice(self._wbuf, 512))
                    )
            except (BlockingIOError, InterruptedError):
                break
            except OSError as exc:
                self.close(f"send failed: {exc}")
                return
            self._wbytes -= sent
            partial = False
            while sent:
                view = self._wbuf[0]
                if sent >= len(view):
                    sent -= len(view)
                    self._wbuf.popleft()
                else:
                    self._wbuf[0] = view[sent:]
                    partial = True
                    break
            if partial or self._wbuf and sent == 0:
                break  # kernel buffer full: EVENT_WRITE drives the rest
        want = selectors.EVENT_READ if not self._paused else 0
        if self._wbuf:
            want |= selectors.EVENT_WRITE
        elif self._draining:
            self.close(None)
            return
        self._set_events(want)

    # -- reading (loop thread) --

    def _on_io(self, mask: int) -> None:
        if mask & selectors.EVENT_WRITE and not self._closed:
            self._flush_writes()
        if mask & selectors.EVENT_READ and not self._closed:
            self._on_readable()

    def _on_readable(self) -> None:
        # bounded per pass so one firehose peer cannot starve the rest
        for _ in range(8):
            try:
                # non-blocking socket: EAGAIN ends the pass, it never
                # parks the loop thread
                # analysis: disable=blocking-call
                chunk = self._sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as exc:
                self.close(f"recv failed: {exc}")
                return
            if not chunk:
                if self._rbuf:
                    # half-close mid-line: the peer will never finish
                    # this request — reap it
                    self.close("EOF mid-line")
                else:
                    self.close(None)
                return
            self._rbuf += chunk
            self._split_lines()
            if self._closed or self._paused:
                return
            if len(chunk) < 65536:
                return

    def _split_lines(self) -> None:
        if self.on_blob is not None:
            self._consume_mixed()
            return
        # one split() over the whole chunk, not a find/del/copy per
        # line: at saturation a single recv carries many pipelined
        # lines and the per-line buffer churn was measurable
        parts = self._rbuf.split(b"\n")
        if len(parts) > 1:
            self.partial_since = None
            self._rbuf = bytearray(parts[-1])
            for raw in parts[:-1]:
                if self._closed:
                    return
                self.on_line(raw.decode("utf-8", errors="replace"))
        if self._closed:
            return
        if self._rbuf:
            if self.partial_since is None:
                self.partial_since = time.perf_counter()
            if len(self._rbuf) > self.max_line_bytes:
                self.close(f"line over {self.max_line_bytes} bytes")
        else:
            self.partial_since = None

    # -- mixed line/blob framing (the HTTP edge) --

    def expect_blob(self, n: int) -> None:
        """Switch the next ``n`` inbound bytes to raw-payload framing:
        once they arrive, ``on_blob(bytes)`` fires with the whole blob
        and line framing resumes.  Loop thread only; requires an
        ``on_blob`` handler and ``n > 0`` (a zero-length body needs no
        read — handle it inline)."""
        if self.on_blob is None:
            raise RuntimeError("expect_blob needs an on_blob handler")
        if n <= 0:
            raise ValueError(f"expect_blob wants n > 0, got {n!r}")
        self._blob_remaining = int(n)

    def _consume_mixed(self) -> None:
        """Frame-at-a-time parse for connections whose handler may
        switch between line and blob framing per callback (an HTTP
        request line / header lines, then a Content-Length body).  The
        per-frame ``find`` costs more than the batch split, but header
        volume is a handful of short lines per request — the JSONL hot
        path never comes through here."""
        progress = False
        while not self._closed:
            if self._blob_remaining:
                take = min(self._blob_remaining, len(self._rbuf))
                if take:
                    self._blob_buf += self._rbuf[:take]
                    del self._rbuf[:take]
                    self._blob_remaining -= take
                if self._blob_remaining:
                    break  # mid-body: the stall stamp below covers it
                blob = bytes(self._blob_buf)
                self._blob_buf.clear()
                progress = True
                self.on_blob(blob)
                continue
            idx = self._rbuf.find(b"\n")
            if idx < 0:
                break
            raw = bytes(self._rbuf[:idx])
            del self._rbuf[: idx + 1]
            progress = True
            self.on_line(raw.decode("utf-8", errors="replace"))
        if self._closed:
            return
        if self._rbuf or self._blob_remaining:
            # mid-line OR mid-body counts as a partial request: the
            # slowloris sweep reaps a dribbled body exactly like a
            # dribbled line
            if progress or self.partial_since is None:
                self.partial_since = time.perf_counter()
            if len(self._rbuf) > self.max_line_bytes:
                self.close(f"line over {self.max_line_bytes} bytes")
        else:
            self.partial_since = None

    # -- flow control (loop thread; *_soon variants are thread-safe) --

    def pause_reading(self) -> None:
        if not self._closed and not self._paused:
            self._paused = True
            self._set_events(
                selectors.EVENT_WRITE if self._wbuf else 0
            )

    def resume_reading(self) -> None:
        if not self._closed and self._paused:
            self._paused = False
            if self._rbuf:
                # the peer could not finish its line while WE weren't
                # reading: restart the stall clock from here, not from
                # whenever the partial bytes first arrived
                self.partial_since = time.perf_counter()
            self._set_events(
                selectors.EVENT_READ
                | (selectors.EVENT_WRITE if self._wbuf else 0)
            )

    def resume_reading_soon(self) -> None:
        self._loop.call_soon_threadsafe(self.resume_reading)

    def _set_events(self, events: int) -> None:
        if self._closed or events == self._events:
            return
        if events:
            if self._events:
                self._loop.modify(self._sock, events, self._on_io)
            else:
                self._loop.register(self._sock, events, self._on_io)
        elif self._events:
            self._loop.unregister(self._sock)
        self._events = events

    # -- teardown --

    def close(self, reason: str | None = None) -> None:
        """Close now (loop thread).  Fires ``on_close(reason)`` once."""
        if self._closed:
            return
        self._closed = True
        if self._events:
            self._loop.unregister(self._sock)
        try:
            self._sock.close()
        except OSError:
            pass
        self._wbuf.clear()
        self._wbytes = 0
        cb, self.on_close = self.on_close, None
        if cb is not None:
            cb(reason)

    def close_soon(self, reason: str | None = None) -> None:
        self._loop.call_soon_threadsafe(self.close, reason)

    def close_when_drained(self, timeout_s: float = 10.0) -> None:
        """Close after the write buffer flushes (clean session end —
        the responses already queued still reach the peer); forced
        after ``timeout_s``."""

        def _arm() -> None:
            if self._closed:
                return
            if not self._wbuf:
                self.close(None)
                return
            self._draining = True
            self._loop.call_later(timeout_s, self.close,
                                  "drain timeout at session end")

        self._loop.call_soon_threadsafe(_arm)


def _connect_stream(loop: EventLoop, family: int, address,
                    label: str, timeout_s: float, on_connect, on_error):
    """The shared non-blocking connect state machine behind
    :func:`connect_unix` and :func:`connect_tcp`.

    Exactly one of ``on_connect(sock)`` (a connected non-blocking
    socket, ownership transferred) or ``on_error(exc)`` fires, on the
    loop thread.  Returns an ``abort()`` callable that cancels a
    still-pending connect (firing ``on_error``); aborting a completed
    connect is a no-op.  Loop-thread only — the router's backend pools
    dial through here so a full listen backlog can never park the
    loop the way a blocking ``connect()`` would."""
    done = [False]
    pending: dict = {"sock": None, "retry": None, "deadline": None}

    def finish(exc: Exception | None) -> None:
        if done[0]:
            return
        done[0] = True
        for key in ("retry", "deadline"):
            if pending[key] is not None:
                pending[key].cancel()
                pending[key] = None
        sock = pending["sock"]
        if sock is not None:
            loop.unregister(sock)
        if exc is None:
            on_connect(sock)
        else:
            if sock is not None:
                sock.close()
            on_error(exc)

    def attempt() -> None:
        if done[0]:
            return
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.setblocking(False)
        if family == socket.AF_INET:
            # request/response JSONL dies under Nagle + delayed ACK:
            # every pooled/probe/backend dial disables it up front
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # connect_ex is the NON-blocking dial: it reports EINPROGRESS/
        # EAGAIN instead of parking the thread
        err = sock.connect_ex(address)
        if err == 0:
            pending["sock"] = sock
            finish(None)
            return
        if err == errno.EAGAIN:
            # EAGAIN is NOT "in progress": on AF_UNIX the listener's
            # backlog is full, on AF_INET the ephemeral port range is
            # momentarily exhausted — either way this connect never
            # STARTED (the fd would report writable with SO_ERROR 0
            # while unconnected).  There is nothing to wait on; retry
            # until the deadline.  ECONNREFUSED is the opposite signal
            # — a provably dead host — and fails over immediately via
            # the error path below.
            sock.close()
            pending["retry"] = loop.call_later(0.02, attempt)
            return
        if err != errno.EINPROGRESS:
            sock.close()
            finish(
                OSError(err, f"connect {label!r}: {os.strerror(err)}")
            )
            return
        pending["sock"] = sock

        def on_writable(_mask: int) -> None:
            code = sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            finish(
                None if code == 0 else
                OSError(code, f"connect {label!r}: {os.strerror(code)}")
            )

        loop.register(sock, selectors.EVENT_WRITE, on_writable)

    pending["deadline"] = loop.call_later(
        timeout_s, finish, TimeoutError(f"connect {label!r} timed out")
    )
    attempt()

    def abort() -> None:
        finish(OSError(f"connect {label!r} aborted"))

    return abort


def connect_unix(loop: EventLoop, path: str, timeout_s: float,
                 on_connect, on_error):
    """Non-blocking Unix-socket connect on the loop thread (see
    :func:`_connect_stream` for the callback/abort contract)."""
    return _connect_stream(
        loop, socket.AF_UNIX, path, path, timeout_s, on_connect, on_error
    )


def connect_tcp(loop: EventLoop, host: str, port: int, timeout_s: float,
                on_connect, on_error):
    """Non-blocking TCP connect on the loop thread: same contract as
    :func:`connect_unix`, with TCP_NODELAY set before the dial.  Hosts
    should be numeric (or otherwise resolver-free): ``connect_ex`` on a
    name that needs DNS would do the lookup synchronously on the loop
    thread."""
    return _connect_stream(
        loop, socket.AF_INET, (host, int(port)), f"{host}:{port}",
        timeout_s, on_connect, on_error,
    )


def connect_target(loop: EventLoop, target: str, timeout_s: float,
                   on_connect, on_error):
    """Dial a :func:`parse_target` target — the one connect entry the
    router's pools and probes use, so every fleet edge speaks AF_UNIX
    or AF_INET by target spelling alone."""
    kind, addr = parse_target(target)
    if kind == "tcp":
        host, port = addr
        return connect_tcp(loop, host, port, timeout_s,
                           on_connect, on_error)
    return connect_unix(loop, target, timeout_s, on_connect, on_error)


class SocketInUseError(OSError):
    """The Unix socket path is owned by a LIVE server (a connect
    succeeded), or by something that is not a socket at all — binding
    over it would hijack a running worker or destroy a user's file."""


def prepare_unix_socket_path(path: str) -> None:
    """Make ``path`` bindable: unlink a STALE socket file (the leftover
    of a SIGKILLed worker — bind would otherwise fail with EADDRINUSE
    forever), but refuse to touch a live server's socket or a
    non-socket file.  Liveness is probed by connecting: a dead owner's
    socket refuses (ECONNREFUSED), a live one accepts."""
    try:
        st = os.lstat(path)
    except OSError:
        return  # nothing there: bind will create it
    if not stat.S_ISSOCK(st.st_mode):
        raise SocketInUseError(
            f"{path!r} exists and is not a socket; refusing to unlink"
        )
    probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        probe.settimeout(1.0)
        probe.connect(path)
    except socket.timeout:
        # a listener that is merely SLOW to accept (wedged worker with
        # a full backlog) is still an owner — hijacking it on a probe
        # timeout would be exactly the theft this function prevents
        raise SocketInUseError(
            f"{path!r}: liveness probe timed out (a wedged owner?); "
            "refusing to unlink"
        ) from None
    except OSError as exc:
        if exc.errno == errno.ENOENT:
            return  # unlinked between lstat and connect: bindable now
        if exc.errno not in (errno.ECONNREFUSED, errno.ECONNRESET):
            # EACCES and friends: we cannot PROVE the owner is dead,
            # so the conservative answer is refusal, not unlink
            raise SocketInUseError(
                f"{path!r}: liveness probe failed ({exc}); "
                "refusing to unlink"
            ) from exc
        # ECONNREFUSED/ECONNRESET: provably no accepting owner — the
        # leftover of a SIGKILLed worker.  Reclaim the path.
        try:
            os.unlink(path)
        except OSError:
            pass
    else:
        raise SocketInUseError(
            f"{path!r} is owned by a live server; refusing to unlink"
        )
    finally:
        probe.close()


class LoopJsonlServer:
    """A listening socket whose accepts, reads, and writes all run on
    an event loop.  Subclasses implement ``handle_connection(sock)``
    to wrap each accepted socket (typically in a LineConn).

    ``path`` is a :func:`parse_target` target: a filesystem path binds
    an AF_UNIX listener (with the stale-socket reclaim), a
    ``host:port`` string binds AF_INET (SO_REUSEADDR; port 0 picks an
    ephemeral port, reported as ``bound_port``) — the network edge and
    the cross-host fleet tier ride the same server class.

    The facade mirrors ``socketserver`` so existing callers and tests
    drive it unchanged: ``serve_forever(poll_interval=...)`` blocks
    until ``shutdown()``; ``server_close()`` tears everything down.
    With ``loop=None`` the server owns (and stops) its own loop;
    passing a loop shares one — the fleet front server rides the
    router's."""

    def __init__(
        self,
        path: str,
        *,
        loop: EventLoop | None = None,
        stall_timeout_s: float = 30.0,
    ):
        self.kind, addr = parse_target(path)
        if self.kind == "unix":
            prepare_unix_socket_path(path)
            self._listener = socket.socket(
                socket.AF_UNIX, socket.SOCK_STREAM
            )
        else:
            self._listener = socket.socket(
                socket.AF_INET, socket.SOCK_STREAM
            )
            self._listener.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
            )
        self.path = path
        self.stall_timeout_s = float(stall_timeout_s)
        self._own_loop = loop is None
        self.loop = EventLoop(name="jsonl-server") if loop is None else loop
        try:
            self._listener.setblocking(False)
            self._listener.bind(addr if self.kind == "tcp" else path)
            self._listener.listen(128)
        except OSError:
            self._listener.close()
            raise
        # the concrete TCP port (host:0 binds ephemeral — selftests and
        # benches lease ports this way without a bind race)
        self.bound_port = (
            self._listener.getsockname()[1] if self.kind == "tcp" else None
        )
        if self._own_loop:
            self.loop.start()
        self._conns: set[LineConn] = set()  # loop-thread only
        self._accepting = False
        self._sweep_timer: Timer | None = None
        self._started = threading.Event()
        self._shutdown_req = threading.Event()
        self._stopped = threading.Event()
        self._closed = False

    # -- socketserver-compatible facade --

    def serve_forever(self, poll_interval: float | None = None) -> None:
        """Accept connections until ``shutdown()``.  ``poll_interval``
        is accepted for socketserver compatibility; the loop wakes on
        events, not polls."""
        del poll_interval
        self.loop.run_sync(self._start_serving)
        self._started.set()
        try:
            self._shutdown_req.wait()
        finally:
            try:
                self.loop.run_sync(self._stop_serving)
            except (LoopClosedError, TimeoutError):
                pass
            self._stopped.set()

    def shutdown(self) -> None:
        self._shutdown_req.set()
        if self._started.is_set():
            self._stopped.wait(timeout=10.0)

    def server_close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._shutdown_req.set()
        try:
            self.loop.run_sync(self._close_all)
        except (LoopClosedError, TimeoutError):
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._own_loop:
            self.loop.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.server_close()

    # -- loop-side machinery --

    def _start_serving(self) -> None:
        if self._accepting or self._closed:
            return
        self.loop.register(
            self._listener, selectors.EVENT_READ, self._on_accept
        )
        self._accepting = True
        self._arm_sweep()

    def _stop_serving(self) -> None:
        if self._accepting:
            self.loop.unregister(self._listener)
            self._accepting = False

    def _close_all(self) -> None:
        self._stop_serving()
        if self._sweep_timer is not None:
            self._sweep_timer.cancel()
            self._sweep_timer = None
        for conn in list(self._conns):
            conn.close("server shutdown")
        self._conns.clear()

    def _on_accept(self, _mask: int) -> None:
        while True:
            try:
                # non-blocking listener: EAGAIN ends the accept pass
                # analysis: disable=blocking-call
                sock, _addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if self.kind == "tcp":
                try:
                    sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                except OSError:
                    pass  # already closing: the LineConn will notice
            self.handle_connection(sock)

    def track_connection(self, conn: LineConn) -> None:
        """Subclass helper: make ``conn`` visible to the stall sweep
        and the shutdown teardown."""
        self._conns.add(conn)

    def forget_connection(self, conn: LineConn) -> None:
        self._conns.discard(conn)

    def connection_count(self) -> int:
        return len(self._conns)

    def _arm_sweep(self) -> None:
        if self._closed:
            return
        interval = max(0.05, min(self.stall_timeout_s / 4.0, 5.0))
        self._sweep_timer = self.loop.call_later(interval, self._sweep)

    def _sweep(self) -> None:
        """Reap slowloris connections: a peer mid-line for longer than
        ``stall_timeout_s`` is never going to finish its request."""
        now = time.perf_counter()
        for conn in list(self._conns):
            if conn._paused:
                # the SERVER paused this read (flow control on a
                # heavily pipelining client) — the peer is not
                # stalling, we are; resume_reading restarts the clock
                continue
            since = conn.partial_since
            if since is not None and now - since > self.stall_timeout_s:
                conn.close(
                    f"partial line stalled > {self.stall_timeout_s}s "
                    "(slowloris)"
                )
        self._arm_sweep()

    def handle_connection(self, sock: socket.socket) -> None:
        raise NotImplementedError
