"""Request tracing: Dapper-style trace IDs, per-stage spans, head
sampling, and always-captured slow-request exemplars.

A trace is minted at admission (``MicroBatcher.submit``; per produced
chunk in ``BatchProject``) and its ID rides the request to the response
row, so one slow request can be followed through
admission -> cache probe -> featurize -> queue -> device -> respond.

Cross-process propagation: ``Tracer.start(trace_id=...)`` ADOPTS a
caller-supplied ID instead of minting one.  The fleet router
(fleet/router.py) mints the ID, records its own ``route`` / ``hedge`` /
``failover`` spans under it, and forwards it on the wire (the request's
``"trace"`` field); the worker's MicroBatcher adopts it, so the SAME
16-hex ID shows up in both processes' ``{"op":"trace"}`` tails — the
router tail holds the routing story, the worker tail the serving story,
joined by the ID.

Retention is two-tier, after Dapper's aggressive-head-sampling lesson:

* **head sampling** — every Nth trace (deterministic, not random: a
  fixed stride costs one integer compare per request and makes tests
  reproducible) is retained in full;
* **slow exemplars** — a request whose total latency crosses
  ``slow_ms`` is ALWAYS retained, sampled or not, because the traces
  you need are precisely the ones head sampling statistically misses.
  Exemplars append to a bounded JSONL log when ``log_path`` is set
  (single rotation at ``log_max_bytes`` — disk held under 2x the cap).

Span bookkeeping is a few list appends per request against a
multi-hundred-us request floor, so tracing stays on at default
sampling; the serve p50 budget (<1% vs the untraced baseline) is held
by keeping the per-request work O(spans) with no locks off the retain
path.

House rules (script/lint): monotonic clocks only (span math must
survive an NTP step), and no print — the exemplar log is an explicit
stream.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque


class Trace:
    """One request's spans.  Span offsets are seconds relative to the
    trace start (monotonic clock), rendered as ms in ``as_dict``."""

    __slots__ = (
        "trace_id", "request_id", "t_start", "sampled", "spans",
        "status", "dur_s", "kind",
    )

    def __init__(self, trace_id, request_id, t_start, sampled):
        self.trace_id = trace_id
        self.request_id = request_id
        self.t_start = t_start
        self.sampled = sampled
        self.spans: list[tuple] = []  # (name, offset_s, dur_s, note)
        self.status = "ok"
        self.dur_s = None
        # "trace" = a full span-carrying trace; "slow" = a span-less
        # slow exemplar handed in via note_slow (the mint-only path) —
        # tagged so the fleet collector (obs/collect.py) joins tails
        # without heuristics
        self.kind = "trace"

    def add_span(
        self,
        name: str,
        dur_s: float,
        t0: float | None = None,
        note: str | None = None,
    ) -> None:
        """Record one span.  ``t0`` is the monotonic time the span
        began; omitted, the span is assumed to have just ended."""
        if t0 is None:
            t0 = time.perf_counter() - dur_s
        self.spans.append((name, t0 - self.t_start, dur_s, note))

    def span_names(self) -> list[str]:
        return [s[0] for s in self.spans]

    def as_dict(self) -> dict:
        row = {
            "trace": self.trace_id,
            "id": self.request_id,
            "kind": self.kind,
            "status": self.status,
            "dur_ms": (
                round(self.dur_s * 1000.0, 3)
                if self.dur_s is not None
                else None
            ),
            "spans": [
                {
                    "name": name,
                    "t_ms": round(off * 1000.0, 3),
                    "dur_ms": round(dur * 1000.0, 3),
                    **({"note": note} if note else {}),
                }
                for name, off, dur, note in self.spans
            ],
        }
        return row


class Tracer:
    """Mints trace IDs, applies retention, and keeps the recent-trace
    ring + slow-exemplar JSONL log."""

    def __init__(
        self,
        sample_rate: float = 0.01,
        slow_ms: float = 250.0,
        capacity: int = 256,
        log_path: str | None = None,
        log_max_bytes: int = 4 << 20,
        proc: str = "local",
    ):
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate!r}"
            )
        if slow_ms < 0:
            raise ValueError(f"slow_ms must be >= 0, got {slow_ms!r}")
        self.sample_rate = float(sample_rate)
        # deterministic head sampling: trace every Nth request
        self._stride = (
            0 if sample_rate == 0 else max(1, round(1.0 / sample_rate))
        )
        self.slow_ms = float(slow_ms)
        self.log_path = log_path
        self.log_max_bytes = int(log_max_bytes)
        # the tail tag that names this process's role in a fleet
        # ("router" / worker name): the collector joins tails by trace
        # ID and attributes rows by proc, no heuristics
        self.proc = proc
        self._ring: deque[Trace] = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        # the exemplar log gets its OWN lock: disk I/O (rotation +
        # append, possibly on a stalled filesystem) must never block
        # start()/finish() on the admission path, which take _lock
        self._log_lock = threading.Lock()
        self._seq = 0
        # 64-bit id space seeded from OS entropy once per tracer: ids
        # are unique per process and unguessably distinct across
        # processes, at the cost of one getrandbits per mint
        self._rand = random.Random()
        self._base = self._rand.getrandbits(64)
        self._log_bytes = 0
        self.started = 0
        self.retained = 0
        self.slow = 0

    @property
    def mint_only(self) -> bool:
        """True when head sampling is off (``sample_rate == 0``): no
        trace can be retained at start time, so a caller that only
        needs wire-correlation IDs may mint them itself and skip the
        Trace object — handing measured durations back through
        :meth:`note_slow` to keep the slow-exemplar ring honest."""
        return self._stride == 0

    def start(self, request_id=None, trace_id: str | None = None) -> Trace:
        """Mint a trace — or, with ``trace_id``, ADOPT an upstream hop's
        ID (the fleet router forwards its ID to the worker so both tails
        join on it).  Adoption changes only the ID; sampling/retention
        stay local decisions, so a worker never retains every router-
        sampled trace just because the ID arrived from outside."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            self.started += 1
        if trace_id is None:
            trace_id = f"{(self._base + seq) & 0xFFFFFFFFFFFFFFFF:016x}"
        sampled = self._stride > 0 and (seq % self._stride == 0)
        return Trace(trace_id, request_id, time.perf_counter(), sampled)

    def note_slow(
        self,
        trace_id: str,
        request_id,
        t_start: float,
        dur_s: float,
        status: str = "ok",
    ) -> bool:
        """Retain a span-less slow exemplar for a request the caller
        timed itself — the mint-only fast path (sampling off) skips
        Trace objects entirely, so the router hands the measured
        duration back here only when it crosses ``slow_ms``.  Returns
        True when retained."""
        if dur_s * 1000.0 < self.slow_ms:
            return False
        trace = Trace(trace_id, request_id, t_start, False)
        trace.status = status
        trace.dur_s = dur_s
        trace.kind = "slow"  # span-less exemplar, not a full trace
        with self._lock:
            self.retained += 1
            self.slow += 1
            self._ring.append(trace)
        if self.log_path:
            self._log_exemplar(trace)
        return True

    def finish(self, trace: Trace, status: str = "ok") -> bool:
        """Close the trace; returns True when it was retained (sampled
        head, or a slow exemplar)."""
        trace.status = status
        trace.dur_s = time.perf_counter() - trace.t_start
        is_slow = trace.dur_s * 1000.0 >= self.slow_ms
        if not (trace.sampled or is_slow):
            return False
        with self._lock:
            self.retained += 1
            if is_slow:
                self.slow += 1
            self._ring.append(trace)
        if is_slow and self.log_path:
            self._log_exemplar(trace)
        return True

    def _log_exemplar(self, trace: Trace) -> None:
        line = json.dumps({**trace.as_dict(), "slow": True}) + "\n"
        data = line.encode("utf-8")
        with self._log_lock:
            try:
                if (
                    self._log_bytes == 0
                    and os.path.exists(self.log_path)
                ):
                    self._log_bytes = os.path.getsize(self.log_path)
                if self._log_bytes + len(data) > self.log_max_bytes:
                    # single rotation: current log -> .1, start fresh —
                    # disk stays bounded at ~2x log_max_bytes
                    os.replace(self.log_path, self.log_path + ".1")
                    self._log_bytes = 0
                with open(self.log_path, "ab") as f:
                    f.write(data)
                self._log_bytes += len(data)
            except OSError:
                pass  # a full disk must never take the serving path down

    def tail(self, n: int = 20) -> list[dict]:
        """The most recent retained traces, oldest first.  Every row
        carries ``"kind"`` ("trace" = full spans, "slow" = span-less
        note_slow exemplar) and ``"proc"`` (this process's fleet role)
        so the cross-process collector joins without heuristics; the
        pre-existing key set is unchanged otherwise."""
        with self._lock:
            traces = list(self._ring)[-max(0, int(n)):]
        return [{**t.as_dict(), "proc": self.proc} for t in traces]

    def stats(self) -> dict:
        with self._lock:
            ring = len(self._ring)
        return {
            "started": self.started,
            "retained": self.retained,
            "slow": self.slow,
            "ring": ring,
            "sample_rate": self.sample_rate,
            "slow_ms": self.slow_ms,
            "log_path": self.log_path,
        }


class NullTracer:
    """Tracing disabled: mints nothing, retains nothing — submit()'s
    fast path stays branch-cheap by sharing the Tracer interface."""

    sample_rate = 0.0
    slow_ms = float("inf")
    log_path = None
    proc = "local"
    mint_only = False  # no IDs at all: wire lines go out un-spliced

    def start(self, request_id=None, trace_id=None):
        return None

    def finish(self, trace, status="ok") -> bool:
        return False

    def note_slow(self, trace_id, request_id, t_start, dur_s,
                  status="ok") -> bool:
        return False

    def tail(self, n: int = 20) -> list:
        return []

    def stats(self) -> dict:
        return {"started": 0, "retained": 0, "slow": 0, "ring": 0,
                "sample_rate": 0.0, "slow_ms": None, "log_path": None}


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer (the offline BatchProject publishes its
    per-chunk traces here; a MicroBatcher owns its own)."""
    return _default_tracer
