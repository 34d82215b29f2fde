"""The worker flight recorder: a lock-free bounded ring of recent
structured events, spilled to a per-worker black-box file so a
SIGKILLed worker's last seconds are recorded evidence, not guesswork.

The Dapper-style traces (obs/tracing.py) explain SAMPLED requests; the
flight recorder explains the PROCESS.  Every worker appends one event
per interesting transition — admission, micro-batch flush, device
dispatch/await, reload epoch swap, error rows — into a fixed-size ring
whose hot append path takes **no lock and does no I/O** (the
``event-ring-purity`` analysis rule holds it to that): one slot store
and two GIL-atomic int reads per event, cheap enough to stay on at
full serving rate.  Concurrent appends may very occasionally overwrite
one another's slot; a black box trades perfect capture for never
perturbing the thing it records.

Persistence is the background flusher's job: a daemon thread rewrites
the black-box file (atomic replace) every ``flush_interval_s`` while
events keep arriving, and ``stop()`` writes a final dump on clean
shutdown (the serve worker's SIGTERM path).  A SIGKILL therefore
leaves a dump at most one flush interval stale on disk — exactly what
the fleet supervisor harvests the instant it detects the crash
(fleet/supervisor.py attaches the last events to its restart log).

The black-box file is JSON: ``{"proc", "events": [{"seq", "t_ms",
"kind", ...fields}], "dropped", "capacity"}`` at
``<worker socket>.flight`` (``flight_path_for_socket``) — a
convention, not a flag, so the supervisor can find a dead worker's box
without any plumbing.

House rules (script/lint): monotonic clocks only, no print.
"""

from __future__ import annotations

import json
import os
import threading
import time

# how many trailing events a harvester attaches to a restart-log entry
HARVEST_TAIL = 20


def flight_path_for_socket(socket_path: str) -> str:
    """The black-box path convention shared by workers (writers) and
    the supervisor (harvester): the worker's socket path + ``.flight``.

    A worker serving a TCP target (``host:port`` — the federation
    tier) has no socket FILE to anchor the box to, so its dump lands
    in the temp dir under a sanitized target name; both sides derive
    the same path from the same target string, so the convention still
    needs no plumbing."""
    if ":" in os.path.basename(socket_path):
        import tempfile

        safe = socket_path.replace(os.path.sep, "_").replace(":", "_")
        return os.path.join(
            tempfile.gettempdir(), f"licensee-tpu-{safe}.flight"
        )
    return f"{socket_path}.flight"


class FlightRecorder:
    """Fixed-capacity event ring with a lock-free hot append and a
    background spill thread.

    ``record(kind, **fields)`` is the hot path: no locks, no I/O, no
    allocation beyond the event tuple (the ``event-ring-purity``
    analyzer rule fails CI if that ever regresses).  Everything slow —
    snapshotting, JSON, the atomic file replace — happens on the
    flusher thread or in an explicit ``dump()``."""

    def __init__(
        self,
        path: str | None = None,
        *,
        capacity: int = 512,
        proc: str = "worker",
        flush_interval_s: float = 0.25,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity!r}")
        self.path = path
        self.proc = proc
        self.flush_interval_s = float(flush_interval_s)
        self._capacity = int(capacity)
        # the ring: a plain fixed-size list of event tuples.  Slot
        # stores and the cursor bump are each GIL-atomic; the cursor is
        # read before bump so a torn concurrent append costs at most
        # one overwritten slot, never a crash or a lock.
        self._slots: list = [None] * self._capacity
        self._seq = 0
        self._t0 = time.perf_counter()
        self._dumps = 0
        # == _seq at start: the flusher only spills once an event has
        # actually been recorded, so an idle fresh incarnation never
        # recreates the black box the supervisor just consumed
        self._last_dump_seq = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- the hot append path (lock-free, I/O-free by rule) --

    def record(self, kind: str, **fields) -> None:
        """Append one event.  Safe to call from any thread at full
        serving rate; the slowest thing here is the clock read."""
        seq = self._seq
        t_ms = (time.perf_counter() - self._t0) * 1000.0
        self._slots[seq % self._capacity] = (seq, t_ms, kind, fields)
        self._seq = seq + 1

    # -- snapshot / spill (cold paths) --

    def snapshot(self) -> list[dict]:
        """The ring's current events, oldest first.  Tolerates
        concurrent appends: a slot mid-overwrite simply reads as its
        old or new event (tuple stores are atomic under the GIL)."""
        events = [e for e in list(self._slots) if e is not None]
        events.sort(key=lambda e: e[0])
        return [
            {"seq": seq, "t_ms": round(t_ms, 3), "kind": kind, **fields}
            for seq, t_ms, kind, fields in events
        ]

    def dump(self, path: str | None = None) -> str | None:
        """Write the black-box file (atomic replace).  Returns the
        path, or None when no path is configured.  A full disk must
        never take the worker down — failures are swallowed."""
        path = path or self.path
        if path is None:
            return None
        events = self.snapshot()
        box = {
            "proc": self.proc,
            "capacity": self._capacity,
            "recorded": self._seq,
            "dropped": max(0, self._seq - self._capacity),
            "events": events,
        }
        tmp = f"{path}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(box, f)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            return None
        self._dumps += 1
        self._last_dump_seq = self._seq
        return path

    # -- the background flusher --

    def start(self) -> "FlightRecorder":
        """Start the spill thread (no-op without a path, or if already
        running)."""
        if self.path is None or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._flush_loop, name="flight-recorder", daemon=True
        )
        self._thread.start()
        return self

    def _flush_loop(self) -> None:
        while not self._stop.wait(self.flush_interval_s):
            if self._seq != self._last_dump_seq:
                self.dump()

    def stop(self) -> None:
        """Stop the flusher and write the final dump — the clean-
        shutdown (SIGTERM) black box."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.dump()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- introspection --

    def stats(self) -> dict:
        return {
            "events": self._seq,
            "capacity": self._capacity,
            "dropped": max(0, self._seq - self._capacity),
            "dumps": self._dumps,
            "path": self.path,
        }

    def register_metrics(self, registry) -> None:
        """Publish the recorder's counters on a metrics registry; the
        sync runs per scrape, never on the append path."""
        events = registry.counter(
            "flight_events_total",
            "Events appended to the worker flight-recorder ring",
        )
        dumps = registry.counter(
            "flight_dumps_total",
            "Black-box dumps written by the flight recorder",
        )
        registry.add_collector(
            lambda _reg: (events.sync(self._seq), dumps.sync(self._dumps))
        )


def load_flight_dump(path: str) -> dict | None:
    """Read a black-box file; None when absent/torn (a worker killed
    before its first flush has no box — the harvester records that)."""
    try:
        with open(path, encoding="utf-8") as f:
            box = json.load(f)
    except (OSError, ValueError):
        return None
    return box if isinstance(box, dict) else None
