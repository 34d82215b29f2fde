"""Bounded-memory latency tracking for the serving path.

A long-running worker cannot keep every sample, so each stage records
into a fixed-size reservoir ring (most-recent N samples) plus lifetime
count/total; percentiles are computed on demand over the ring.  With
capacity 4096 the p99 of the recent window is exact, and memory stays
constant over a week of traffic.

House rule (enforced by script/lint): serve/ latency math uses the
monotonic ``time.perf_counter``, never the wall clock ``time.time`` —
an NTP step must not produce a negative p50.
"""

from __future__ import annotations

import math
import threading


class LatencyStats:
    """One stage's latency reservoir: thread-safe record + snapshot."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity!r}")
        self.capacity = int(capacity)
        self._ring: list[float] = []
        self._idx = 0
        self._count = 0
        self._total = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._total += seconds
            if len(self._ring) < self.capacity:
                self._ring.append(seconds)
            else:
                # overwrite the OLDEST sample: during the append phase
                # _idx stayed 0 (the oldest), and each overwrite
                # advances it — so a wrapped ring is always the most
                # recent `capacity` samples, capacity=1 included
                self._ring[self._idx] = seconds
                self._idx = (self._idx + 1) % self.capacity

    @staticmethod
    def _percentile(ordered: list[float], q: float) -> float:
        """Nearest-rank percentile over an ascending-sorted sample."""
        rank = max(1, math.ceil(q * len(ordered)))
        return ordered[rank - 1]

    def snapshot(self) -> dict:
        """{count, mean_ms, p50_ms, p95_ms, p99_ms, max_ms} — the
        percentiles over the recent reservoir window, the count/mean
        over the process lifetime."""
        with self._lock:
            # COPY under the lock, sort outside it: an O(n log n) sort
            # of a 4096-ring inside the lock would stall every
            # concurrent record() on the serving hot path for the
            # duration of a stats scrape
            window = list(self._ring)
            count, total = self._count, self._total
        window.sort()
        if not window:
            return {
                "count": 0, "mean_ms": None, "p50_ms": None,
                "p95_ms": None, "p99_ms": None, "max_ms": None,
            }

        def ms(seconds: float) -> float:
            return round(seconds * 1000.0, 3)

        return {
            "count": count,
            "mean_ms": ms(total / count),
            "p50_ms": ms(self._percentile(window, 0.50)),
            "p95_ms": ms(self._percentile(window, 0.95)),
            "p99_ms": ms(self._percentile(window, 0.99)),
            "max_ms": ms(window[-1]),
        }


class StageStats:
    """A named family of LatencyStats — one per pipeline stage — that
    snapshots into a single JSON-ready dict.

    ``observer(stage, seconds, exemplar)``, when given, is called on
    every record — the obs registry tees each sample into its
    fixed-bound histograms without a second timing site (one reservoir,
    one histogram, one clock read).  ``exemplar`` is the recording
    request's trace ID (or None): the histogram keeps it as the
    OpenMetrics exemplar for the bucket the sample lands in."""

    def __init__(
        self, stages: tuple[str, ...], capacity: int = 4096, observer=None
    ):
        self._stages = {s: LatencyStats(capacity) for s in stages}
        self._observer = observer

    def record(
        self, stage: str, seconds: float, exemplar: str | None = None
    ) -> None:
        self._stages[stage].record(seconds)
        if self._observer is not None:
            self._observer(stage, seconds, exemplar)

    def snapshot(self) -> dict:
        return {s: ls.snapshot() for s, ls in self._stages.items()}
