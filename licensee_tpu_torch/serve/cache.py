"""Content-hash LRU result cache for the serving path.

Real-world license traffic is overwhelmingly duplicate blobs (bench r05:
dup-heavy streams classify ~8x faster end-to-end than unique ones purely
from dedupe), so the serving front end answers repeats from this cache
without touching featurization or the device.  Keys are the SAME
(dispatch, content-sha1) tuples the offline dedupe cache uses
(serve/featurize.py content_key), so a hit is exact — classification is
a pure function of content + dispatch — never approximate.

LRU, not FIFO like the offline cache: a server runs for weeks and its
working set drifts (trending repos change), so recency matters; the
offline pipeline's one-pass manifest scan has no such drift.  Stored
results are frozen copies (tuple ``closest``) exactly like the offline
cache — a cached object is handed out many times and must never be
mutated by a later annotation pass.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import replace


def result_bytes(key, result) -> int:
    """Approximate resident bytes of one cache entry: the key tuple
    (dispatch + 20-byte sha1), the BlobResult's strings, and the
    ``closest`` tuples, plus a fixed per-entry overhead for the dict
    slot and object headers.  An estimate, not a census — the bound
    exists so a week-long fleet worker's cache stays O(max_bytes), and
    a consistent estimate bounds exactly as well as a perfect one."""
    n = 160  # OrderedDict slot + BlobResult header + key tuple overhead
    for part in (result.key, result.matcher, result.attribution):
        if part is not None:
            n += 56 + len(part)
    if result.closest is not None:
        n += 56
        for k, _conf in result.closest:
            n += 120 + len(k or "")  # (str, float) tuple
    return n


class ResultCache:
    """Thread-safe LRU of content-key -> BlobResult with hit/miss/
    eviction counters.

    Two independent bounds, either of which evicts LRU-first:
    ``capacity`` (entry count, as always) and optional ``max_bytes``
    (estimated resident bytes via :func:`result_bytes`) — entry count
    alone lets 65536 fat ``closest``-annotated results grow a fleet
    worker without bound, while the byte bound holds memory flat no
    matter the per-entry shape."""

    def __init__(self, capacity: int = 65536, max_bytes: int | None = None):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity!r}")
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes!r}")
        self.capacity = int(capacity)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self._data: OrderedDict = OrderedDict()
        self._sizes: dict = {}  # key -> result_bytes at insert time
        self._lock = threading.Lock()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, record_miss: bool = True):
        """``record_miss=False`` marks a RE-probe (the scheduler checks
        again under its lock to close the put/unregister race): a hit
        still counts, but the initial probe already recorded the miss."""
        with self._lock:
            result = self._data.get(key)
            if result is None:
                if record_miss:
                    self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return result

    def put(self, key, result) -> None:
        """Insert a CLEAN result (the callers never cache error rows —
        same policy as the offline dedupe cache)."""
        if self.capacity == 0:
            return
        frozen = replace(
            result,
            closest=(
                tuple(result.closest)
                if result.closest is not None
                else None
            ),
        )
        size = result_bytes(key, frozen)
        if self.max_bytes is not None and size > self.max_bytes:
            return  # one oversized entry must not wipe the whole cache
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.bytes -= self._sizes[key]
            self._data[key] = frozen
            self._sizes[key] = size
            self.bytes += size
            while len(self._data) > self.capacity or (
                self.max_bytes is not None and self.bytes > self.max_bytes
            ):
                old_key, _ = self._data.popitem(last=False)
                self.bytes -= self._sizes.pop(old_key)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> dict:
        with self._lock:
            hits, misses = self.hits, self.misses
            return {
                "entries": len(self._data),
                "capacity": self.capacity,
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": hits,
                "misses": misses,
                "evictions": self.evictions,
                "hit_rate": (
                    round(hits / (hits + misses), 4)
                    if hits + misses
                    else None
                ),
            }

    def register_metrics(self, registry) -> None:
        """Publish this cache into an obs MetricsRegistry: occupancy
        gauges pull live, hit/miss/eviction counters sync per scrape.
        The cache owns its metric names — every consumer (the serve
        scheduler today, an HTTP front end tomorrow) exports the same
        series."""
        registry.gauge(
            "serve_cache_entries", "Result-cache entries resident"
        ).set_fn(lambda: len(self))
        registry.gauge(
            "serve_cache_capacity", "Result-cache capacity"
        ).set(self.capacity)
        registry.gauge(
            "serve_cache_bytes",
            "Estimated resident bytes of cached results",
        ).set_fn(lambda: self.bytes)
        events = registry.counter(
            "serve_cache_events_total",
            "Result-cache hits / misses / evictions",
            labels=("event",),
        )

        def collect(_reg) -> None:
            snap = self.stats()
            for kind in ("hits", "misses", "evictions"):
                events.labels(event=kind).sync(snap[kind])

        registry.add_collector(collect)
