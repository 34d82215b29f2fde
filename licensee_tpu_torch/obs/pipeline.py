"""Per-lane occupancy clocks for the overlap pipeline.

The port's copy of `licensee_tpu/obs/pipeline.py`.  The batch run loop
(`projects/batch_project.py`) and the serve flush/completion pair
(`serve/scheduler.py`) have three lanes, featurize, device and writer,
that are meant to run concurrently; when they do, throughput at scale is
1/max(lane).  A :class:`PipelineLanes` accumulates busy-seconds per lane
(a lane is busy while >= 1 of its workers is inside it) and counts the
dispatched-but-unfinished device chunks; `occupancy()` snapshots both
for the run's stats, and `register` wires them into a metrics registry
as the gauges

* ``pipeline_featurize_busy`` / ``pipeline_device_busy`` /
  ``pipeline_writer_busy``: each lane's occupancy as a fraction of wall
  time since the clock started (1.0: the lane never idles, it is the
  bottleneck);
* ``pipeline_inflight_chunks``: the device chunks in flight right now.

Re-registering on the same registry re-points the gauges at the newest
clock.  The device lane is busy from a group's submit to its await, so
its share bounds the card's busy share from above.
"""

from __future__ import annotations

import threading
import time


LANES = ("featurize", "device", "writer")


class _Lane:
    __slots__ = ("active", "busy_s", "entered_at")

    def __init__(self):
        self.active = 0
        self.busy_s = 0.0
        self.entered_at = 0.0


class PipelineLanes:
    """Busy-time bookkeeping for the pipeline lanes of ONE run.

    ``enter``/``exit_`` bracket lane work (re-entrant across threads: a
    lane with N workers is busy while any of them is in it);
    ``inflight`` tracks dispatched device chunks.  ``occupancy()``
    snapshots {lane: busy_fraction} for stats/bench rows; ``register``
    wires the live gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lanes = {name: _Lane() for name in LANES}
        self._inflight = 0
        self._t0 = time.perf_counter()

    # -- lane brackets --

    def enter(self, lane: str) -> None:
        now = time.perf_counter()
        with self._lock:
            ln = self._lanes[lane]
            if ln.active == 0:
                ln.entered_at = now
            ln.active += 1

    def exit_(self, lane: str) -> None:
        now = time.perf_counter()
        with self._lock:
            ln = self._lanes[lane]
            ln.active -= 1
            if ln.active == 0:
                ln.busy_s += now - ln.entered_at
            elif ln.active < 0:
                raise RuntimeError(f"lane {lane!r} exited more than entered")

    class _Bracket:
        __slots__ = ("lanes", "lane")

        def __init__(self, lanes, lane):
            self.lanes = lanes
            self.lane = lane

        def __enter__(self):
            self.lanes.enter(self.lane)
            return self

        def __exit__(self, *exc):
            self.lanes.exit_(self.lane)

    def lane(self, name: str) -> "PipelineLanes._Bracket":
        """``with lanes.lane("featurize"): ...`` — the usual form."""
        return self._Bracket(self, name)

    # -- in-flight chunks --

    def chunk_inflight(self, delta: int) -> None:
        with self._lock:
            self._inflight += delta

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    # -- read side --

    def _busy_s(self, lane: str, now: float) -> float:
        ln = self._lanes[lane]
        busy = ln.busy_s
        if ln.active > 0:
            busy += now - ln.entered_at
        return busy

    def occupancy(self) -> dict:
        """{lane: busy fraction of wall time since the clock started},
        plus ``busy_seconds`` and the elapsed denominator — the
        bench/stats snapshot."""
        now = time.perf_counter()
        with self._lock:
            elapsed = max(now - self._t0, 1e-9)
            return {
                "elapsed_s": round(elapsed, 4),
                "busy_seconds": {
                    lane: round(self._busy_s(lane, now), 4)
                    for lane in LANES
                },
                "occupancy": {
                    lane: round(
                        min(self._busy_s(lane, now) / elapsed, 1.0), 4
                    )
                    for lane in LANES
                },
                "inflight_chunks": self._inflight,
            }

    def _occupancy_of(self, lane: str) -> float:
        now = time.perf_counter()
        with self._lock:
            elapsed = max(now - self._t0, 1e-9)
            return min(self._busy_s(lane, now) / elapsed, 1.0)

    def register(self, registry) -> "PipelineLanes":
        """Wire the occupancy + in-flight gauges into ``registry``
        (idempotent per registry; the newest clock wins)."""
        for name in LANES:
            registry.gauge(
                f"pipeline_{name}_busy",
                f"Occupancy of the pipeline's {name} lane (busy "
                "fraction of wall time since the run started; 1.0 = "
                "this lane is the bottleneck)",
            ).set_fn(lambda lane=name: self._occupancy_of(lane))
        registry.gauge(
            "pipeline_inflight_chunks",
            "Device chunks dispatched but not yet finished (the live "
            "overlap pipeline depth)",
        ).set_fn(self.inflight)
        return self
