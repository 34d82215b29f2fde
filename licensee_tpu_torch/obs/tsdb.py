"""Bounded in-memory time-series store + fleet scrape scheduler — the
fleet's retained telemetry plane.

Before this module every consumer re-derived rates from point-in-time
scrapes: the autoscaler read one-shot ``--prom-file`` dumps, ``stats
--watch`` recomputed deltas client-side, and the SLO engine kept its own
private sample ring.  :class:`TsdbStore` is the one retained history
they all read from — the Monarch/Prometheus shape, in-process and
stdlib-only:

* Per-series ring of ``(ts, value)`` samples.  A fine ring (nominally
  one sample per scrape, e.g. 10s x 360 = 1h) steps down into a coarse
  ring (one survivor per ``coarse_step_s`` bucket, e.g. 2m x 360 = 12h)
  as samples age out, so recent history is dense and old history cheap.
* Hard byte/series caps.  When either cap is crossed the COLDEST series
  (oldest ``last_ts``) is evicted first and the eviction counted — a
  label explosion degrades retention, never the process.
* Server-side derivations: counter-reset-aware ``rate()`` / ``delta()``
  and ``quantile()`` over stored ``_bucket`` series, plus a structured
  :meth:`TsdbStore.query` surface the ``{"op": "query"}`` front verb and
  ``GET /metrics/history`` route call into.
* Exemplars: samples parsed from an exposition keep their OpenMetrics
  ``# {trace_id="..."}`` exemplar (slowest within the retention window),
  so a stored p99 spike still links back to the trace that caused it.

:class:`ScrapeScheduler` feeds the store: a fixed-cadence thread that
pulls every registered target's exposition (the router wires per-backend
fetchers over its parked ``fleet/wire`` probe connections and its own
registry in-process), tags samples with a source label, and records its
own lag/miss counters — as registry metrics AND as stored series, so the
telemetry plane observes itself.

House rules (script/lint): monotonic clocks only, no print.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque

__all__ = [
    "TsdbStore",
    "ScrapeScheduler",
    "QueryError",
    "parse_exposition_samples",
]

# retention geometry defaults: 10s x 360 fine (1h dense) stepping down
# to 2m x 360 coarse (12h total) — see the README retention table
DEFAULT_FINE_STEP_S = 10.0
DEFAULT_FINE_LEN = 360
DEFAULT_COARSE_STEP_S = 120.0
DEFAULT_COARSE_LEN = 360

# cost model for the byte cap: a (ts, value) tuple plus ring overhead;
# an estimate, not sys.getsizeof — the cap bounds growth, not malloc
_POINT_BYTES = 64
_SERIES_BYTES = 512

# a stored exemplar goes stale after this long: within the window only
# a slower one replaces it, after it anything fresh wins (mirrors
# registry.EXEMPLAR_TTL_S at the storage layer)
EXEMPLAR_TTL_S = 120.0

_RAW_POINT_LIMIT = 720  # hard cap on points one raw query returns

_NUM = r"[+-]?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf|inf)|NaN|nan"
_SAMPLE_LINE_RE = re.compile(
    rf"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{{[^}}]*\}})? ({_NUM})"
    r"(?: [+-]?[0-9]+)?"
    rf'(?: # \{{trace_id="((?:[^"\\]|\\.)*)"\}} ({_NUM}))?$'
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'
)


def _unescape(value: str) -> str:
    return (
        value.replace(r"\"", '"').replace(r"\n", "\n").replace("\\\\", "\\")
    )


def parse_exposition_samples(text: str):
    """Yield ``(name, labels, value, exemplar)`` per sample line of a
    text exposition; ``exemplar`` is ``(trace_id, value)`` or None.
    Comments and non-grammar lines are skipped, never raised — a sick
    source degrades one scrape, not the store."""
    for line in (text or "").splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_LINE_RE.match(line)
        if m is None:
            continue
        name, labelset, value, ex_trace, ex_value = m.groups()
        labels = (
            {
                k: _unescape(v)
                for k, v in _LABEL_PAIR_RE.findall(labelset)
            }
            if labelset
            else {}
        )
        exemplar = (
            (_unescape(ex_trace), float(ex_value))
            if ex_trace is not None
            else None
        )
        yield name, labels, float(value), exemplar


class QueryError(ValueError):
    """A structured query the store cannot serve.  ``code`` is the wire
    error-code prefix the front verb / HTTP route answer with:
    ``bad_request`` (malformed params) or ``unknown_series`` (no stored
    series matches)."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


class _Series:
    __slots__ = ("name", "labels", "fine", "coarse", "last_ts", "exemplar")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels  # sorted (key, value) tuple
        self.fine: deque = deque()
        self.coarse: deque = deque()
        self.last_ts = 0.0
        self.exemplar = None  # (ts, trace_id, value)

    def n_points(self) -> int:
        return len(self.fine) + len(self.coarse)


class TsdbStore:
    """The bounded per-process time-series store (see module docstring).

    All public methods are thread-safe behind one lock: ingest runs on
    the scheduler/ops-executor thread, queries on front-session defers,
    and both are short O(points-in-window) walks."""

    def __init__(
        self,
        *,
        fine_step_s: float = DEFAULT_FINE_STEP_S,
        fine_len: int = DEFAULT_FINE_LEN,
        coarse_step_s: float = DEFAULT_COARSE_STEP_S,
        coarse_len: int = DEFAULT_COARSE_LEN,
        max_series: int = 4096,
        max_bytes: int = 8_000_000,
        clock=time.monotonic,
    ):
        if coarse_step_s < fine_step_s:
            raise ValueError("coarse_step_s must be >= fine_step_s")
        self.fine_step_s = float(fine_step_s)
        self.fine_len = int(fine_len)
        self.coarse_step_s = float(coarse_step_s)
        self.coarse_len = int(coarse_len)
        self.max_series = int(max_series)
        self.max_bytes = int(max_bytes)
        self._clock = clock
        self._series: dict[tuple, _Series] = {}
        self._lock = threading.Lock()
        self._points = 0  # live points across all rings
        self._ingested = 0  # lifetime samples accepted
        self._evicted = 0  # lifetime series evicted by the caps

    # -- retention window the store can answer about, in seconds --

    def retention_s(self) -> float:
        return (
            self.fine_step_s * self.fine_len
            + self.coarse_step_s * self.coarse_len
        )

    # -- ingest --

    def ingest(
        self,
        name: str,
        labels: dict | None = None,
        value: float = 0.0,
        ts: float | None = None,
        exemplar: tuple | None = None,
    ) -> None:
        """Append one sample.  ``exemplar`` is ``(trace_id, value)``."""
        if ts is None:
            ts = self._clock()
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            self._append(key, float(value), float(ts), exemplar)
            self._enforce_caps()

    def ingest_exposition(
        self,
        text: str,
        extra_labels: dict | None = None,
        ts: float | None = None,
    ) -> int:
        """Fold one text exposition into the store (every sample gets
        ``extra_labels`` — the scheduler's source tag).  Returns the
        number of samples stored."""
        if ts is None:
            ts = self._clock()
        extra = tuple(sorted((extra_labels or {}).items()))
        n = 0
        with self._lock:
            for name, labels, value, exemplar in parse_exposition_samples(
                text
            ):
                merged = dict(extra)
                merged.update(labels)
                key = (name, tuple(sorted(merged.items())))
                self._append(key, value, ts, exemplar)
                n += 1
            self._enforce_caps()
        return n

    def _append(self, key, value, ts, exemplar) -> None:
        series = self._series.get(key)
        if series is None:
            series = _Series(key[0], key[1])
            self._series[key] = series
        # step-down: a fine ring at capacity folds its oldest sample
        # into the coarse ring — one survivor (the LAST sample) per
        # coarse_step_s bucket, so old history thins instead of dying
        if len(series.fine) >= self.fine_len:
            old_ts, old_value = series.fine.popleft()
            self._points -= 1
            coarse = series.coarse
            bucket = int(old_ts // self.coarse_step_s)
            if coarse and int(coarse[-1][0] // self.coarse_step_s) == bucket:
                coarse[-1] = (old_ts, old_value)
            else:
                coarse.append((old_ts, old_value))
                self._points += 1
                if len(coarse) > self.coarse_len:
                    coarse.popleft()
                    self._points -= 1
        series.fine.append((ts, value))
        series.last_ts = ts
        self._points += 1
        self._ingested += 1
        if exemplar is not None:
            trace_id, ex_value = exemplar
            slot = series.exemplar
            if (
                slot is None
                or ex_value >= slot[2]
                or ts - slot[0] > EXEMPLAR_TTL_S
            ):
                series.exemplar = (ts, str(trace_id), float(ex_value))

    def _bytes_est(self) -> int:
        return (
            self._points * _POINT_BYTES
            + len(self._series) * _SERIES_BYTES
        )

    def _enforce_caps(self) -> None:
        while self._series and (
            len(self._series) > self.max_series
            or self._bytes_est() > self.max_bytes
        ):
            key = min(self._series, key=lambda k: self._series[k].last_ts)
            self._points -= self._series.pop(key).n_points()
            self._evicted += 1

    # -- series selection --

    def _match(self, name: str, labels: dict | None) -> list[_Series]:
        want = (labels or {}).items()
        out = []
        for series in self._series.values():
            if series.name != name:
                continue
            have = dict(series.labels)
            if all(have.get(k) == str(v) for k, v in want):
                out.append(series)
        return out

    @staticmethod
    def _points_since(
        series: _Series, since: float, until: float | None = None
    ) -> list[tuple]:
        """Points in ``(since, until]`` — the upper bound matters: a
        derivation over a PAST window (the anomaly rules' trailing
        baselines) must not see samples newer than its window end, or
        a live fault bleeds backward into every baseline judged
        against it."""
        pts = [
            p for p in series.coarse
            if p[0] >= since and (until is None or p[0] <= until)
        ]
        pts.extend(
            p for p in series.fine
            if p[0] >= since and (until is None or p[0] <= until)
        )
        return pts

    @staticmethod
    def _increase(pts: list[tuple]) -> float:
        """Counter-reset-aware increase over a point list: negative
        adjacent deltas (a restarted source) contribute zero instead of
        poisoning the sum."""
        total = 0.0
        for (_, a), (_, b) in zip(pts, pts[1:]):
            if b > a:
                total += b - a
        return total

    def label_values(
        self, name: str, label: str, labels: dict | None = None
    ) -> list[str]:
        """Distinct values of ``label`` across stored series matching
        name+labels — how the SLO engine discovers a stored histogram's
        bucket bounds."""
        with self._lock:
            values = {
                dict(series.labels).get(label)
                for series in self._match(name, labels)
            }
        return sorted(v for v in values if v is not None)

    # -- derivations --

    def latest(self, name: str, labels: dict | None = None):
        """(ts, value) of the freshest matching sample, or None."""
        best = None
        with self._lock:
            for series in self._match(name, labels):
                if series.fine and (
                    best is None or series.last_ts > best[0]
                ):
                    best = series.fine[-1]
        return best

    def rate(
        self, name: str, labels: dict | None = None,
        window_s: float = 60.0, now: float | None = None,
    ):
        """Per-second increase summed across matching series over the
        trailing window, or None when no series has two samples in it."""
        if now is None:
            now = self._clock()
        since = now - window_s
        total = None
        with self._lock:
            for series in self._match(name, labels):
                pts = self._points_since(series, since, now)
                if len(pts) < 2:
                    continue
                span = pts[-1][0] - pts[0][0]
                if span <= 0:
                    continue
                total = (total or 0.0) + self._increase(pts) / span
        return total

    def delta(
        self, name: str, labels: dict | None = None,
        window_s: float = 60.0, now: float | None = None,
    ):
        """Increase (reset-aware) summed across matching series over
        the trailing window, or None when nothing is computable."""
        if now is None:
            now = self._clock()
        since = now - window_s
        total = None
        with self._lock:
            for series in self._match(name, labels):
                pts = self._points_since(series, since, now)
                if len(pts) < 2:
                    continue
                total = (total or 0.0) + self._increase(pts)
        return total

    def quantile(
        self, q: float, name: str, labels: dict | None = None,
        window_s: float = 60.0, now: float | None = None,
    ):
        """PromQL-style histogram quantile over stored ``{name}_bucket``
        series deltas in the window.  Returns ``(value, exemplar)`` —
        exemplar is ``{"trace_id", "value"}`` for the slowest in-window
        exemplar any matched bucket retained, or None — or ``(None,
        None)`` when the window saw no observations."""
        if now is None:
            now = self._clock()
        since = now - window_s
        by_le: dict[float, float] = {}
        exemplar = None
        ex_best = -1.0
        with self._lock:
            for series in self._match(name + "_bucket", labels):
                le = dict(series.labels).get("le")
                if le is None:
                    continue
                bound = float("inf") if le == "+Inf" else float(le)
                pts = self._points_since(series, since, now)
                if len(pts) >= 2:
                    by_le[bound] = by_le.get(bound, 0.0) + self._increase(
                        pts
                    )
                slot = series.exemplar
                if (
                    slot is not None
                    and now - slot[0] <= max(window_s, EXEMPLAR_TTL_S)
                    and slot[2] > ex_best
                ):
                    ex_best = slot[2]
                    exemplar = {"trace_id": slot[1], "value": slot[2]}
        if not by_le:
            return None, None
        bounds = sorted(by_le)
        total = by_le.get(float("inf"), max(by_le.values()))
        if total <= 0:
            return None, None
        rank = max(0.0, min(1.0, float(q))) * total
        prev_bound, prev_cum = 0.0, 0.0
        for bound in bounds:
            cum = by_le[bound]
            if cum >= rank:
                if bound == float("inf"):
                    return prev_bound, exemplar
                if cum <= prev_cum:
                    return bound, exemplar
                frac = (rank - prev_cum) / (cum - prev_cum)
                return prev_bound + frac * (bound - prev_bound), exemplar
            prev_bound, prev_cum = bound, cum
        return bounds[-1] if bounds[-1] != float("inf") else prev_bound, (
            exemplar
        )

    # -- the structured wire-facing query surface --

    def query(self, params: dict) -> dict:
        """Serve one ``{"op": "query"}`` / ``/metrics/history`` request.
        Raises :class:`QueryError` (code ``bad_request`` or
        ``unknown_series``) on anything unservable."""
        if not isinstance(params, dict):
            raise QueryError("bad_request", "query params must be a dict")
        if params.get("list"):
            match = str(params.get("match") or "")
            with self._lock:
                names = sorted(
                    {
                        s.name
                        for s in self._series.values()
                        if s.name.startswith(match)
                    }
                )
            return {"series_list": names[:500], "n_series": len(names)}
        name = params.get("series")
        if not isinstance(name, str) or not name:
            raise QueryError("bad_request", "query needs a series name")
        fn = params.get("fn", "latest")
        if fn not in ("latest", "raw", "rate", "delta", "quantile"):
            raise QueryError("bad_request", f"unknown query fn {fn!r}")
        labels = params.get("labels") or {}
        if not isinstance(labels, dict):
            raise QueryError("bad_request", "labels must be an object")
        labels = {str(k): str(v) for k, v in labels.items()}
        try:
            window = float(params.get("window", 60.0))
        except (TypeError, ValueError):
            raise QueryError("bad_request", "window must be a number")
        window = max(1.0, min(window, self.retention_s()))
        by = params.get("by")
        if by is not None and not isinstance(by, str):
            raise QueryError("bad_request", "by must be a label name")
        now = self._clock()
        match_name = name + "_bucket" if fn == "quantile" else name
        with self._lock:
            matched = self._match(match_name, labels)
        if not matched:
            raise QueryError(
                "unknown_series",
                f"no stored series matches {match_name!r} {labels!r}",
            )
        out = {
            "series": name,
            "fn": fn,
            "window": window,
            "matched": len(matched),
        }
        if by:
            groups = {}
            for series in matched:
                groups.setdefault(dict(series.labels).get(by, ""), None)
            out["groups"] = {
                value: self._eval(
                    fn, match_name, {**labels, by: value}, window,
                    params, now,
                )
                for value in sorted(groups)
            }
            return out
        out.update(self._eval(fn, match_name, labels, window, params, now))
        return out

    def _eval(
        self, fn: str, match_name: str, labels: dict, window: float,
        params: dict, now: float,
    ) -> dict:
        if fn == "latest":
            hit = self.latest(match_name, labels)
            return {
                "value": None if hit is None else hit[1],
                "ts": None if hit is None else round(hit[0], 3),
            }
        if fn == "raw":
            try:
                limit = int(params.get("limit", 240))
            except (TypeError, ValueError):
                raise QueryError("bad_request", "limit must be an int")
            limit = max(1, min(limit, _RAW_POINT_LIMIT))
            since = now - window
            with self._lock:
                merged = []
                for series in self._match(match_name, labels):
                    merged.extend(self._points_since(series, since, now))
            merged.sort()
            return {
                "points": [
                    [round(ts, 3), value]
                    for ts, value in merged[-limit:]
                ],
                "now": round(now, 3),
            }
        if fn == "rate":
            return {
                "value": self.rate(match_name, labels, window, now)
            }
        if fn == "delta":
            return {
                "value": self.delta(match_name, labels, window, now)
            }
        # quantile: match_name already carries the _bucket suffix the
        # underlying derivation re-appends, so strip it back off
        try:
            q = float(params.get("q", 0.99))
        except (TypeError, ValueError):
            raise QueryError("bad_request", "q must be a number")
        if not 0.0 <= q <= 1.0:
            raise QueryError("bad_request", "q must be in [0, 1]")
        value, exemplar = self.quantile(
            q, match_name[: -len("_bucket")], labels, window, now
        )
        row = {"value": value, "q": q}
        if exemplar is not None:
            row["exemplar"] = exemplar
        return row

    # -- introspection --

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "points": self._points,
                "bytes_est": self._bytes_est(),
                "max_series": self.max_series,
                "max_bytes": self.max_bytes,
                "evicted_series": self._evicted,
                "ingested_samples": self._ingested,
                "retention_s": self.retention_s(),
            }

    def register_metrics(self, registry) -> None:
        registry.gauge(
            "tsdb_series", "Live series in the telemetry store"
        ).set_fn(lambda: len(self._series))
        registry.gauge(
            "tsdb_bytes",
            "Estimated bytes the telemetry store holds (capped)",
        ).set_fn(self._bytes_est)
        ingested = registry.counter(
            "tsdb_points_total", "Samples accepted into the store"
        )
        evicted = registry.counter(
            "tsdb_evicted_series_total",
            "Series evicted coldest-first by the byte/series caps",
        )

        def _sync(_registry=None):
            ingested.sync(float(self._ingested))
            evicted.sync(float(self._evicted))

        registry.add_collector(_sync)


class ScrapeScheduler:
    """Fixed-cadence fleet scraper feeding a :class:`TsdbStore`.

    One daemon thread ticks every ``interval_s``; each tick runs one
    ROUND — every registered target's ``fetch()`` (an exposition string;
    the router's are closures over parked probe connections) ingested
    under ``{label: target}``.  With an ``executor`` the round runs
    there (the router hands its ops pool so scrapes never touch the
    event loop); a round still in flight when the next tick lands is
    skipped and counted.  The scheduler stores its own lag/miss/skip
    telemetry as series — the plane observes itself."""

    def __init__(
        self,
        store: TsdbStore,
        *,
        interval_s: float = 5.0,
        label: str = "worker",
        executor=None,
        on_round=None,
        clock=time.monotonic,
    ):
        self.store = store
        self.interval_s = float(interval_s)
        self.label = label
        self._executor = executor
        self._on_round = on_round
        self._clock = clock
        self._targets: dict[str, object] = {}
        self._targets_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._pending = None  # in-flight round future (executor mode)
        self._rounds = 0
        self._skipped = 0
        self._misses: dict[str, int] = {}
        self._last_lag_s = 0.0

    def add_target(self, name: str, fetch) -> None:
        """``fetch() -> exposition text`` (may raise: counted a miss)."""
        with self._targets_lock:
            self._targets[name] = fetch

    def remove_target(self, name: str) -> None:
        with self._targets_lock:
            self._targets.pop(name, None)

    def start(self) -> "ScrapeScheduler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tsdb-scrape", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run(self) -> None:
        due = self._clock() + self.interval_s
        while not self._stop.wait(max(0.0, due - self._clock())):
            now = self._clock()
            lag = max(0.0, now - due)
            due += self.interval_s
            if due <= now:  # missed whole ticks: re-anchor, don't burst
                due = now + self.interval_s
            if self._executor is not None:
                if self._pending is not None and not self._pending.done():
                    self._skipped += 1
                    continue
                try:
                    self._pending = self._executor.submit(
                        self.scrape_once, lag
                    )
                except RuntimeError:
                    return  # executor shut down: the fleet is closing
            else:
                self.scrape_once(lag)

    def scrape_once(self, lag_s: float = 0.0) -> int:
        """One synchronous round; returns samples ingested.  Public so
        selftests/benches can drive the store without the thread."""
        with self._targets_lock:
            targets = list(self._targets.items())
        n = 0
        for name, fetch in targets:
            try:
                text = fetch()
                n += self.store.ingest_exposition(
                    text, extra_labels={self.label: name}
                )
                # the Prometheus "up" convention: one fresh sample per
                # successful scrape — the flatline watchdog rule
                # watches THIS series' staleness per target
                self.store.ingest(
                    "tsdb_scrape_up", {self.label: name}, 1.0
                )
            except Exception:  # noqa: BLE001 — one sick target must not starve the round
                self._misses[name] = self._misses.get(name, 0) + 1
                self.store.ingest(
                    "tsdb_scrape_misses_total",
                    {"target": name},
                    float(self._misses[name]),
                )
        self._rounds += 1
        self._last_lag_s = lag_s
        self.store.ingest("tsdb_scrape_lag_seconds", {}, lag_s)
        self.store.ingest(
            "tsdb_scrape_rounds_total", {}, float(self._rounds)
        )
        if self._on_round is not None:
            try:
                self._on_round()
            except Exception:  # noqa: BLE001 — a watchdog bug must not stop the scrapes
                pass
        return n

    def stats(self) -> dict:
        return {
            "targets": sorted(self._targets),
            "interval_s": self.interval_s,
            "rounds": self._rounds,
            "skipped_rounds": self._skipped,
            "misses": dict(self._misses),
            "last_lag_s": round(self._last_lag_s, 6),
        }

    def register_metrics(self, registry) -> None:
        rounds = registry.counter(
            "tsdb_scrape_rounds_total", "Completed fleet scrape rounds"
        )
        skipped = registry.counter(
            "tsdb_scrape_skipped_total",
            "Scrape ticks skipped because the prior round was in flight",
        )
        misses = registry.counter(
            "tsdb_scrape_misses_total",
            "Failed target scrapes", labels=("target",),
        )
        registry.gauge(
            "tsdb_scrape_lag_seconds",
            "How late the last scrape round started vs its schedule",
        ).set_fn(lambda: self._last_lag_s)

        def _sync(_registry=None):
            rounds.sync(float(self._rounds))
            skipped.sync(float(self._skipped))
            for name, count in list(self._misses.items()):
                misses.labels(target=name).sync(float(count))

        registry.add_collector(_sync)
