"""Process-wide metrics registry: counters, gauges, and fixed-bound
histograms behind ONE ``snapshot()``.

Before this module, the repo's visibility was three disconnected
islands — serve/stats.py latency reservoirs, the LicenseCache hit/miss
counters, and the native ``profile_dump()`` stage counters — each with
its own snapshot shape and none machine-scrapable.  The registry is the
single place every subsystem reports through; obs/export.py renders one
snapshot as Prometheus text exposition.

Design notes (Prometheus-style pull model):

* Metrics are registered once by name and looked up idempotently —
  ``registry.counter("x")`` twice returns the same family, and a kind
  mismatch is a hard error (silent shadowing would split a series).
* A family may declare label names; ``family.labels(stage="device")``
  returns the per-labelset child (created on first use).  A family with
  no labels proxies its single anonymous child, so unlabeled metrics
  read naturally (``c.inc()``).
* Pull collectors (``add_collector``) run at snapshot time to sync
  sources that keep their own counters (the scheduler's counter dict,
  the cache, the native pipeline) into registry metrics — the existing
  subsystems keep their fast ad-hoc increments and the registry absorbs
  them per scrape.
* Histograms use FIXED bucket bounds chosen at registration: constant
  memory, mergeable across processes, and exactly what the Prometheus
  histogram type wants (cumulative ``le`` buckets + sum + count).

House rules (script/lint): obs/ uses monotonic clocks only and never
prints — exporters write to explicit streams.
"""

from __future__ import annotations

import re
import threading
import time

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# latency-in-seconds bounds: 0.5 ms .. 10 s, roughly x2.5 per step —
# tight enough at the bottom for the sub-ms cache/featurize stages,
# wide enough at the top for a cold-compile device dispatch
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_KINDS = ("counter", "gauge", "histogram")


class Counter:
    """Monotonic count.  ``inc`` for owned increments; ``sync`` for
    pull collectors that mirror an external monotonic total."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0: {amount!r}")
        with self._lock:
            self._value += amount

    def sync(self, total: float) -> None:
        """Set the absolute total from an external monotonic source
        (never moves backwards — a restarted source keeps the max)."""
        with self._lock:
            if total > self._value:
                self._value = total

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value: ``set`` for push, ``set_fn`` for pull (the
    callable is invoked at snapshot time)."""

    __slots__ = ("_value", "_fn")

    def __init__(self):
        self._value = 0.0
        self._fn = None

    def set(self, value: float) -> None:
        self._fn = None
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def set_fn(self, fn) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a dead source reads 0, never raises mid-scrape
                return 0.0
        return self._value


# an exemplar sticks to its bucket for one retention window: within
# the window only a SLOWER observation replaces it (the p99 culprit
# survives a flood of fast requests), after it anything fresh wins
EXEMPLAR_TTL_S = 120.0


class Histogram:
    """Fixed-bound histogram: cumulative bucket counts + sum + count,
    the Prometheus histogram type.

    ``observe(value, exemplar=trace_id)`` optionally pins an OpenMetrics
    exemplar to the bucket the observation lands in — the slowest
    observation per bucket per :data:`EXEMPLAR_TTL_S` window keeps its
    trace ID, so a p99 spike in the exposition links straight back to
    the assembled trace that caused it."""

    __slots__ = ("bounds", "_counts", "_sum", "_count", "_lock",
                 "_exemplars")

    def __init__(self, bounds=DEFAULT_LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram bounds must be ascending and unique: {bounds!r}"
            )
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        # per bucket: (value, trace_id, monotonic ts) or None
        self._exemplars = [None] * (len(bounds) + 1)

    def observe(self, value: float, exemplar: str | None = None) -> None:
        # linear probe: bound lists are short (~14) and the common case
        # (sub-ms latencies) exits in the first few steps
        i = 0
        bounds = self.bounds
        while i < len(bounds) and value > bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if exemplar is not None:
                slot = self._exemplars[i]
                now = time.monotonic()
                if (
                    slot is None
                    or value >= slot[0]
                    or now - slot[2] > EXEMPLAR_TTL_S
                ):
                    self._exemplars[i] = (float(value), str(exemplar), now)

    @property
    def value(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._count
            slots = list(self._exemplars)
        cumulative: dict[str, int] = {}
        running = 0
        for bound, c in zip(self.bounds, counts):
            running += c
            cumulative[repr(bound)] = running
        cumulative["+Inf"] = running + counts[-1]
        out = {"buckets": cumulative, "sum": total, "count": n}
        now = time.monotonic()
        exemplars = {
            le: {"value": slot[0], "trace_id": slot[1]}
            for le, slot in zip([*cumulative], slots)
            if slot is not None and now - slot[2] <= EXEMPLAR_TTL_S
        }
        if exemplars:
            out["exemplars"] = exemplars
        return out


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric + its per-labelset children."""

    def __init__(self, kind: str, name: str, help: str, label_names, **kwargs):
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._kwargs = kwargs
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def labels(self, **labels):
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        key = tuple(str(labels[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, _METRIC_TYPES[self.kind](**self._kwargs)
                )
        return child

    # -- unlabeled families proxy their single anonymous child --

    def _solo(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; use .labels()"
            )
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def sync(self, total: float) -> None:
        self._solo().sync(total)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def set_fn(self, fn) -> None:
        self._solo().set_fn(fn)

    def observe(self, value: float, exemplar: str | None = None) -> None:
        self._solo().observe(value, exemplar=exemplar)

    @property
    def value(self):
        return self._solo().value

    def samples(self):
        """[(labels_dict, value)] — value is a float, or the bucket
        dict for histograms."""
        with self._lock:
            items = list(self._children.items())
        return [
            (dict(zip(self.label_names, key)), child.value)
            for key, child in sorted(items)
        ]


class MetricsRegistry:
    """The one place a process's metrics live.

    ``snapshot()`` runs every registered pull collector, then returns a
    JSON-ready dict; obs/export.py renders the same snapshot as
    Prometheus text exposition."""

    def __init__(self):
        self._families: dict[str, MetricFamily] = {}
        self._collectors: list = []
        self._lock = threading.Lock()

    def _family(self, kind, name, help, labels, **kwargs) -> MetricFamily:
        if not _NAME_OK(name):
            raise ValueError(f"bad metric name {name!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(kind, name, help, labels, **kwargs)
                self._families[name] = fam
                return fam
        if (
            fam.kind != kind
            or fam.label_names != tuple(labels)
            or fam._kwargs != kwargs  # histogram bounds included:
            # silently returning a family with DIFFERENT buckets would
            # dump the second caller's observations into the wrong bins
        ):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}"
                f"{fam.label_names}{fam._kwargs or ''}, not "
                f"{kind}{tuple(labels)}{kwargs or ''}"
            )
        return fam

    def counter(self, name, help="", labels=()) -> MetricFamily:
        return self._family("counter", name, help, labels)

    def gauge(self, name, help="", labels=()) -> MetricFamily:
        return self._family("gauge", name, help, labels)

    def histogram(
        self, name, help="", labels=(), buckets=DEFAULT_LATENCY_BUCKETS
    ) -> MetricFamily:
        return self._family(
            "histogram", name, help, labels, bounds=buckets
        )

    def add_collector(self, fn) -> None:
        """``fn(registry)`` runs at every snapshot BEFORE values are
        read — the pull hook for sources that keep their own counters."""
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn(self)

    def families(self) -> list[MetricFamily]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def snapshot(self) -> dict:
        """{name: {type, help, samples: [{labels, value}]}} after a
        collector pass — one scrape of everything registered."""
        self.collect()
        out = {}
        for fam in self.families():
            out[fam.name] = {
                "type": fam.kind,
                "help": fam.help,
                "samples": [
                    {"labels": labels, "value": value}
                    for labels, value in fam.samples()
                ],
            }
        return out


def _NAME_OK(name: str) -> bool:
    return bool(_NAME_RE.match(name))


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (offline/batch paths publish
    here; a MicroBatcher defaults to its own registry so repeated
    instances — tests, notebooks — don't shadow each other's gauges)."""
    return _default_registry
