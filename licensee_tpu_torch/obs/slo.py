"""The SLO engine: declarative objectives evaluated from the existing
registry counters over multi-window burn rates — the SRE alerting
pattern (fast 5m/1h pair, slow 30m/6h pair) on top of obs/registry.py.

An **objective** names a target fraction of good events ("99.9% of
requests answer without a server-caused error", "99% of requests
finish under 250 ms") and how to read good/bad totals out of the
registry:

* an *availability* objective sums an ``{event}``-labeled counter
  family's good vs bad event labels (the scheduler's
  ``serve_requests_total``, the router's ``fleet_requests_total``);
* a *latency* objective reads a histogram family's cumulative bucket
  at the threshold bound — requests at or under the bound are good,
  the rest bad — so the p-quantile SLO costs nothing beyond the
  histogram the latency path already feeds.

The **burn rate** over a window is ``(bad/total over the window) /
(1 - target)``: 1.0 means the error budget is being spent exactly at
the rate that exhausts it by the end of the SLO period; 14.4 over 5m
AND 1h is the classic page ("2% of a 30-day budget in an hour"), 6.0
over 30m AND 6h the ticket.  The engine keeps a bounded ring of
(timestamp, totals) samples — one per evaluation tick, monotonic
clock — and differences the cumulative counters over each window, so
a restart or a short-lived drill just evaluates over the history it
has (the window is clamped to engine uptime: a 90-second fault drill
reads its whole life as every window, which is exactly what its gate
wants).

Surfaces: ``slo_burn_rate{objective,window}`` gauges on the registry,
an ``slo`` block in the serve/router ``stats`` verbs, the
``licensee-tpu slo`` CLI verdict, and ``details.obs.slo`` in bench.py.

House rules (script/lint): monotonic clocks only, no print.
"""

from __future__ import annotations

import threading
import time

# the multi-window burn-rate ladder: (window name, seconds)
WINDOWS: tuple[tuple[str, float], ...] = (
    ("5m", 300.0),
    ("30m", 1800.0),
    ("1h", 3600.0),
    ("6h", 21600.0),
)
# page when BOTH windows of the fast pair burn above 14.4; ticket when
# both slow windows burn above 6 (Google SRE workbook, ch. 5)
FAST_PAIR = ("5m", "1h")
FAST_BURN = 14.4
SLOW_PAIR = ("30m", "6h")
SLOW_BURN = 6.0

# keep at most this many samples: beyond it the ring DECIMATES (every
# other older sample dropped) instead of evicting the oldest, so a
# fast scrape cadence coarsens window resolution but never shrinks the
# covered horizon — the 6h base sample survives any cadence
_MAX_SAMPLES = 4096


class Objective:
    """One declarative objective: a name, a target fraction, and how
    to read cumulative (good, bad) totals from a registry."""

    def __init__(self, name: str, target: float, description: str = ""):
        if not (0.0 < target < 1.0):
            raise ValueError(f"target must be in (0, 1), got {target!r}")
        self.name = name
        self.target = float(target)
        self.description = description

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def totals(self, registry) -> tuple[float, float]:
        raise NotImplementedError

    def store_deltas(self, store, labels: dict, window_s: float):
        """(good_delta, bad_delta) over the trailing window read from a
        telemetry store (obs/tsdb.py), or None when the store has no
        coverage yet — the engine then falls back to its sample ring.
        ``labels`` narrows to this process's scraped series (the
        scheduler's source tag, e.g. ``{"worker": "router"}``)."""
        return None


class AvailabilityObjective(Objective):
    """Good/bad read from an ``{event}``-labeled counter family:
    ``good_events`` answered well, ``bad_events`` are server-caused
    failures.  Events in neither set (cache_hits, hedges, ...) are
    bookkeeping, not outcomes."""

    def __init__(
        self,
        name: str,
        *,
        family: str,
        good_events: tuple[str, ...],
        bad_events: tuple[str, ...],
        target: float = 0.999,
        description: str = "",
    ):
        super().__init__(name, target, description)
        self.family = family
        self.good_events = tuple(good_events)
        self.bad_events = tuple(bad_events)

    def totals(self, registry) -> tuple[float, float]:
        fam = registry.counter(self.family, labels=("event",))
        good = bad = 0.0
        for labels, value in fam.samples():
            event = labels.get("event")
            if event in self.good_events:
                good += value
            elif event in self.bad_events:
                bad += value
        return good, bad

    def store_deltas(self, store, labels: dict, window_s: float):
        good = bad = 0.0
        covered = False
        for events, bucket in (
            (self.good_events, "good"), (self.bad_events, "bad")
        ):
            for event in events:
                d = store.delta(
                    self.family, {**labels, "event": event},
                    window_s=window_s,
                )
                if d is None:
                    continue  # this event never happened: no series
                covered = True
                if bucket == "good":
                    good += d
                else:
                    bad += d
        return (good, bad) if covered else None


class LatencyObjective(Objective):
    """Good = observations at or under ``threshold_s`` (the histogram's
    cumulative bucket at the nearest bound >= the threshold), bad = the
    rest — "target fraction of requests under X ms"."""

    def __init__(
        self,
        name: str,
        *,
        family: str,
        threshold_s: float,
        labels: dict | None = None,
        target: float = 0.99,
        description: str = "",
    ):
        super().__init__(name, target, description)
        self.family = family
        self.threshold_s = float(threshold_s)
        self.labels = dict(labels or {})

    def totals(self, registry) -> tuple[float, float]:
        fam = registry._families.get(self.family)
        if fam is None or fam.kind != "histogram":
            return 0.0, 0.0  # histogram not registered (yet): no data
        child = None
        for labels, value in fam.samples():
            if all(
                str(labels.get(k)) == str(v)
                for k, v in self.labels.items()
            ):
                child = value
                break
        if child is None:
            return 0.0, 0.0
        total = float(child["count"])
        # the nearest declared bound at or above the threshold: an SLO
        # threshold between bounds rounds UP (generous by one bucket,
        # never silently stricter than declared)
        good = total
        for bound_repr, cum in child["buckets"].items():
            if bound_repr == "+Inf":
                continue
            if float(bound_repr) >= self.threshold_s:
                good = float(cum)
                break
        return good, max(0.0, total - good)

    def store_deltas(self, store, labels: dict, window_s: float):
        merged = {**labels, **self.labels}
        total = store.delta(
            self.family + "_count", merged, window_s=window_s
        )
        if total is None or total <= 0:
            return None
        # nearest stored bound at or above the threshold (same
        # round-UP rule as the registry path); no finite bound at or
        # above it means every bucketed observation counts as good
        bounds = []
        for le in store.label_values(
            self.family + "_bucket", "le", merged
        ):
            if le != "+Inf":
                bounds.append((float(le), le))
        at_or_above = sorted(
            b for b in bounds if b[0] >= self.threshold_s
        )
        if not at_or_above:
            return total, 0.0
        good = store.delta(
            self.family + "_bucket",
            {**merged, "le": at_or_above[0][1]},
            window_s=window_s,
        )
        if good is None:
            return None
        return good, max(0.0, total - good)


def serve_objectives(
    availability_target: float = 0.999,
    latency_target: float = 0.99,
    latency_threshold_s: float = 0.25,
) -> list[Objective]:
    """The serve worker's default objectives over its scheduler
    counters and stage histogram."""
    return [
        AvailabilityObjective(
            "availability",
            family="serve_requests_total",
            good_events=("completed",),
            bad_events=("rejected", "expired", "completion_errors"),
            target=availability_target,
            description="requests answered without a server-caused "
            "error (queue_full rejects, deadline expiries, completion "
            "errors are bad)",
        ),
        LatencyObjective(
            "latency_p99",
            family="serve_stage_seconds",
            labels={"stage": "total"},
            threshold_s=latency_threshold_s,
            target=latency_target,
            description=f"requests finishing under "
            f"{latency_threshold_s * 1000:g} ms end to end",
        ),
    ]


def router_objectives(
    availability_target: float = 0.999,
    latency_target: float = 0.99,
    latency_threshold_s: float = 0.25,
) -> list[Objective]:
    """The fleet router's default objectives: a request the whole
    fleet failed (no backend, shed everywhere) is bad; a request that
    failed over and answered is good — failover working as designed is
    not an SLO violation."""
    return [
        AvailabilityObjective(
            "availability",
            family="fleet_requests_total",
            good_events=("ok",),
            bad_events=("no_backend", "queue_full_returned"),
            target=availability_target,
            description="routed requests answered with a verdict "
            "(fleet-wide backpressure and no-backend errors are bad; "
            "a successful failover is good)",
        ),
        LatencyObjective(
            "latency_p99",
            family="fleet_request_seconds",
            threshold_s=latency_threshold_s,
            target=latency_target,
            description=f"routed requests finishing under "
            f"{latency_threshold_s * 1000:g} ms (retries and hedges "
            "included)",
        ),
    ]


def pool_objectives(
    pools,
    latency_target: float = 0.99,
    latency_threshold_s: float = 0.25,
) -> list[Objective]:
    """Per-tenant-pool latency objectives over the router's pool-
    labeled latency histogram: one objective per pool, so a rolling
    reload of tenant A's pool breaching tenant B's latency shows up as
    burn on B's OWN objective — the isolation witness the multi-tenant
    selftest gates on."""
    return [
        LatencyObjective(
            f"pool_{pool}_latency_p99",
            family="fleet_tenant_request_seconds",
            labels={"pool": pool},
            threshold_s=latency_threshold_s,
            target=latency_target,
            description=f"pool {pool!r} requests finishing under "
            f"{latency_threshold_s * 1000:g} ms",
        )
        for pool in sorted(pools)
    ]


class SLOEngine:
    """Samples objective totals per evaluation, differences them over
    the burn windows, and publishes ``slo_burn_rate`` gauges.

    One engine per registry; ``attach()`` hooks the registry's
    collector pass so every scrape both ticks the sample ring and
    refreshes the gauges."""

    def __init__(
        self, registry, objectives: list[Objective],
        *, store=None, store_labels: dict | None = None,
    ):
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.registry = registry
        self.objectives = list(objectives)
        # the telemetry store (obs/tsdb.py): when attached, burn
        # windows become store queries over the retained series
        # (tagged store_labels by the scrape scheduler); the private
        # sample ring stays as the fallback until the store has
        # coverage for a window
        self._store = store
        self._store_labels = dict(store_labels or {})
        self._t0 = time.perf_counter()
        self.last: dict | None = None  # the most recent evaluation
        # the sample ring: (t, {objective: (good, bad)}) — guarded by
        # its own lock so stats() and a concurrent scrape never tear it
        self._samples: list[tuple[float, dict]] = []
        self._lock = threading.Lock()
        # the construction-time baseline: a window that reaches past
        # the oldest sample differences against THIS, so a first-ever
        # scrape of a long-lived process sees everything since boot
        # instead of a vacuous zero-delta against itself
        self._baseline = {
            o.name: o.totals(registry) for o in self.objectives
        }
        self._burn_gauge = registry.gauge(
            "slo_burn_rate",
            "Error-budget burn rate per objective and window (1.0 "
            "spends the budget exactly over the SLO period; the fast "
            "pair pages above 14.4, the slow pair tickets above 6)",
            labels=("objective", "window"),
        )

    def attach(self) -> "SLOEngine":
        """Evaluate on every registry collector pass (scrapes and
        snapshots tick the engine for free).  Attach AFTER the counter
        sources' own collectors so each pass evaluates fresh totals."""
        self.registry.add_collector(lambda _reg: self.evaluate())
        return self

    def snapshot(self) -> dict:
        """Run one registry collector pass (which syncs the counter
        sources and, via attach, evaluates this engine) and return the
        resulting ``slo`` block — the stats-verb entry point."""
        self.registry.collect()
        if self.last is None:
            return self.evaluate()
        return self.last

    def _tick(self, now: float) -> dict:
        totals = {o.name: o.totals(self.registry) for o in self.objectives}
        horizon = now - WINDOWS[-1][1]
        with self._lock:
            self._samples.append((now, totals))
            # prune history older than the longest window, but ALWAYS
            # keep one sample at or before the horizon: it is the base
            # the 6h delta differences against — dropping it would pin
            # that window to the construction baseline forever (ancient
            # errors would never age out of the gauge)
            while len(self._samples) > 1 and (
                self._samples[1][0] <= horizon
            ):
                self._samples.pop(0)
            if len(self._samples) > _MAX_SAMPLES:
                # over the cap, DECIMATE the older samples instead of
                # evicting the oldest: a 1 Hz scrape cadence must
                # coarsen resolution, never shrink the covered horizon
                # below the 6h window (the cap-eviction version pinned
                # long windows to the construction baseline forever)
                self._samples = (
                    self._samples[0:1]
                    + self._samples[1:-1:2]
                    + self._samples[-1:]
                )
            samples = list(self._samples)
        return {"totals": totals, "samples": samples}

    def _window_delta(self, samples, now: float, window_s: float,
                      name: str):
        """(good_delta, bad_delta) between now's sample and the oldest
        point inside the window.  A window reaching past the oldest
        sample clamps to the CONSTRUCTION BASELINE — engine history —
        so a drill (or a first-ever scrape) reads its whole life, and
        errors that landed before the first tick still burn."""
        newest = samples[-1][1].get(name, (0.0, 0.0))
        cutoff = now - window_s
        # base = the totals as of the window's start: the last sample
        # at or before the cutoff, else (window older than history)
        # the construction baseline
        base = self._baseline.get(name, (0.0, 0.0))
        for t, totals in samples:
            if t > cutoff:
                break
            base = totals.get(name, (0.0, 0.0))
        # counters are monotonic per objective source; clamp anyway so
        # a restarted source can never report negative burn
        return (
            max(0.0, newest[0] - base[0]),
            max(0.0, newest[1] - base[1]),
        )

    def evaluate(self, now: float | None = None) -> dict:
        """One evaluation: sample the counters, compute burn per
        objective per window, refresh the gauges, return the ``slo``
        stats block."""
        now = time.perf_counter() if now is None else now
        tick = self._tick(now)
        samples = tick["samples"]
        out: dict = {"ok": True, "uptime_s": round(now - self._t0, 3),
                     "objectives": {}}
        for obj in self.objectives:
            good_now, bad_now = tick["totals"][obj.name]
            windows: dict[str, float | None] = {}
            sources: dict[str, str] = {}
            for wname, wsecs in WINDOWS:
                deltas = None
                if self._store is not None:
                    try:
                        deltas = obj.store_deltas(
                            self._store, self._store_labels, wsecs
                        )
                    except Exception:  # noqa: BLE001 — a store hiccup falls back to the ring
                        deltas = None
                if deltas is None:
                    sources[wname] = "ring"
                    deltas = self._window_delta(
                        samples, now, wsecs, obj.name
                    )
                else:
                    sources[wname] = "store"
                good_d, bad_d = deltas
                total = good_d + bad_d
                if total <= 0:
                    burn = 0.0  # no traffic burns no budget
                else:
                    burn = (bad_d / total) / obj.budget
                windows[wname] = round(burn, 4)
                self._burn_gauge.labels(
                    objective=obj.name, window=wname
                ).set(burn)
            fast = min(windows[w] for w in FAST_PAIR)
            slow = min(windows[w] for w in SLOW_PAIR)
            row = {
                "target": obj.target,
                "description": obj.description,
                "good": good_now,
                "bad": bad_now,
                "windows": windows,
                "window_sources": sources,
                "max_burn": max(windows.values()),
                "fast_burn_alert": fast > FAST_BURN,
                "slow_burn_alert": slow > SLOW_BURN,
            }
            row["ok"] = not (
                row["fast_burn_alert"] or row["slow_burn_alert"]
            )
            if not row["ok"]:
                out["ok"] = False
            out["objectives"][obj.name] = row
        self.last = out
        return out
