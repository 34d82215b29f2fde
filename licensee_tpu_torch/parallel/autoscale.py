"""Elastic capacity control for the striped batch path and the fleet.

The port's copy of `licensee_tpu/parallel/autoscale.py` (pure Python
over exposition text).  A static ``--stripes N`` is sized once; this
module closes the loop: a small,
pure state machine (:class:`AutoscaleDecider`) watches a pressure
signal — the per-stripe ``pipeline_featurize_busy`` lane gauge for the
batch runner, queue depth / SLO burn for the serving fleet — and
proposes capacity changes under the three rules every production
autoscaler needs:

* **hysteresis** — a threshold crossing must hold for
  ``confirm_ticks`` consecutive observations before it counts (one
  noisy scrape must never move the fleet);
* **cooldown** — after a scale event the decider holds for
  ``cooldown_s`` regardless of pressure (the new capacity needs time
  to show up in the signal it is judged by);
* **bounds** — proposals clamp to ``[min_units, max_units]``, always.

Scale-ups are additionally **payoff-checked**: the decider remembers
the throughput measured before a grow step, and if the next decision
window shows no improvement (``payoff_min``), it steps back and pins a
ceiling at the last paying size — this is what makes a saturated-host
signal (featurize busy sticks at 1.0 no matter how many stripes pile
on) converge to the best static size instead of running away to
``max_units``.  The ceiling unpins when pressure falls back below the
scale-down threshold (the workload changed).

The decider is deliberately process-free: the striped batch runner
(parallel/stripes.py ``--stripes elastic``) and the fleet supervisor
(the fleet tier + :class:`FleetAutoscaler`) own the actual
drain/respawn mechanics and feed observations in.  Freshness of the
scraped per-stripe expositions is the scraper's job:
:class:`ExpositionScraper` reads the atomic ``--prom-file`` dumps and
rejects any file whose ``stripe_scrape_epoch`` gauge has stopped
advancing — the signature of a just-killed (or wedged) stripe whose
last exposition would otherwise be read as live forever.

House rules: monotonic clocks only, nothing printed — callers surface
events through their own channels.
"""

from __future__ import annotations

import re
import time

__all__ = [
    "AutoscaleConfig",
    "AutoscaleDecider",
    "ExpositionScraper",
    "FleetAutoscaler",
    "capacity_plan",
    "parse_exposition_gauges",
]


class AutoscaleConfig:
    """Bounds + control constants for one decider.

    ``up_at``/``down_at`` are pressure thresholds in [0, 1] with
    ``up_at > down_at`` (the hysteresis band between them is the hold
    region); ``confirm_ticks`` is how many consecutive observations a
    crossing must hold; ``cooldown_s`` gates consecutive scale events;
    ``payoff_min`` is the fractional throughput improvement a grow
    step must show to keep its ceiling open (0 disables the check)."""

    def __init__(
        self,
        min_units: int = 1,
        max_units: int = 8,
        *,
        up_at: float = 0.85,
        down_at: float = 0.40,
        confirm_ticks: int = 3,
        cooldown_s: float = 30.0,
        payoff_min: float = 0.05,
    ):
        if min_units < 1:
            raise ValueError(f"min_units must be >= 1, got {min_units!r}")
        if max_units < min_units:
            raise ValueError(
                f"max_units ({max_units!r}) must be >= min_units "
                f"({min_units!r})"
            )
        if not 0.0 <= down_at < up_at <= 1.0:
            raise ValueError(
                f"need 0 <= down_at < up_at <= 1, got "
                f"down_at={down_at!r} up_at={up_at!r}"
            )
        if confirm_ticks < 1:
            raise ValueError(
                f"confirm_ticks must be >= 1, got {confirm_ticks!r}"
            )
        if cooldown_s < 0:
            raise ValueError(
                f"cooldown_s must be >= 0, got {cooldown_s!r}"
            )
        self.min_units = int(min_units)
        self.max_units = int(max_units)
        self.up_at = float(up_at)
        self.down_at = float(down_at)
        self.confirm_ticks = int(confirm_ticks)
        self.cooldown_s = float(cooldown_s)
        self.payoff_min = float(payoff_min)

    def clamp(self, units: int) -> int:
        return max(self.min_units, min(self.max_units, int(units)))


class AutoscaleDecider:
    """The hysteresis/cooldown/bounds state machine.

    ``observe(now, pressure, throughput=None)`` feeds one observation
    and returns the proposed new unit count, or None to hold.  The
    CALLER owns the mechanics of acting on a proposal and must treat a
    returned value as a commitment — the decider's cooldown starts at
    the proposal.  ``pressure`` is the saturation signal in [0, 1]
    (clamped); ``throughput`` (any monotone goodness rate, e.g. rows/s)
    enables the grow payoff check.  Steps are +-1 unit: single-step
    moves plus cooldown are what make convergence observable — the
    signal is re-measured at every size along the way."""

    def __init__(self, config: AutoscaleConfig, units: int):
        self.config = config
        self.units = config.clamp(units)
        self._up_streak = 0
        self._down_streak = 0
        self._last_event_t: float | None = None
        self._last_pressure = 0.0
        self._events_counter = None
        # the grow payoff check: (units before the step, throughput
        # before the step); judged at the next post-cooldown decision
        self._pending_payoff: tuple[int, float] | None = None
        # units above this never pay (measured): pinned by a failed
        # payoff check, unpinned when pressure falls below down_at
        self._ceiling: int | None = None
        self.events: list[dict] = []

    # -- telemetry --

    def register(self, registry) -> "AutoscaleDecider":
        """Publish the decider's live state as gauges/counters on
        ``registry`` (idempotent per registry via set_fn re-pointing)."""
        registry.gauge(
            "autoscale_capacity_units",
            "Current capacity units the autoscaler is running "
            "(stripes + featurize-procs for the batch runner, workers "
            "for the fleet)",
        ).set_fn(lambda: self.units)
        registry.gauge(
            "autoscale_pressure",
            "Last observed saturation pressure in [0, 1] (featurize-"
            "lane occupancy for the batch runner, queue/SLO pressure "
            "for the fleet); up/down thresholds bracket it",
        ).set_fn(lambda: self._last_pressure)
        self._events_counter = registry.counter(
            "autoscale_scale_events_total",
            "Scale events proposed by the autoscaler",
            labels=("direction",),
        )
        return self

    # -- the decision step --

    def _in_cooldown(self, now: float) -> bool:
        return (
            self._last_event_t is not None
            and now - self._last_event_t < self.config.cooldown_s
        )

    def _record(self, now: float, new_units: int, why: str,
                pressure: float) -> int:
        direction = "up" if new_units > self.units else "down"
        self.events.append({
            "t": round(now, 3),
            "from": self.units,
            "to": new_units,
            "why": why,
            "pressure": round(pressure, 4),
        })
        if self._events_counter is not None:
            self._events_counter.labels(direction=direction).inc()
        self.units = new_units
        self._last_event_t = now
        self._up_streak = 0
        self._down_streak = 0
        return new_units

    def observe(
        self,
        now: float,
        pressure: float | None,
        throughput: float | None = None,
    ) -> int | None:
        """One observation; returns the new unit count or None (hold).

        ``pressure=None`` means no fresh signal this tick (every
        exposition was stale): streaks reset — staleness must never
        accumulate toward a scale event."""
        cfg = self.config
        if pressure is None:
            self._up_streak = 0
            self._down_streak = 0
            return None
        pressure = max(0.0, min(1.0, float(pressure)))
        self._last_pressure = pressure
        if self._in_cooldown(now):
            # cooldown holds the fleet steady AND keeps the streak
            # counters quiet: observations during the settle window
            # reflect the old size as much as the new one
            self._up_streak = 0
            self._down_streak = 0
            return None
        # the payoff judgment happens at the first post-cooldown
        # observation that carries a throughput sample: a grow step
        # that didn't raise throughput by payoff_min steps back and
        # pins the ceiling at the size that last paid
        if self._pending_payoff is not None and throughput is not None:
            prev_units, prev_tp = self._pending_payoff
            self._pending_payoff = None
            if prev_tp > 0 and throughput < prev_tp * (
                1.0 + cfg.payoff_min
            ):
                self._ceiling = prev_units
                return self._record(
                    now, prev_units, "grow did not pay; stepping back",
                    pressure,
                )
        if pressure >= cfg.up_at:
            self._down_streak = 0
            self._up_streak += 1
            limit = cfg.max_units
            if self._ceiling is not None:
                limit = min(limit, self._ceiling)
            if self._up_streak >= cfg.confirm_ticks and self.units < limit:
                if throughput is not None and cfg.payoff_min > 0:
                    self._pending_payoff = (self.units, throughput)
                return self._record(
                    now, self.units + 1, "pressure high", pressure
                )
            return None
        if pressure <= cfg.down_at:
            self._up_streak = 0
            self._down_streak += 1
            # low pressure says the workload changed: the measured
            # ceiling no longer describes it
            self._ceiling = None
            self._pending_payoff = None
            if (
                self._down_streak >= cfg.confirm_ticks
                and self.units > cfg.min_units
            ):
                return self._record(
                    now, self.units - 1, "pressure low", pressure
                )
            return None
        # the hold band between down_at and up_at
        self._up_streak = 0
        self._down_streak = 0
        return None


def capacity_plan(
    units: int, *, max_stripes: int, base_featurize_procs: int = 0
) -> tuple[int, int]:
    """Map abstract capacity units to the batch runner's two levers:
    ``(stripes, featurize_procs)``.

    Stripes are the primary lever (each adds a whole pipeline — its
    own serial section, GIL, and writer); once ``max_stripes`` is
    reached, further units become per-stripe ``--featurize-procs``
    (sidecar featurize processes behind each stripe's produce lane).
    ``featurize_procs`` of 0 means "don't forward the flag"."""
    if units < 1:
        raise ValueError(f"units must be >= 1, got {units!r}")
    stripes = min(units, max_stripes)
    extra = units - stripes
    procs = base_featurize_procs + extra if extra else base_featurize_procs
    return stripes, procs


# one exposition sample line with NO labels: `name value` — the lane
# gauges and the epoch stamp are unlabeled by construction, so the
# scraper needs nothing fancier (labeled series pass through unparsed)
_BARE_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"([+-]?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf|inf)|NaN|nan)$"
)


def parse_exposition_gauges(text: str) -> dict[str, float]:
    """{name: value} for every UNLABELED sample in a Prometheus text
    exposition (last sample wins).  Comments, labeled series, and
    malformed lines are skipped — a torn or foreign file parses to
    fewer keys, never to an exception."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        m = _BARE_SAMPLE_RE.match(line)
        if m is None:
            continue
        try:
            out[m.group(1)] = float(m.group(2))
        except ValueError:
            continue
    return out


class ExpositionScraper:
    """Freshness-checked reads of the per-stripe ``--prom-file`` dumps.

    Each worker's heartbeat atomically rewrites its exposition with a
    monotonically increasing ``stripe_scrape_epoch`` gauge;
    ``sample(key, path, now)`` returns the parsed gauges only while
    that epoch keeps advancing.  A file whose epoch has not moved for
    ``stale_after_s`` belongs to a dead, wedged, or not-yet-started
    incarnation and reads as None — the decider then sees "no signal",
    never a frozen lane snapshot from a just-killed stripe.

    With a fleet telemetry store attached (``store=``, a
    the JAX package's ``obs.tsdb.TsdbStore``), ``sample_store``
    offers the same occupancy signal without a file in the path: the
    router's scrape scheduler already ingests every worker's gauges
    under per-worker labels, so the autoscaler can read the stored
    samples directly.  The file path stays — the striped batch runner
    has no router and keeps scraping ``--prom-file`` dumps."""

    def __init__(self, stale_after_s: float = 10.0, *, store=None):
        if stale_after_s <= 0:
            raise ValueError(
                f"stale_after_s must be > 0, got {stale_after_s!r}"
            )
        self.stale_after_s = float(stale_after_s)
        self.store = store
        # key -> (last epoch seen, monotonic time the epoch last moved)
        self._seen: dict[str, tuple[float, float]] = {}

    def forget(self, key: str) -> None:
        """Drop a key's epoch history (its worker was retired — a
        respawn under the same key starts a fresh freshness clock)."""
        self._seen.pop(key, None)

    def sample(
        self, key: str, path: str, now: float | None = None
    ) -> dict[str, float] | None:
        now = time.perf_counter() if now is None else now
        try:
            with open(path, encoding="utf-8") as f:
                gauges = parse_exposition_gauges(f.read())
        except OSError:
            return None
        epoch = gauges.get("stripe_scrape_epoch")
        if epoch is None:
            # no heartbeat stamp: a final merge-input dump or a foreign
            # file — not a live scrape target
            return None
        last = self._seen.get(key)
        if last is None or epoch != last[0]:
            self._seen[key] = (epoch, now)
            return gauges
        if now - last[1] > self.stale_after_s:
            return None
        return gauges

    def sample_store(
        self,
        labels: dict,
        now: float | None = None,
        *,
        names: tuple = ("pipeline_featurize_busy",),
    ) -> dict[str, float] | None:
        """Store-backed twin of ``sample``: each named gauge's freshest
        stored sample carrying ``labels`` (the scrape scheduler's
        per-worker ingest labels).  Freshness is the sample's own
        timestamp — a series that stopped advancing reads as None
        exactly like a frozen ``--prom-file`` epoch.  Timestamps live
        in the store's clock domain (``time.monotonic``), so a passed
        ``now`` must too; None reads that clock."""
        if self.store is None:
            return None
        now = time.monotonic() if now is None else now
        out: dict[str, float] = {}
        for name in names:
            hit = self.store.latest(name, labels)
            if hit is None or now - hit[0] > self.stale_after_s:
                continue
            out[name] = hit[1]
        return out or None


class FleetAutoscaler:
    """Queue-depth / SLO-burn worker scaling for the serving fleet.

    Wraps a fleet supervisor (``add_worker``/``remove_worker``; the
    port's fleet tier is still to come): ``tick()`` reads every
    worker's last stats probe (scheduler queue depth + in flight),
    folds in the SLO engine's burn alerts as a pressure floor, feeds
    the decider,
    and acts on proposals through ``supervisor.add_worker`` /
    ``remove_worker``.  ``socket_for(index)`` names each elastic
    worker's socket; elastic workers are named ``{prefix}{index}`` and
    retire newest-first (the static seed workers are never removed).

    ``slo_snapshot`` is an optional zero-arg callable returning the
    engine's evaluation dict (``SLOEngine.last``-shaped): any
    objective's ``fast_burn_alert`` pins pressure to 1.0 — burning the
    error budget at page rate IS saturation, whatever the queues say
    — and ``slow_burn_alert`` floors it at the up threshold."""

    def __init__(
        self,
        supervisor,
        config: AutoscaleConfig,
        socket_for,
        *,
        target_inflight_per_worker: int = 8,
        slo_snapshot=None,
        name_prefix: str = "auto",
        on_event=None,
    ):
        if target_inflight_per_worker < 1:
            raise ValueError(
                "target_inflight_per_worker must be >= 1, got "
                f"{target_inflight_per_worker!r}"
            )
        self.supervisor = supervisor
        self.socket_for = socket_for
        self.target_inflight = int(target_inflight_per_worker)
        self.slo_snapshot = slo_snapshot
        self.name_prefix = name_prefix
        self._on_event = on_event
        base = len(supervisor.workers)
        # the static seed fleet is the floor: the autoscaler only
        # manages the workers it added
        config = AutoscaleConfig(
            min_units=max(config.min_units, base),
            max_units=max(config.max_units, base),
            up_at=config.up_at,
            down_at=config.down_at,
            confirm_ticks=config.confirm_ticks,
            cooldown_s=config.cooldown_s,
            payoff_min=0.0,  # fleet adds capacity per worker linearly
        )
        self.decider = AutoscaleDecider(config, base)
        self._elastic: list[str] = []
        self._next_index = 0

    def _event(self, message: str) -> None:
        if self._on_event is not None:
            self._on_event(message)

    def pressure(self) -> float | None:
        """The fleet's saturation signal in [0, 1]: mean outstanding
        work (queue depth + in flight) per worker against the target,
        floored by the SLO burn alerts."""
        depths = []
        for handle in self.supervisor.workers.values():
            sched = (handle.last_stats or {}).get("scheduler") or {}
            queue = sched.get("queue_depth")
            inflight = sched.get("in_flight")
            if queue is None and inflight is None:
                continue
            depths.append((queue or 0) + (inflight or 0))
        if not depths:
            return None
        load = sum(depths) / len(depths) / self.target_inflight
        p = min(1.0, load)
        snap = self.slo_snapshot() if self.slo_snapshot is not None else None
        for row in ((snap or {}).get("objectives") or {}).values():
            if row.get("fast_burn_alert"):
                return 1.0
            if row.get("slow_burn_alert"):
                p = max(p, self.decider.config.up_at)
        return p

    def tick(self, now: float | None = None) -> int | None:
        """One control step; returns the new worker count if a scale
        event fired, else None."""
        now = time.perf_counter() if now is None else now
        proposal = self.decider.observe(now, self.pressure())
        if proposal is None:
            return None
        current = len(self.supervisor.workers)
        if proposal > current:
            name = f"{self.name_prefix}{self._next_index}"
            self._next_index += 1
            self.supervisor.add_worker(name, self.socket_for(name))
            self._elastic.append(name)
            self._event(
                f"autoscale: +1 worker ({name}) -> {proposal} "
                f"(pressure {self.decider._last_pressure:.2f})"
            )
        elif proposal < current and self._elastic:
            name = self._elastic.pop()
            self.supervisor.remove_worker(name)
            self._event(
                f"autoscale: -1 worker ({name}) -> {proposal} "
                f"(pressure {self.decider._last_pressure:.2f})"
            )
        return proposal
