"""Anomaly watchdog: declarative rules over the telemetry store.

The store (obs/tsdb.py) retains the fleet's history; this module turns
that history into bounded, structured alerts — the "page a human"
layer the ``licensee-tpu-torch alerts`` CLI, the ``alerts_active`` gauge, and
the flight-recorder ring all read from.  Three rule shapes cover the
failure modes the fleet has actually hit:

* :class:`RateJumpRule` — sustained jump of a rate or stored-histogram
  quantile vs its own trailing baseline, judged by a robust MAD z-score
  (median/MAD, not mean/stddev: one prior spike in the baseline must
  not raise the bar for the next one).
* :class:`FlatlineRule` — a heartbeat series stopped moving (a worker
  the scrape scheduler can no longer reach flatlines its series even
  though the gauge itself would still read fine).
* :class:`SaturationRule` — a bounded occupancy gauge (``pipeline_*_busy``,
  ``edge_queue_depth``) sits at/above a threshold — the approach-to-
  saturation warning that fires BEFORE queues overflow.

:class:`AnomalyWatchdog` evaluates the rules each scrape round with
fire/clear hysteresis (``hold_ticks`` consecutive breaches to fire,
``clear_ticks`` clean rounds to clear), so one noisy window neither
pages nor flaps.  Transitions append to a bounded history ring and —
when a :class:`~licensee_tpu_torch.obs.flight.FlightRecorder` is attached —
into the crash-harvestable flight ring as ``alert`` events.

House rules (script/lint): monotonic clocks only, no print.
"""

from __future__ import annotations

import time

__all__ = [
    "Rule",
    "RateJumpRule",
    "FlatlineRule",
    "SaturationRule",
    "AnomalyWatchdog",
]


def _median(values: list) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return float(ordered[mid])
    return (ordered[mid - 1] + ordered[mid]) / 2.0


class Rule:
    """One declarative condition over stored series.  Subclasses
    implement ``evaluate(store, now) -> (breached, detail)`` — the raw
    per-round verdict; hysteresis lives in the watchdog."""

    kind = "rule"

    def __init__(
        self, name: str, series: str, *,
        labels: dict | None = None, description: str = "",
    ):
        self.name = name
        self.series = series
        self.labels = dict(labels or {})
        self.description = description

    def evaluate(self, store, now: float):  # pragma: no cover - abstract
        raise NotImplementedError

    def spec(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "series": self.series,
            "labels": self.labels,
            "description": self.description,
        }


class RateJumpRule(Rule):
    """Sustained jump vs trailing baseline, robust-z judged.

    ``signal`` is ``"rate"`` (per-second increase of a counter) or
    ``"quantile"`` (histogram quantile ``q`` over ``{series}_bucket``).
    The current window's signal is compared against the signals of the
    ``baseline_windows`` windows before it: z = 0.6745 * (x - median) /
    MAD (the 0.6745 scales MAD to a stddev-equivalent under normality).
    MAD is floored at 5% of the median so a dead-flat baseline (stub
    fleets) cannot make every wiggle infinite-sigma; ``min_value`` is an
    absolute floor the current signal must also clear.

    On first breach the rule ANCHORS the clean baseline it fired
    against: while breached, the signal is judged vs that frozen anchor
    (at half the fire threshold, for hysteresis), not vs the trailing
    windows — otherwise a sustained fault bleeds into its own baseline
    and the alert self-clears while the fault is still live."""

    kind = "rate_jump"

    def __init__(
        self, name: str, series: str, *,
        labels: dict | None = None, description: str = "",
        signal: str = "rate", q: float = 0.99,
        window_s: float = 30.0, baseline_windows: int = 8,
        min_baseline: int = 3, z_threshold: float = 4.5,
        min_value: float = 0.0,
    ):
        super().__init__(
            name, series, labels=labels, description=description
        )
        if signal not in ("rate", "quantile"):
            raise ValueError(f"unknown signal {signal!r}")
        self.signal = signal
        self.q = float(q)
        self.window_s = float(window_s)
        self.baseline_windows = int(baseline_windows)
        self.min_baseline = int(min_baseline)
        self.z_threshold = float(z_threshold)
        self.min_value = float(min_value)
        self._anchor = None  # (median, scale) frozen at first breach

    def _signal(self, store, end: float):
        if self.signal == "rate":
            return store.rate(
                self.series, self.labels, window_s=self.window_s, now=end
            )
        value, _ = store.quantile(
            self.q, self.series, self.labels,
            window_s=self.window_s, now=end,
        )
        return value

    def evaluate(self, store, now: float):
        current = self._signal(store, now)
        if current is None:
            self._anchor = None
            return False, {}
        if self._anchor is not None:
            # previously breached: judge vs the FROZEN pre-fault
            # baseline at half threshold, so a long fault cannot bleed
            # into its own baseline and self-clear mid-fault
            med, scale = self._anchor
            z = 0.6745 * (current - med) / scale
            breached = (
                z >= self.z_threshold / 2.0
                and current >= self.min_value
            )
            if not breached:
                self._anchor = None
            return breached, {
                "current": round(current, 6),
                "baseline_median": round(med, 6),
                "z": round(z, 2),
                "anchored": True,
            }
        baseline = []
        for i in range(1, self.baseline_windows + 1):
            value = self._signal(store, now - i * self.window_s)
            if value is not None:
                baseline.append(value)
        if len(baseline) < self.min_baseline:
            return False, {
                "current": round(current, 6),
                "baseline_n": len(baseline),
            }
        med = _median(baseline)
        mad = _median([abs(v - med) for v in baseline])
        scale = max(mad, 0.05 * abs(med), 1e-9)
        z = 0.6745 * (current - med) / scale
        breached = z >= self.z_threshold and current >= self.min_value
        if breached:
            self._anchor = (med, scale)
        return breached, {
            "current": round(current, 6),
            "baseline_median": round(med, 6),
            "mad": round(mad, 9),
            "z": round(z, 2),
        }


class FlatlineRule(Rule):
    """A heartbeat series exists but stopped producing samples."""

    kind = "flatline"

    def __init__(
        self, name: str, series: str, *,
        labels: dict | None = None, description: str = "",
        stale_after_s: float = 15.0,
    ):
        super().__init__(
            name, series, labels=labels, description=description
        )
        self.stale_after_s = float(stale_after_s)

    def evaluate(self, store, now: float):
        hit = store.latest(self.series, self.labels)
        if hit is None:
            return False, {}  # never seen: absence is not a flatline
        age = now - hit[0]
        return age > self.stale_after_s, {
            "age_s": round(age, 3),
            "stale_after_s": self.stale_after_s,
        }


class SaturationRule(Rule):
    """A bounded occupancy gauge is at/above its saturation line."""

    kind = "saturation"

    def __init__(
        self, name: str, series: str, *,
        labels: dict | None = None, description: str = "",
        threshold: float = 0.9,
    ):
        super().__init__(
            name, series, labels=labels, description=description
        )
        self.threshold = float(threshold)

    def evaluate(self, store, now: float):
        hit = store.latest(self.series, self.labels)
        if hit is None:
            return False, {}
        return hit[1] >= self.threshold, {
            "current": round(hit[1], 6),
            "threshold": self.threshold,
        }


class AnomalyWatchdog:
    """Evaluates a rule set against the store with hysteresis and emits
    bounded transition events (history ring, optional flight ring,
    ``alerts_active`` gauge)."""

    def __init__(
        self,
        store,
        rules,
        *,
        registry=None,
        flight=None,
        hold_ticks: int = 2,
        clear_ticks: int = 2,
        history_len: int = 64,
        clock=time.monotonic,
    ):
        self.store = store
        self.rules = list(rules)
        self.flight = flight
        self.hold_ticks = int(hold_ticks)
        self.clear_ticks = int(clear_ticks)
        self._clock = clock
        self._history: list[dict] = []
        self._history_len = int(history_len)
        self._state = {
            rule.name: {
                "breach_streak": 0,
                "clear_streak": 0,
                "firing": False,
                "since": 0.0,
                "detail": {},
            }
            for rule in self.rules
        }
        self._evaluations = 0
        self._fired_total = 0
        if registry is not None:
            self.register_metrics(registry)

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One hysteresis round over every rule; returns the transition
        events (``state`` firing/cleared) this round produced."""
        if now is None:
            now = self._clock()
        transitions: list[dict] = []
        for rule in self.rules:
            try:
                breached, detail = rule.evaluate(self.store, now)
            except Exception:  # noqa: BLE001 — a rule bug must not kill the watchdog round
                breached, detail = False, {}
            st = self._state[rule.name]
            if breached:
                st["breach_streak"] += 1
                st["clear_streak"] = 0
                st["detail"] = detail
                if (
                    not st["firing"]
                    and st["breach_streak"] >= self.hold_ticks
                ):
                    st["firing"] = True
                    st["since"] = now
                    self._fired_total += 1
                    transitions.append(
                        self._transition(rule, "firing", now, detail)
                    )
            else:
                st["clear_streak"] += 1
                st["breach_streak"] = 0
                if (
                    st["firing"]
                    and st["clear_streak"] >= self.clear_ticks
                ):
                    st["firing"] = False
                    transitions.append(
                        self._transition(rule, "cleared", now, detail)
                    )
        self._evaluations += 1
        return transitions

    def _transition(
        self, rule: Rule, state: str, now: float, detail: dict
    ) -> dict:
        event = {
            "ts": round(now, 3),
            "rule": rule.name,
            "kind": rule.kind,
            "series": rule.series,
            "state": state,
            "detail": detail,
        }
        self._history.append(event)
        del self._history[: -self._history_len]
        if self.flight is not None:
            self.flight.record(
                "alert", rule=rule.name, state=state, series=rule.series
            )
        return event

    def active(self, now: float | None = None) -> list[dict]:
        if now is None:
            now = self._clock()
        out = []
        for rule in self.rules:
            st = self._state[rule.name]
            if st["firing"]:
                out.append({
                    "rule": rule.name,
                    "kind": rule.kind,
                    "series": rule.series,
                    "since_s": round(now - st["since"], 3),
                    "detail": st["detail"],
                    "description": rule.description,
                })
        return out

    def snapshot(self) -> dict:
        return {
            "active": self.active(),
            "history": list(self._history),
            "rules": [rule.spec() for rule in self.rules],
            "evaluations": self._evaluations,
            "fired_total": self._fired_total,
        }

    def register_metrics(self, registry) -> None:
        registry.gauge(
            "alerts_active", "Watchdog rules currently firing"
        ).set_fn(
            lambda: sum(
                1 for st in self._state.values() if st["firing"]
            )
        )
        fired = registry.counter(
            "alerts_fired_total", "Watchdog alerts fired since start"
        )
        registry.add_collector(
            lambda _reg: fired.sync(float(self._fired_total))
        )
