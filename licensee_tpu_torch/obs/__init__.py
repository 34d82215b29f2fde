"""Unified observability layer: metrics registry + request tracing +
exporters, shared by the online serve path, the offline batch path, and
the native/device layers.

One ``Observability`` bundle holds a :class:`MetricsRegistry` and a
:class:`Tracer`; every subsystem reports through it and the exporters
(Prometheus text exposition, trace tail) read from it.  See
obs/registry.py, obs/tracing.py, obs/export.py for the pieces.
"""

from __future__ import annotations

import time

from licensee_tpu_torch.obs.export import (
    NativeProfileSource,
    check_exposition,
    merge_expositions,
    render_prometheus,
)
from licensee_tpu_torch.obs.registry import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from licensee_tpu_torch.obs.collect import (
    TraceCollector,
    assemble_rows,
    assemble_trace,
    render_tree,
)
from licensee_tpu_torch.obs.flight import (
    FlightRecorder,
    flight_path_for_socket,
    load_flight_dump,
)
from licensee_tpu_torch.obs.pipeline import PipelineLanes
from licensee_tpu_torch.obs.anomaly import (
    AnomalyWatchdog,
    FlatlineRule,
    RateJumpRule,
    SaturationRule,
)
from licensee_tpu_torch.obs.tsdb import (
    QueryError,
    ScrapeScheduler,
    TsdbStore,
)
from licensee_tpu_torch.obs.slo import (
    SLOEngine,
    pool_objectives,
    router_objectives,
    serve_objectives,
)
from licensee_tpu_torch.obs.tracing import (
    NullTracer,
    Trace,
    Tracer,
    get_tracer,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "Trace", "Tracer", "NullTracer", "get_tracer",
    "render_prometheus", "check_exposition", "merge_expositions",
    "NativeProfileSource", "PipelineLanes",
    "TraceCollector", "assemble_rows", "assemble_trace", "render_tree",
    "FlightRecorder", "flight_path_for_socket", "load_flight_dump",
    "SLOEngine", "serve_objectives", "router_objectives",
    "pool_objectives",
    "TsdbStore", "ScrapeScheduler", "QueryError",
    "AnomalyWatchdog", "RateJumpRule", "FlatlineRule", "SaturationRule",
    "DEFAULT_LATENCY_BUCKETS", "Observability",
]


class Observability:
    """Registry + tracer + process uptime, as one attachable unit.

    ``tracing=False`` swaps in a NullTracer — span calls become no-ops
    and the serve fast path pays one ``is None`` branch."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        *,
        tracing: bool = True,
        trace_sample: float = 0.01,
        trace_slow_ms: float = 250.0,
        trace_log: str | None = None,
        trace_capacity: int = 256,
        trace_proc: str = "local",
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = (
            Tracer(
                sample_rate=trace_sample,
                slow_ms=trace_slow_ms,
                capacity=trace_capacity,
                log_path=trace_log,
                proc=trace_proc,
            )
            if tracing
            else NullTracer()
        )
        self._t0 = time.perf_counter()
        self.registry.gauge(
            "process_uptime_seconds",
            "Seconds since this Observability was attached (monotonic)",
        ).set_fn(lambda: time.perf_counter() - self._t0)

    def uptime_s(self) -> float:
        return round(time.perf_counter() - self._t0, 3)

    def snapshot(self) -> dict:
        """Metrics + tracer summary — the machine-readable scrape the
        extended ``stats`` verb and ``details.obs`` bench key carry."""
        return {
            "uptime_s": self.uptime_s(),
            "metrics": self.registry.snapshot(),
            "tracing": self.tracer.stats(),
        }

    def prometheus(self) -> str:
        return render_prometheus(self.registry)
