"""In-process selftest of the observability layer — the
`licensee-tpu-torch stats --selftest` CI smoke.

Deliberately device-free and corpus-free (the serve selftest already
covers the integrated path): this checks the obs substrate itself —
registry math, exposition grammar, tracer retention (head sampling +
slow exemplars + bounded JSONL log), and the native-profile delta
scrape (two scrapes must not double-count).  Runs in milliseconds.

House rule exception note: this module REPORTS via an explicit stream
argument (stderr by default), honoring the obs/ no-print lint rule.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

from licensee_tpu_torch.obs import (
    AnomalyWatchdog,
    MetricsRegistry,
    NativeProfileSource,
    Observability,
    QueryError,
    RateJumpRule,
    Tracer,
    TsdbStore,
    check_exposition,
    render_prometheus,
)


def selftest(stream=None) -> int:
    stream = sys.stderr if stream is None else stream
    problems: list[str] = []

    # -- registry math --
    reg = MetricsRegistry()
    c = reg.counter("t_events_total", "events", labels=("kind",))
    c.labels(kind="a").inc()
    c.labels(kind="a").inc(2)
    c.labels(kind="b").inc()
    if c.labels(kind="a").value != 3 or c.labels(kind="b").value != 1:
        problems.append(f"counter math: {c.samples()}")
    g = reg.gauge("t_depth", "depth")
    g.set(7)
    if g.value != 7:
        problems.append(f"gauge set: {g.value}")
    pulled = reg.gauge("t_pulled", "pull gauge")
    pulled.set_fn(lambda: 41 + 1)
    if pulled.value != 42:
        problems.append(f"gauge pull: {pulled.value}")
    h = reg.histogram("t_lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    hv = h.value
    if hv["count"] != 4 or hv["buckets"]["+Inf"] != 4 or hv["buckets"]["0.01"] != 1:
        problems.append(f"histogram buckets: {hv}")
    if reg.counter("t_events_total", labels=("kind",)) is not c:
        problems.append("registry re-registration is not idempotent")
    try:
        reg.gauge("t_events_total")
        problems.append("kind mismatch not rejected")
    except ValueError:
        pass

    # -- exposition grammar --
    text = render_prometheus(reg)
    grammar = check_exposition(text)
    if not text or grammar:
        problems.append(f"exposition grammar: {grammar[:3]}")
    for needle in (
        "# TYPE t_events_total counter",
        't_events_total{kind="a"} 3',
        't_lat_seconds_bucket{le="+Inf"} 4',
        "t_lat_seconds_count 4",
    ):
        if needle not in text:
            problems.append(f"exposition missing {needle!r}")

    # -- tracer: head sampling stride + always-captured slow exemplars --
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "trace.jsonl")
        tracer = Tracer(
            sample_rate=0.5, slow_ms=40.0, capacity=8, log_path=log
        )
        kept = 0
        for i in range(4):  # stride 2: traces 2 and 4 retained
            t = tracer.start(request_id=i)
            t.add_span("featurize", 0.001)
            kept += tracer.finish(t)
        if kept != 2:
            problems.append(f"head sampling kept {kept}, want 2")
        slow = tracer.start(request_id="slow")
        slow.sampled = False  # force retention to come from slowness alone
        slow.add_span("device", 0.05)
        time.sleep(0.05)
        if not tracer.finish(slow):
            problems.append("slow exemplar not retained")
        tail = tracer.tail(10)
        if not tail or tail[-1]["id"] != "slow":
            problems.append(f"trace tail: {tail}")
        try:
            with open(log, encoding="utf-8") as f:
                logged = [json.loads(line) for line in f]
        except OSError:
            logged = []
        if len(logged) != 1 or logged[0]["id"] != "slow" or not logged[0]["slow"]:
            problems.append(f"exemplar log: {logged}")

    # -- native profile deltas: two scrapes must not double-count --
    cumulative = {"stage.normalize_s": 1.5, "count.blobs": 10.0}
    reg2 = MetricsRegistry()
    NativeProfileSource(reg2, dump_fn=lambda: dict(cumulative))
    reg2.snapshot()
    reg2.snapshot()  # no new work in between
    blobs = (
        reg2.counter("native_featurize_events_total", labels=("kind",))
        .labels(kind="blobs")
        .value
    )
    if blobs != 10.0:
        problems.append(f"profile delta double-counted: {blobs}")
    cumulative["count.blobs"] = 25.0
    reg2.snapshot()
    blobs = (
        reg2.counter("native_featurize_events_total", labels=("kind",))
        .labels(kind="blobs")
        .value
    )
    if blobs != 25.0:
        problems.append(f"profile delta lost an increment: {blobs}")

    # -- telemetry store: ingest -> downsample -> query round trip --
    fake_t = [1000.0]
    store = TsdbStore(
        fine_step_s=1.0, fine_len=10, coarse_step_s=5.0, coarse_len=20,
        clock=lambda: fake_t[0],
    )
    for i in range(40):
        # 40 samples through a 10-deep fine ring: 30 of them MUST
        # survive by folding into the coarse ring, or the rate below
        # has no window to stand on
        store.ingest("t_req_total", {"worker": "w0"}, float(i),
                     ts=1000.0 + i)
    fake_t[0] = 1039.0
    rate = store.rate("t_req_total", {"worker": "w0"}, window_s=39.0)
    if rate is None or abs(rate - 1.0) > 0.2:
        problems.append(f"tsdb rate after downsample: {rate}")
    raw = store.query({
        "series": "t_req_total", "fn": "raw", "window": 39.0,
    })
    if len(raw.get("points") or []) <= 10:
        problems.append(
            f"tsdb downsample lost history: {len(raw.get('points') or [])}"
        )
    try:
        store.query({"series": "t_absent_total", "fn": "latest"})
        problems.append("tsdb unknown_series not raised")
    except QueryError as exc:
        if exc.code != "unknown_series":
            problems.append(f"tsdb query error code: {exc.code}")

    # -- exemplars: histogram -> exposition -> store -> quantile --
    reg3 = MetricsRegistry()
    h3 = reg3.histogram("t_rt_seconds", "rt", buckets=(0.01, 0.1, 1.0))
    h3.observe(0.005)
    h3.observe(0.25, exemplar="deadbeefcafef00d")
    store.ingest_exposition(
        render_prometheus(reg3), extra_labels={"worker": "w0"},
        ts=1040.0,
    )
    h3.observe(0.5, exemplar="feedfacefeedface")
    store.ingest_exposition(
        render_prometheus(reg3), extra_labels={"worker": "w0"},
        ts=1045.0,
    )
    fake_t[0] = 1045.0
    q_row = store.query({
        "series": "t_rt_seconds", "fn": "quantile", "q": 0.99,
        "window": 10.0,
    })
    q_value = q_row.get("value")
    if q_value is None or not 0.1 < q_value <= 1.0:
        problems.append(f"tsdb quantile: {q_row}")
    ex = q_row.get("exemplar") or {}
    if ex.get("trace_id") != "feedfacefeedface":
        problems.append(f"tsdb exemplar round trip: {ex}")

    # -- anomaly watchdog: a forced 50x rate jump fires exactly once
    # and clears after recovery --
    fake2 = [0.0]
    store2 = TsdbStore(fine_len=400, clock=lambda: fake2[0])
    v = 0.0
    for i in range(101):  # steady 1/s baseline
        store2.ingest("t_jump_total", value=v, ts=float(i))
        v += 1.0
    rule = RateJumpRule(
        "t_jump", "t_jump_total", window_s=10.0, baseline_windows=4,
        min_baseline=3, z_threshold=4.0,
    )
    wd = AnomalyWatchdog(
        store2, [rule], hold_ticks=1, clear_ticks=2,
        clock=lambda: fake2[0],
    )
    fake2[0] = 100.0
    wd.evaluate()
    if wd.active():
        problems.append(f"watchdog fired on steady traffic: {wd.active()}")
    for i in range(101, 121):  # the fault: 50/s
        store2.ingest("t_jump_total", value=v, ts=float(i))
        v += 50.0
    fake2[0] = 120.0
    wd.evaluate()
    if not wd.active():
        problems.append("watchdog missed a 50x rate jump")
    for i in range(121, 181):  # recovery: steady 1/s again
        store2.ingest("t_jump_total", value=v, ts=float(i))
        v += 1.0
    for t in (150.0, 165.0, 180.0):
        fake2[0] = t
        wd.evaluate()
    if wd.active():
        problems.append(f"watchdog failed to clear: {wd.active()}")
    if wd.snapshot()["fired_total"] != 1:
        problems.append(
            f"watchdog fired_total: {wd.snapshot()['fired_total']}"
        )

    # -- Observability bundle: uptime gauge + merged snapshot shape --
    obs = Observability(tracing=True, trace_sample=1.0)
    snap = obs.snapshot()
    if "process_uptime_seconds" not in snap["metrics"]:
        problems.append("bundle missing process_uptime_seconds")
    if "tracing" not in snap or "started" not in snap["tracing"]:
        problems.append(f"bundle tracing stats: {snap.get('tracing')}")

    stream.write(
        json.dumps(
            {
                "obs_selftest": "ok" if not problems else "FAIL",
                "problems": problems,
            }
        )
        + "\n"
    )
    return 0 if not problems else 1


if __name__ == "__main__":
    sys.exit(selftest())
