"""The port's telemetry plane against the JAX package's, on the CPU.

The same seeded inputs go through `licensee_tpu.obs` and the port's
copy: the metrics store (`TsdbStore`: a stream of text expositions from
two workers, with counter resets, gauges and histograms with exemplars,
ingested at the same timestamps, then every query function, grouping,
the raw points, the downsampled history and each `QueryError`), the
anomaly rules under the watchdog's hysteresis (the same firing and
clearing sequence on the same series), the trace assembly
(`assemble_rows`, `assemble_trace`, `render_tree` and the
`TraceCollector` on the same span rows) and `stats --selftest`.  Every
comparison is equality: both sides are the same arithmetic in Python.
Then the verbs that read a live fleet (`stats` as JSON, exposition and
merged table, `traces`, `slo`, `top` and `alerts`): the port's and the
JAX package's CLI against a JAX stub fleet and against the port's, and
the port's verb on the port's fleet against the JAX verb on the JAX
fleet, with the numbers, trace IDs and program names masked."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest

import licensee_tpu.obs as jax_obs
import licensee_tpu_torch.obs as obs
from licensee_tpu.cli.main import main as jax_main
from licensee_tpu_torch.cli.main import main as port_main

T_END = 160.0  # the streams' last timestamp, the stores' clock after it
WORKERS = ("w0", "w1")


def exposition_stream(seed: int) -> list:
    """[(ts, worker, exposition text)]: two workers' registries scraped
    every second, their counters stepping by seeded amounts (w1's reset
    at t=90, a restart), a gauge wandering, a histogram observing seeded
    latencies with an exemplar each tenth."""
    rng = np.random.default_rng(seed)
    out = []
    regs = {w: obs.MetricsRegistry() for w in WORKERS}
    fams = {}
    for w, reg in regs.items():
        fams[w] = (
            reg.counter("serve_requests_total", "requests",
                        labels=("event",)),
            reg.gauge("serve_queue_depth", "queue"),
            reg.histogram("serve_stage_seconds", "stages",
                          labels=("stage",), buckets=(0.005, 0.05, 0.25, 1.0)),
        )
    for t in range(int(T_END) + 1):
        for w in WORKERS:
            if w == "w1" and t == 90:
                reg = regs[w] = obs.MetricsRegistry()
                fams[w] = (
                    reg.counter("serve_requests_total", "requests",
                                labels=("event",)),
                    reg.gauge("serve_queue_depth", "queue"),
                    reg.histogram("serve_stage_seconds", "stages",
                                  labels=("stage",),
                                  buckets=(0.005, 0.05, 0.25, 1.0)),
                )
            counter, gauge, hist = fams[w]
            burst = 40.0 if 110 <= t < 125 else 1.0
            counter.labels(event="completed").inc(
                float(rng.integers(0, 20)) * burst)
            counter.labels(event="error").inc(float(rng.integers(0, 2)))
            gauge.set(float(rng.integers(0, 64)))
            for i in range(int(rng.integers(1, 6))):
                value = float(rng.exponential(0.3 if burst > 1 else 0.02))
                exemplar = (f"{int(rng.integers(0, 2**63)):016x}"
                            if i == 0 and t % 10 == 0 else None)
                hist.labels(stage="total").observe(value, exemplar=exemplar)
            out.append((float(t), w, obs.render_prometheus(regs[w])))
    return out


def stores(stream) -> tuple:
    """(JAX store, port store) fed the same stream, small rings so the
    fine ring folds into the coarse one."""
    kwargs = dict(fine_step_s=1.0, fine_len=40, coarse_step_s=5.0,
                  coarse_len=60)
    jax_store = jax_obs.TsdbStore(clock=lambda: T_END, **kwargs)
    port_store = obs.TsdbStore(clock=lambda: T_END, **kwargs)
    for ts, w, text in stream:
        n = jax_store.ingest_exposition(text, {"worker": w}, ts=ts)
        assert port_store.ingest_exposition(text, {"worker": w}, ts=ts) == n
    return jax_store, port_store


@pytest.fixture(scope="module")
def stream():
    return exposition_stream(seed=0)


@pytest.fixture(scope="module")
def both_stores(stream):
    return stores(stream)


def test_exposition_samples_match_jax(stream):
    for _ts, _w, text in stream[::37]:
        got = list(obs.tsdb.parse_exposition_samples(text))
        assert got == list(jax_obs.tsdb.parse_exposition_samples(text))
        assert got


QUERIES = [
    {"series": "serve_requests_total", "fn": "rate", "window": 30},
    {"series": "serve_requests_total", "fn": "rate", "window": 150,
     "labels": {"event": "completed"}, "by": "worker"},
    {"series": "serve_requests_total", "fn": "delta", "window": 100,
     "labels": {"worker": "w1", "event": "completed"}},
    {"series": "serve_requests_total", "fn": "raw", "window": 150,
     "limit": 500, "labels": {"worker": "w1", "event": "error"}},
    {"series": "serve_requests_total", "fn": "raw", "window": 20,
     "limit": 7},
    {"series": "serve_queue_depth", "fn": "latest", "by": "worker"},
    {"series": "serve_queue_depth", "fn": "raw", "window": 1000},
    {"series": "serve_stage_seconds", "fn": "quantile", "q": 0.99,
     "window": 30, "by": "worker"},
    {"series": "serve_stage_seconds", "fn": "quantile", "q": 0.5,
     "window": 120, "labels": {"stage": "total"}},
    {"series": "serve_stage_seconds", "fn": "quantile", "q": 0.99,
     "window": 10, "labels": {"worker": "w0"}},
    {"list": True},
    {"list": True, "match": "serve_stage"},
    # the refusals, each with its code and message
    {"series": "absent_total", "fn": "latest"},
    {"series": "serve_queue_depth", "fn": "nope"},
    {"fn": "rate"},
    {"series": "serve_queue_depth", "labels": ["w0"]},
    {"series": "serve_queue_depth", "window": "soon"},
    {"series": "serve_queue_depth", "by": 3},
    {"series": "serve_requests_total", "fn": "raw", "limit": "x"},
    {"series": "serve_stage_seconds", "fn": "quantile", "q": "x"},
    {"series": "serve_stage_seconds", "fn": "quantile", "q": 1.5},
    {"series": "serve_queue_depth", "labels": {"worker": "w9"}},
]


def answer(store, params):
    try:
        return ("ok", store.query(params))
    except Exception as exc:  # noqa: BLE001 — compared, type and text
        return (type(exc).__name__, getattr(exc, "code", None), str(exc))


@pytest.mark.parametrize("params", QUERIES, ids=range(len(QUERIES)))
def test_tsdb_query_matches_jax(both_stores, params):
    jax_store, port_store = both_stores
    want = answer(jax_store, params)
    assert answer(port_store, params) == want
    assert want[0] in ("ok", "QueryError")


def test_tsdb_derivations_and_stats_match_jax(both_stores):
    jax_store, port_store = both_stores
    assert port_store.stats() == jax_store.stats()
    for now in np.arange(20.0, T_END + 1, 7.0):
        for labels in ({"worker": "w0"}, {"worker": "w1"}, None):
            assert port_store.rate("serve_requests_total", labels, 20.0,
                                   now) == jax_store.rate(
                "serve_requests_total", labels, 20.0, now)
            assert port_store.quantile(
                0.9, "serve_stage_seconds", labels, 15.0, now
            ) == jax_store.quantile(
                0.9, "serve_stage_seconds", labels, 15.0, now)
    assert port_store.label_values("serve_requests_total", "event") == \
        jax_store.label_values("serve_requests_total", "event")


def test_tsdb_caps_evict_alike():
    rng = np.random.default_rng(3)
    jax_store = jax_obs.TsdbStore(max_series=16, max_bytes=6000)
    port_store = obs.TsdbStore(max_series=16, max_bytes=6000)
    for i in range(400):
        name = f"s{int(rng.integers(0, 30))}_total"
        labels = {"lane": str(int(rng.integers(0, 3)))}
        for store in (jax_store, port_store):
            store.ingest(name, labels, float(i), ts=float(i))
    assert port_store.stats() == jax_store.stats()
    assert port_store.query({"list": True}) == jax_store.query({"list": True})


# -- the anomaly rules under the watchdog ----------------------------------


def series_scenario(kind: str, seed: int) -> list:
    """[(ts, name, labels, value)] of one rule's scenario: a steady
    baseline, a fault window, then recovery."""
    rng = np.random.default_rng(seed)
    out = []
    if kind in ("rate", "quantile_rate", "decay"):
        v = 0.0
        for t in range(300 if kind == "decay" else 220):
            step = 50.0 if 120 <= t < 140 else 1.0 + float(rng.random())
            if kind == "decay" and t >= 140:
                # the fault fades slowly through the anchored half
                # threshold, where the hysteresis decides
                step = 1.5 + 48.5 * float(np.exp(-(t - 140) / 25.0))
            out.append((float(t), "j_total", {"worker": "w0"}, v))
            v += step
    elif kind == "saturation":
        for t in range(120):
            value = 0.99 if 40 <= t < 70 else float(rng.random()) * 0.5
            out.append((float(t), "busy", {"lane": "featurize"}, value))
    elif kind == "flatline":
        for t in list(range(0, 50)) + list(range(80, 120)):
            out.append((float(t), "tsdb_scrape_up", {"worker": "w0"}, 1.0))
    return out


def rule_pair(kind: str) -> tuple:
    def make(mod):
        if kind in ("rate", "decay"):
            return mod.RateJumpRule("jump", "j_total", window_s=10.0,
                                    baseline_windows=4, min_baseline=3,
                                    z_threshold=4.0)
        if kind == "quantile_rate":
            return mod.RateJumpRule("jump_w0", "j_total",
                                    labels={"worker": "w0"}, window_s=5.0,
                                    baseline_windows=8, min_baseline=4,
                                    z_threshold=4.5, min_value=0.5)
        if kind == "saturation":
            return mod.SaturationRule("sat", "busy", threshold=0.95)
        return mod.FlatlineRule("flat_w0", "tsdb_scrape_up",
                                labels={"worker": "w0"}, stale_after_s=5.0)
    return make(jax_obs), make(obs)


@pytest.mark.parametrize("kind", ["rate", "decay", "quantile_rate",
                                  "saturation", "flatline"])
@pytest.mark.parametrize("hold", [1, 2])
def test_watchdog_sequence_matches_jax(kind, hold):
    samples = series_scenario(kind, seed=hold)
    clock = [0.0]
    runs = []
    for mod, rule in zip((jax_obs, obs), rule_pair(kind)):
        store = mod.TsdbStore(fine_len=400, clock=lambda: clock[0])
        wd = mod.AnomalyWatchdog(store, [rule], hold_ticks=hold,
                                 clear_ticks=2, clock=lambda: clock[0])
        events, active = [], []
        i = 0
        for now in np.arange(5.0, samples[-1][0] + 30.0, 2.5):
            while i < len(samples) and samples[i][0] <= now:
                ts, name, labels, value = samples[i]
                store.ingest(name, labels, value, ts=ts)
                i += 1
            clock[0] = float(now)
            events.append(wd.evaluate())
            active.append(wd.active())
        runs.append((events, active, wd.snapshot()))
    assert runs[1] == runs[0]
    fired = [e for round_ in runs[0][0] for e in round_]
    assert [e["state"] for e in fired][:2] == ["firing", "cleared"]


# -- trace assembly ----------------------------------------------------------


def span_rows(seed: int) -> list:
    """Seeded trace rows as a router and three workers retain them:
    failovers, hedged twins, duplicates across pulls, orphans, span-less
    slow exemplars, truncated tails."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(40):
        tid = f"{int(rng.integers(0, 2**63)):016x}"
        e2e = float(np.round(rng.uniform(1.0, 400.0), 3))
        shape = int(rng.integers(0, 6))
        spans = [{"name": "route", "t_ms": 0.0, "dur_ms": 0.0,
                  "note": "to=w0"}]
        if shape in (1, 2):
            spans += [{"name": "failover", "t_ms": 3.0, "dur_ms": 0.0,
                       "note": "w0: connection lost"},
                      {"name": "route", "t_ms": 3.2, "dur_ms": 0.0,
                       "note": "to=w1"}]
        if shape != 3:  # 3: an orphan, no router row
            kind = "slow" if shape == 4 else "trace"
            rows.append({"trace": tid, "id": k, "kind": kind,
                         "proc": "router", "status": "ok", "dur_ms": e2e,
                         "spans": [] if kind == "slow" else spans})
        for proc in (["w1"] if shape in (1, 2) else ["w0"]) + (
                ["w2"] if shape == 5 else []):
            dur = float(np.round(e2e * rng.uniform(0.3, 1.1), 3))
            stages = [("queue_wait", 0.3), ("featurize", 0.1),
                      ("device", 0.5)]
            if shape == 2:
                stages = stages[2:]  # a tail that lost its early spans
            t = 0.0
            wspans = []
            for name, share in stages:
                d = float(np.round(dur * share, 3))
                wspans.append({"name": name, "t_ms": t, "dur_ms": d})
                t += d
            row = {"trace": tid, "id": k, "kind": "trace", "proc": proc,
                   "status": "late" if proc == "w2" else "ok",
                   "dur_ms": dur, "spans": wspans}
            rows.append(row)
            if rng.random() < 0.2:
                rows.append(dict(row))  # seen again across pulls
    order = rng.permutation(len(rows))
    return [rows[i] for i in order]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assembly_matches_jax(seed):
    rows = span_rows(seed)
    trees = obs.assemble_rows(rows)
    assert trees == jax_obs.assemble_rows(rows)
    assert len(trees) == 40
    assert any(t["orphan"] for t in trees)
    for tree in trees:
        assert obs.render_tree(tree) == jax_obs.render_tree(tree)
        mine = [r for r in rows if r["trace"] == tree["trace"]]
        assert obs.assemble_trace(mine) == jax_obs.assemble_trace(mine)


def test_collector_matches_jax():
    rows = span_rows(7)
    by_proc = {}
    for row in rows:
        by_proc.setdefault(row["proc"], []).append(row)

    def sources(mod):
        tails = {p: list(rs) for p, rs in by_proc.items()}
        tails["dead"] = None

        def source(p):
            def fn():
                if tails[p] is None:
                    raise OSError("worker down")
                return tails[p]
            return fn
        return mod.TraceCollector({p: source(p) for p in tails},
                                  capacity=64)

    jax_col, port_col = sources(jax_obs), sources(obs)
    try:
        assert port_col.pull() == jax_col.pull()
        assert port_col.assembled(10) == jax_col.assembled(10)
        assert port_col.assembled(5, trace_id=rows[0]["trace"][:3]) \
            == jax_col.assembled(5, trace_id=rows[0]["trace"][:3])
        assert port_col.stats() == jax_col.stats()
    finally:
        jax_col.close()
        port_col.close()


# -- the package surface and the selftest -------------------------------------


def test_obs_exports_match_jax():
    assert sorted(obs.__all__) == sorted(jax_obs.__all__)


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_stats_selftest_matches_jax():
    got = run(port_main, ["stats", "--selftest"])
    assert got == run(jax_main, ["stats", "--selftest"])
    assert got[0] == 0
    assert json.loads(got[2].strip().splitlines()[-1])["problems"] == []


# -- the verbs against live stub fleets -------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def stub_fleet(root: str, package: str):
    """Two stub workers of ``package`` (`licensee_tpu` or the port)
    behind its own router and front socket, scraped every 0.2 s, after
    60 routed requests (one of them a slow exemplar)."""
    fleet = __import__(f"{package}.fleet.router", fromlist=["Router"])
    wire = __import__(f"{package}.fleet.wire", fromlist=["oneshot"])
    os.makedirs(root)
    procs, sockets = [], {}
    for name in ("w0", "w1"):
        sock = os.path.join(root, f"{name}.sock")
        sockets[name] = sock
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"{package}.fleet.faults", "--socket",
             sock, "--name", name, "--service-ms", "2"],
            env={**os.environ, "PYTHONPATH": REPO},
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    front = os.path.join(root, "front.sock")
    try:
        for sock in sockets.values():
            deadline = time.perf_counter() + 15.0
            while True:
                try:
                    wire.oneshot(sock, {"op": "stats"}, 1.0)
                    break
                except wire.WireError:
                    assert time.perf_counter() < deadline
                    time.sleep(0.02)
        with fleet.Router(sockets, probe_interval_s=0.05, trace_sample=1.0,
                          scrape_interval_s=0.2) as router:
            server = fleet.FrontServer(front, router)
            thread = threading.Thread(target=server.serve_forever,
                                      kwargs={"poll_interval": 0.05},
                                      daemon=True)
            thread.start()
            try:
                for i in range(60):
                    wire.oneshot(front, {"id": i, "content": f"verb {i}"},
                                 10.0)
                time.sleep(0.6)  # three scrape rounds into the store
                yield front, sockets
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=5.0)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("verbs"))
    with stub_fleet(os.path.join(root, "jax"), "licensee_tpu") as jax_f, \
            stub_fleet(os.path.join(root, "port"),
                       "licensee_tpu_torch") as port_f:
        yield {"jax": jax_f, "port": port_f, "root": root}


NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


def masked(text: str, root: str) -> str:
    text = text.replace(root, "ROOT").replace("/jax/", "/X/").replace(
        "/port/", "/X/").replace("licensee-tpu-torch", "licensee-tpu")
    text = re.sub(r"\b[0-9a-f]{16}\b", "T", text)
    # where an SLO window was read from: the store once its scrapes
    # cover the window, the in-process ring until then
    text = re.sub(r'"(store|ring)"', '"SRC"', text)
    text = NUMBER.sub("N", text)
    return re.sub(r"[ \t]+", " ", text)


VERBS = {
    "stats json": lambda f, w: ["stats", "--socket", f],
    "stats prometheus": lambda f, w: ["stats", "--socket", f, "--format",
                                      "prometheus"],
    "stats table": lambda f, w: ["stats", "--socket", w["w0"], "--socket",
                                 w["w1"]],
    "stats trace": lambda f, w: ["stats", "--socket", w["w0"], "--trace",
                                 "2"],
    "stats watch": lambda f, w: ["stats", "--socket", f, "--watch", "0",
                                 "--watch-iterations", "1"],
    "traces": lambda f, w: ["traces", "--socket", f, "--slowest", "1"],
    "traces json": lambda f, w: ["traces", "--socket", f, "--n", "2",
                                 "--json"],
    "traces worker": lambda f, w: ["traces", "--socket", w["w0"]],
    "slo": lambda f, w: ["slo", "--socket", f],
    "slo json": lambda f, w: ["slo", "--socket", f, "--json"],
    "top": lambda f, w: ["top", "--socket", f, "--interval", "0"],
    "top worker": lambda f, w: ["top", "--socket", w["w0"], "--interval",
                                "0"],
    "alerts": lambda f, w: ["alerts", "--socket", f, "--history", "5"],
    "alerts json": lambda f, w: ["alerts", "--socket", f, "--json"],
    "alerts worker": lambda f, w: ["alerts", "--socket", w["w0"]],
    "no socket": lambda f, w: ["stats"],
}


def verb_out(main, argv, root):
    rc, out, err = run(main, argv)
    if "prometheus" in argv:
        # a scrape between two reads may add a series: the families and
        # the grammar are what the two reads share
        assert obs.check_exposition(out) == []
        out = "\n".join(sorted({line for line in out.splitlines()
                                if line.startswith("# TYPE ")}))
    return rc, masked(out, root), masked(err, root)


def read_both(fleets, verb) -> dict:
    root = fleets["root"]
    outs = {}
    for fleet in ("jax", "port"):
        front, workers = fleets[fleet]
        argv = VERBS[verb](front, workers)
        outs[fleet] = (verb_out(jax_main, argv, root),
                       verb_out(port_main, argv, root))
    return outs


@pytest.mark.parametrize("verb", list(VERBS))
def test_verbs_match_jax(fleets, verb):
    # the fleets keep scraping while they are read: a scrape miss or a
    # new series may change between two reads, so a differing read is
    # taken again, a few times at most
    for _ in range(5):
        outs = read_both(fleets, verb)
        if outs["jax"][0] == outs["jax"][1] == outs["port"][0] == \
                outs["port"][1]:
            break
        time.sleep(0.5)
    # each fleet read by both CLIs alike, and the port's verb on the
    # port's fleet as the JAX verb on the JAX fleet
    assert outs["jax"][1] == outs["jax"][0]
    assert outs["port"][0] == outs["port"][1]
    assert outs["port"][1] == outs["jax"][0]
    rc, out, err = outs["jax"][0]
    if verb in ("traces worker", "top worker", "alerts worker",
                "no socket"):
        assert rc == 1 and err.startswith("error: ")
    else:
        assert rc == 0 and out
