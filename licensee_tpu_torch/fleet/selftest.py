"""Fleet selftest — the CI smoke behind ``fleet --selftest``.

The port's copy of `licensee_tpu/fleet/selftest.py` (``selftest``,
``selftest_reload``, ``selftest_tcp`` and the tenancy drill
``selftest_tenant``).  Boots a REAL fleet on this host: a
supervisor spawning 2 of the port's serve worker processes on
``device`` (the card unless ``"cpu"`` is asked for), the router
fronting them on a Unix socket, and a live client streaming
classification traffic through the front door.
Mid-stream, one worker is SIGKILLed (faults.kill — a real SIGKILL to a
real process).  The gate:

* ZERO client-visible errors: every request answers with the correct
  verdict via retry/failover, connection resets and queue losses
  included;
* the supervisor restarts the dead worker within its backoff budget
  and the worker rejoins the rotation (answers probes again);
* trace IDs propagate: at least one router-minted trace ID (route
  span) appears verbatim in a worker's ``{"op": "trace"}`` tail;
* the merged fleet exposition (router registry + per-worker scrapes,
  ``worker``-labeled) parses clean against the Prometheus grammar;
* a graceful drain completes with zero in-flight work (the rolling-
  restart primitive).

``stub=True`` swaps the workers for the protocol-faithful stub
(faults.py) — same supervisor, router, sockets, and SIGKILL, no torch
import per worker — the fast path the unit tests ride.
"""

from __future__ import annotations

import json
import os
import re
import socket
import sys
import tempfile
import threading
import time

from licensee_tpu_torch.corpus.artifact import short_fingerprint
from licensee_tpu_torch.fleet import faults
from licensee_tpu_torch.fleet.http_edge import HttpEdgeServer
from licensee_tpu_torch.fleet.router import FrontServer, Router
from licensee_tpu_torch.fleet.supervisor import Supervisor, worker_env
from licensee_tpu_torch.fleet.wire import WireError, oneshot
from licensee_tpu_torch.obs import RateJumpRule, check_exposition


def _stub_argv(name: str, sock: str) -> list[str]:
    return [
        sys.executable, "-m", "licensee_tpu_torch.fleet.faults",
        "--socket", sock, "--name", name, "--service-ms", "10",
    ]


def _serve_argv(name: str, sock: str, device: str) -> list[str]:
    return [
        sys.executable, "-m", "licensee_tpu_torch.cli.main", "serve",
        "--socket", sock, "--max-delay-ms", "5",
        "--trace-sample", "1.0", "--device", device,
    ]


def _stub_reload_argv(name: str, sock: str) -> list[str]:
    argv = [
        sys.executable, "-m", "licensee_tpu_torch.fleet.faults",
        "--socket", sock, "--name", name, "--service-ms", "5",
        "--fingerprint", "fp-old",
    ]
    if name == "w1":
        # the per-worker validation-failure script: w1 refuses any
        # corpus starting "deny-", so a fleet roll of one fails AFTER
        # w0 succeeded — the rollback drill
        argv += ["--reload-deny", "deny-"]
    return argv


def _serve_reload_argv(name: str, sock: str, device: str) -> list[str]:
    return _serve_argv(name, sock, device) + ["--corpus", "vendored"]


def _client_blobs(stub: bool, n_unique: int = 8) -> list[str]:
    if stub:
        return [f"stub blob {i}" for i in range(n_unique)]
    from licensee_tpu_torch.corpus.license import License

    body = re.sub(
        r"\[(\w+)\]", "example", License.find("mit").content or ""
    )
    # unique Dice-bound variants: defeat the Exact prefilter so rows
    # cross each worker's device path (the serving path under test)
    return [f"{body}\nzqfleet{i} zqtail{i}\n" for i in range(n_unique)]


def _worker_trace_ids(socket_path: str) -> set[str]:
    try:
        row = oneshot(socket_path, {"op": "trace", "n": 100}, 5.0)
    except WireError:
        return set()
    return {
        t.get("trace") for t in row.get("traces") or [] if t.get("trace")
    }


def _saturation_smoke(
    front_path: str, router, problems: list[str], stub: bool,
) -> dict:
    """The open-loop burst gate: C client connections write EVERY
    request line up front (no request/response lockstep — open-loop
    arrival, the shape that used to stall the thread-per-attempt
    router), while a slowloris dribbles a never-finished line
    alongside.  The gates:

    * every request answers (no stalled client) with zero errors;
    * the router's event-loop lag gauge stayed bounded — a blocked
      loop callback shows up here in seconds, long before p99 does;
    * the slowloris was reaped by the stall sweep, having held no
      session, thread, or backend pool slot meanwhile."""
    n_conns = 4 if stub else 2
    n_per_conn = 100 if stub else 25
    lag_budget_ms = 500.0 if stub else 1500.0
    counts = [0] * n_conns
    failures: list[str] = []

    def client(idx: int) -> None:
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.connect(front_path)
                s.settimeout(120.0)
                f = s.makefile("rwb")
                for i in range(n_per_conn):
                    f.write((json.dumps(
                        {"id": i, "content": f"burst {idx} {i}"}
                    ) + "\n").encode("utf-8"))
                f.flush()  # all lines in flight at once: open-loop
                for _ in range(n_per_conn):
                    row = json.loads(f.readline())
                    if row.get("error"):
                        failures.append(f"burst error: {row}")
                    counts[idx] += 1
        except (OSError, ValueError) as exc:
            failures.append(f"burst client {idx}: {exc}")

    loris = faults.Slowloris(
        front_path, mode="dribble", byte_interval_s=0.25, give_up_s=30.0
    )
    loris_box: dict = {}
    loris_thread = threading.Thread(
        target=lambda: loris_box.update(loris.run()), daemon=True
    )
    loris_thread.start()
    threads = [
        threading.Thread(target=client, args=(i,), daemon=True)
        for i in range(n_conns)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180.0)
    elapsed = time.perf_counter() - t0
    loris_thread.join(timeout=40.0)
    answered = sum(counts)
    if answered != n_conns * n_per_conn:
        problems.append(
            f"saturation burst: {answered}/{n_conns * n_per_conn} "
            f"answered — a client stalled"
        )
    if failures:
        problems.append(
            f"saturation burst: {len(failures)} failures, "
            f"e.g. {failures[:3]}"
        )
    lag_ms = router.stats()["router"]["loop_max_lag_ms"]
    if not (lag_ms < lag_budget_ms):
        problems.append(
            f"event-loop lag {lag_ms}ms >= {lag_budget_ms}ms during "
            f"the open-loop burst — something blocked the loop"
        )
    if not loris_box.get("reaped"):
        problems.append(
            f"slowloris was not reaped during the burst: {loris_box}"
        )
    return {
        "requests": answered,
        "rps": round(answered / elapsed, 1) if elapsed > 0 else None,
        "max_lag_ms": lag_ms,
        "slowloris": loris_box,
    }


def selftest(
    verbose: bool = True,
    stub: bool = False,
    n_workers: int = 2,
    n_requests: int = 120,
    device: str = "cuda",
) -> int:
    problems: list[str] = []
    saturation: dict | None = None
    tmpdir = tempfile.mkdtemp(prefix="licensee-fleet-")
    sockets = {
        f"w{i}": os.path.join(tmpdir, f"w{i}.sock")
        for i in range(n_workers)
    }
    boot_timeout = 20.0 if stub else 240.0
    req_timeout = 10.0 if stub else 120.0
    env = worker_env(None, None)
    supervisor = Supervisor(
        sockets,
        argv_for=(
            _stub_argv if stub
            else lambda name, sock: _serve_argv(name, sock, device)
        ),
        env_for=lambda name, chips: env,
        probe_interval_s=0.25,
        backoff_base_s=0.25,
        backoff_max_s=2.0,
        startup_grace_s=boot_timeout,
    )
    router = Router(
        sockets,
        supervisor=supervisor,
        probe_interval_s=0.25,
        request_timeout_s=req_timeout,
        dispatch_wait_s=req_timeout + 30.0,
        trace_sample=1.0,
    )
    front_path = os.path.join(tmpdir, "front.sock")
    server = None
    server_thread = None
    try:
        supervisor.start()
        if not supervisor.wait_healthy(boot_timeout):
            problems.append(
                f"workers never became healthy: {supervisor.status()}"
            )
            raise _Abort()
        router.start()
        # stall_timeout_s=2: honest clients write whole lines — only a
        # slowloris sits mid-line for seconds, and the smoke wants its
        # reap to land inside the test budget
        server = FrontServer(front_path, router, stall_timeout_s=2.0)
        server_thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True,
        )
        server_thread.start()

        # -- open-loop saturation smoke (+ slowloris reap) --
        saturation = _saturation_smoke(front_path, router, problems, stub)

        blobs = _client_blobs(stub)
        rows = _drive_traffic(
            front_path, blobs, n_requests, supervisor, problems,
            read_timeout=req_timeout + 60.0,
        )
        # -- zero client-visible errors, correct verdicts --
        want_key = "stub-mit" if stub else "mit"
        errors = [r for r in rows if r.get("error")]
        if errors:
            problems.append(
                f"{len(errors)} client-visible errors, e.g. {errors[:3]}"
            )
        wrong = [r for r in rows if not r.get("error")
                 and r.get("key") != want_key]
        if wrong:
            problems.append(f"wrong verdicts, e.g. {wrong[:3]}")
        if len(rows) != n_requests:
            problems.append(
                f"response count {len(rows)} != requests {n_requests}"
            )
        # -- the dead worker restarted within the backoff budget --
        handle = supervisor.workers["w0"]
        budget = (
            supervisor.backoff_delay_s(0)
            + supervisor.backoff_delay_s(1)
            + boot_timeout
        )
        deadline = time.perf_counter() + budget
        revived = False
        while time.perf_counter() < deadline:
            if handle.restarts >= 1 and supervisor.probe("w0") is not None:
                revived = True
                break
            time.sleep(0.1)
        if not revived:
            problems.append(
                f"w0 not restarted within {budget:.1f}s budget: "
                f"{supervisor.status()}"
            )
        # -- the router actually failed over (the kill landed mid-stream) --
        rstats = router.stats()["router"]
        if rstats["failovers"] + rstats["retries"] < 1:
            problems.append(
                f"no failover recorded — did the kill land? {rstats}"
            )
        # -- trace propagation router -> worker --
        routed_ids = {
            t["trace"]
            for t in router.trace_tail(200)
            if any(s["name"] == "route" for s in t.get("spans", ()))
        }
        worker_ids = set()
        for sock in sockets.values():
            worker_ids |= _worker_trace_ids(sock)
        if not routed_ids:
            problems.append("router retained no routed traces")
        elif not (routed_ids & worker_ids):
            problems.append(
                f"no router trace ID found in any worker tail "
                f"({len(routed_ids)} routed, {len(worker_ids)} worker-side)"
            )
        # -- merged fleet exposition --
        exposition = router.prometheus()
        grammar = check_exposition(exposition)
        if grammar:
            problems.append(f"merged exposition grammar: {grammar[:3]}")
        if 'worker="w1"' not in exposition:
            problems.append("merged exposition missing worker labels")
        if 'fleet_requests_total{worker="router",event="ok"}' not in (
            exposition
        ):
            problems.append("merged exposition missing router series")
        # -- flight-recorder harvest: the SIGKILL's black box rode the
        #    restart log (exit signal + dump path + last events) --
        _check_flight_harvest(supervisor, problems)
        # -- availability SLO intact across the whole drill: the
        #    SIGKILL cost retries, never error budget --
        _check_slo(router, problems)
        # -- cross-process trace assembly: the failed-over request's
        #    tree joins the router's failover spans with the surviving
        #    worker's serving spans under ONE trace ID, critical-path
        #    self-times within 5% of the recorded e2e --
        _check_assembled_traces(router, front_path, problems)
        # -- graceful drain completes in-flight and stops the worker --
        drained_clean = supervisor.drain(
            "w1", timeout_s=30.0, restart=False
        )
        if not drained_clean:
            problems.append("drain of idle w1 was not clean")
        if supervisor.workers["w1"].state != "stopped":
            problems.append(
                f"drained worker state: {supervisor.workers['w1'].state}"
            )
    except _Abort:
        pass
    except Exception as exc:  # noqa: BLE001 — selftest must report, not die
        problems.append(f"selftest crashed: {type(exc).__name__}: {exc}")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if server_thread is not None:
            server_thread.join(timeout=5.0)
        router.close()
        supervisor.stop()
    # -- the retained-telemetry acceptance drill: its own mini-fleet
    #    (the scripted fault must not race the kill/drain drills
    #    above); stub-only — --slow-span is a stub fault flag --
    telemetry = _telemetry_drill(problems) if stub else None
    if verbose:
        summary = {
            "fleet_selftest": "ok" if not problems else "FAIL",
            "stub_workers": stub,
            "saturation": saturation,
            "telemetry": telemetry,
            "problems": problems,
        }
        sys.stderr.write(json.dumps(summary) + "\n")
    return 0 if not problems else 1


class _Abort(Exception):
    """Internal early-exit: boot failed, nothing further to assert."""


def _check_flight_harvest(
    supervisor: Supervisor, problems: list[str]
) -> None:
    """The flight-recorder drill gate: the supervisor's restart-log
    entry for the SIGKILLed worker must carry the kill signal, the
    black-box dump path, and a NON-EMPTY harvested event tail — a
    SIGKILL post-mortem starts from recorded evidence (obs/flight.py,
    supervisor._harvest_flight)."""
    from licensee_tpu_torch.obs.flight import flight_path_for_socket

    handle = supervisor.workers["w0"]
    log = handle.restart_log
    if not log:
        problems.append(
            "no restart-log entry for the SIGKILLed worker"
        )
        return
    entry = log[0]
    if entry.get("reason") != "crash" or entry.get("signal") != 9:
        problems.append(
            f"restart log missed the kill (want crash/signal 9): "
            f"{ {k: entry.get(k) for k in ('reason', 'exit_code', 'signal')} }"
        )
    want_dump = flight_path_for_socket(handle.socket_path)
    if entry.get("flight_dump") != want_dump:
        problems.append(
            f"restart log names the wrong black-box path: "
            f"{entry.get('flight_dump')!r} != {want_dump!r}"
        )
    if not entry.get("flight_harvested") or not entry.get(
        "flight_events"
    ):
        problems.append(
            "supervisor failed to harvest a non-empty flight dump: "
            f"harvested={entry.get('flight_harvested')} "
            f"events={len(entry.get('flight_events') or [])}"
        )


def _telemetry_drill(problems: list[str]) -> dict | None:
    """The retained-telemetry acceptance drill: a scripted latency
    fault on a stub worker must (1) appear as a stored p99 series
    windowable via the ``{"op": "query"}`` front verb, (2) carry an
    exemplar whose trace ID resolves through ``{"op": "traces"}`` to an
    assembled tree naming that worker, and (3) raise exactly ONE
    watchdog alert (``router_p99_latency_jump``) that clears once the
    fault ends.

    Runs its own single-worker mini-fleet: with one backend, router
    dispatch order IS the stub's admission order, so the ``--slow-span``
    fault window (rows N_BASE+1 .. N_BASE+N_SLOW) is deterministic —
    no racing against a load balancer.  Scrape cadence is cranked to
    0.25s so the stock p99-jump rule's 2s windows fill in seconds, not
    the production minutes."""
    from licensee_tpu_torch.fleet.wire import Connection

    n_base, n_slow, slow_ms = 400, 14, 250.0
    tmpdir = tempfile.mkdtemp(prefix="licensee-tsdb-drill-")
    sock = os.path.join(tmpdir, "wslow.sock")
    front_path = os.path.join(tmpdir, "front.sock")

    def argv_for(name: str, path: str) -> list[str]:
        return [
            sys.executable, "-m", "licensee_tpu_torch.fleet.faults",
            "--socket", path, "--name", name, "--service-ms", "5",
            "--slow-span", f"{n_base}:{n_slow}:{slow_ms:g}",
        ]

    env = worker_env(None, None)
    supervisor = Supervisor(
        {"wslow": sock},
        argv_for=argv_for,
        env_for=lambda name, chips: env,
        probe_interval_s=0.25,
        startup_grace_s=20.0,
    )
    router = Router(
        {"wslow": sock},
        supervisor=supervisor,
        probe_interval_s=0.25,
        request_timeout_s=10.0,
        trace_sample=1.0,
        scrape_interval_s=0.25,
        # the stock rule set with one drill tuning: min_value=0.05
        # keeps cold-start jitter (tens of ms on the first windows)
        # from firing — only the scripted 250ms span can breach
        watchdog_rules=[RateJumpRule(
            "router_p99_latency_jump",
            "fleet_request_seconds",
            labels={"worker": "router"},
            signal="quantile",
            q=0.99,
            window_s=2.0,
            baseline_windows=8,
            min_baseline=4,
            z_threshold=4.5,
            min_value=0.05,
            description="routed p99 jumped vs its trailing baseline",
        )],
    )
    server = None
    server_thread = None
    stop = threading.Event()
    drive_errors: list[str] = []
    out: dict = {}

    def drive() -> None:
        """Paced lockstep traffic over ONE connection: the 25ms pace
        spreads the n_base baseline rows across >10s of wall clock, so
        the p99 rule's trailing 2s windows all see traffic before the
        fault lands; past n_base the stub itself throttles (each slow
        row holds the line slow_ms)."""
        conn = None
        try:
            conn = Connection(front_path, 10.0)
            i = 0
            while not stop.is_set():
                row = conn.request(json.dumps(
                    {"id": i, "content": f"drill {i}"}
                ), 10.0)
                if row.get("error"):
                    drive_errors.append(f"drill row error: {row}")
                    return
                i += 1
                stop.wait(0.025)
        except (WireError, OSError) as exc:
            if not stop.is_set():
                drive_errors.append(f"drill driver died: {exc}")
        finally:
            if conn is not None:
                conn.close()

    driver = threading.Thread(target=drive, daemon=True)
    try:
        supervisor.start()
        if not supervisor.wait_healthy(20.0):
            problems.append(
                f"telemetry drill: worker never healthy: "
                f"{supervisor.status()}"
            )
            raise _Abort()
        router.start()
        server = FrontServer(front_path, router, stall_timeout_s=5.0)
        server_thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True,
        )
        server_thread.start()
        driver.start()

        # -- (3a) the fault fires the p99-jump rule, and ONLY it --
        fired = None
        deadline = time.perf_counter() + 60.0
        while time.perf_counter() < deadline and not drive_errors:
            row = oneshot(front_path, {"op": "alerts"}, 5.0)
            active = (row.get("alerts") or {}).get("active") or []
            if any(
                a.get("rule") == "router_p99_latency_jump"
                for a in active
            ):
                fired = active
                break
            time.sleep(0.3)
        if fired is None:
            problems.append(
                "telemetry drill: p99-jump alert never fired "
                f"(driver errors: {drive_errors[:2]})"
            )
            raise _Abort()
        extras = [
            a["rule"] for a in fired
            if a.get("rule") != "router_p99_latency_jump"
        ]
        if extras:
            problems.append(
                f"telemetry drill: unexpected co-firing rules: {extras}"
            )
        out["alert"] = fired[0]

        # -- (1) the fault is windowable store history: p99 over a
        #    window covering the fault, served by the query verb.  The
        #    alert fires at the FIRST slow completion (one 250ms row
        #    detonates the z-score against the tight baseline), but the
        #    windowed p99 only crosses once enough of the span has
        #    drained through the stub to outnumber the top percentile —
        #    so poll while the remaining ~3.5s of slow rows land.  20s
        #    window (not the rule's 2s): the 14 slow rows stay >1% of
        #    any 20s window at the ~40/s drill pace, so a scheduling
        #    stall on a loaded single-core VM cannot roll the fault
        #    out from under the assertion --
        q: dict = {}
        value = None
        deadline = time.perf_counter() + 30.0
        while time.perf_counter() < deadline:
            row = oneshot(front_path, {
                "op": "query", "series": "fleet_request_seconds",
                "fn": "quantile", "q": 0.99, "window": 20.0,
                "labels": {"worker": "router"},
            }, 5.0)
            q = row.get("query") or {}
            value = q.get("value")
            if value is not None and value >= 0.05:
                break
            time.sleep(0.3)
        if value is None or not value >= 0.05:
            problems.append(
                f"telemetry drill: stored p99 missed the "
                f"{slow_ms:g}ms fault: {q}"
            )
        out["p99"] = value

        # -- (2) the stored exemplar closes the loop to a trace tree
        #    naming the slow worker --
        ex = q.get("exemplar") or {}
        ex_id = ex.get("trace_id")
        if not ex_id:
            problems.append(
                f"telemetry drill: fault p99 carries no exemplar: {q}"
            )
        else:
            row = oneshot(front_path, {
                "op": "traces", "trace_id": ex_id, "n": 5,
            }, 10.0)
            trees = row.get("traces") or []
            procs = set((trees[0].get("procs") or ())) if trees else set()
            if not trees or "wslow" not in procs:
                problems.append(
                    f"telemetry drill: exemplar {ex_id!r} resolved to "
                    f"no tree naming the slow worker (procs={procs})"
                )
            out["exemplar"] = ex_id

        # -- (3b) recovery traffic clears the alert; exactly one fire
        #    across the whole drill --
        cleared = False
        deadline = time.perf_counter() + 45.0
        while time.perf_counter() < deadline:
            row = oneshot(front_path, {"op": "alerts"}, 5.0)
            snap = row.get("alerts") or {}
            if not snap.get("active"):
                cleared = True
                break
            time.sleep(0.3)
        if not cleared:
            problems.append(
                "telemetry drill: alert never cleared after the fault "
                f"ended: {snap.get('active')}"
            )
        elif snap.get("fired_total") != 1:
            problems.append(
                f"telemetry drill: fired_total "
                f"{snap.get('fired_total')} != 1"
            )
        out["fired_total"] = snap.get("fired_total")
        if drive_errors:
            problems.append(f"telemetry drill: {drive_errors[:3]}")
    except _Abort:
        pass
    except Exception as exc:  # noqa: BLE001 — selftest must report, not die
        problems.append(
            f"telemetry drill crashed: {type(exc).__name__}: {exc}"
        )
    finally:
        stop.set()
        driver.join(timeout=15.0)
        if server is not None:
            server.shutdown()
            server.server_close()
        if server_thread is not None:
            server_thread.join(timeout=5.0)
        router.close()
        supervisor.stop()
    return out or None


def _check_slo(router: Router, problems: list[str]) -> None:
    """The SLO gate: the availability objective must end the drill
    with burn rate < 1.0 on every window — zero client-visible errors
    means zero budget spent, SIGKILL included."""
    slo = router.stats().get("slo") or {}
    avail = (slo.get("objectives") or {}).get("availability") or {}
    if not avail:
        problems.append(f"router stats carries no availability SLO: {slo}")
        return
    if not (avail.get("good") or 0) > 0:
        problems.append(f"availability SLO saw no traffic: {avail}")
    max_burn = avail.get("max_burn")
    if max_burn is None or not (max_burn < 1.0):
        problems.append(
            f"availability SLO burned through the drill: "
            f"max_burn={max_burn} windows={avail.get('windows')}"
        )


def _check_assembled_traces(
    router: Router, front_path: str, problems: list[str]
) -> None:
    """The telemetry-plane gate, both layers: (1) the collector joins
    the failed-over request's router spans with the surviving worker's
    serving spans under one trace ID, with critical-path self-times
    summing to within 5% of the recorded end-to-end latency; (2) the
    ``licensee-tpu-torch traces --slowest 1`` CLI prints one assembled tree
    against the live front socket."""
    import contextlib
    import io

    trees = router.assembled_traces(200)
    if not trees:
        problems.append("collector assembled no traces after the drill")
        return
    joined = None
    worker_procs = set(router.backends)
    for tree in trees:
        root = tree.get("root") or {}
        names = {
            c.get("name") for c in root.get("children") or []
        }
        if "failover" not in names:
            continue
        if set(tree.get("procs") or []) & worker_procs:
            joined = tree
            break
    if joined is None:
        problems.append(
            "no assembled tree joins a router failover with a "
            f"surviving worker's spans ({len(trees)} trees, procs "
            f"{sorted({p for t in trees for p in t.get('procs') or []})})"
        )
    else:
        e2e = joined.get("e2e_ms") or 0.0
        crit = joined.get("critical_ms") or 0.0
        if e2e <= 0.0 or abs(crit - e2e) > 0.05 * e2e:
            problems.append(
                f"critical-path self-times {crit}ms not within 5% of "
                f"the recorded e2e {e2e}ms (trace {joined.get('trace')})"
            )
    # every tree must account its time, failover or not
    bad_sums = [
        t["trace"] for t in trees
        if (t.get("e2e_ms") or 0.0) > 0.0
        and abs(t["critical_ms"] - t["e2e_ms"]) > 0.05 * t["e2e_ms"]
    ]
    if bad_sums:
        problems.append(
            f"{len(bad_sums)} assembled trees double- or under-count "
            f"critical-path time, e.g. {bad_sums[:3]}"
        )
    # the one-command view against the live fleet: --slowest 1 prints
    # one assembled tree; pinned by --id to the joined drill trace so
    # the gate is deterministic under concurrent burst traffic
    from licensee_tpu_torch.cli.main import main as cli_main

    for extra in (
        [],
        ["--id", joined["trace"]] if joined is not None else None,
    ):
        if extra is None:
            continue
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main([
                "traces", "--socket", front_path, "--slowest", "1",
                *extra,
            ])
        text = out.getvalue()
        if rc != 0 or "critical path" not in text:
            problems.append(
                f"`licensee-tpu-torch traces --slowest 1` against the live "
                f"fleet failed (rc={rc}): {text[:300]!r}"
            )
        elif extra and ("failover" not in text or not any(
            f"[{p}]" in text for p in worker_procs
        )):
            problems.append(
                "the rendered drill tree misses the failover spans or "
                f"the surviving worker's spans: {text[:400]!r}"
            )


class _ReloadTraffic:
    """Continuous client traffic through the front socket for the
    reload drill: sequential request/response round trips on one
    connection, every row collected, until stopped."""

    def __init__(self, front_path: str, blobs: list[str],
                 timeout_s: float):
        self.front_path = front_path
        self.blobs = blobs
        self.timeout_s = timeout_s
        self.rows: list[dict] = []
        self.errors: list[str] = []
        self.reconnects = 0
        self.stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def finish(self) -> None:
        self.stop.set()
        self._thread.join(timeout=self.timeout_s + 10.0)

    def _run(self) -> None:
        from licensee_tpu_torch.fleet.wire import Connection, WireError

        conn = None
        i = 0
        while not self.stop.is_set():
            try:
                if conn is None:
                    conn = Connection(self.front_path, self.timeout_s)
                line = json.dumps({
                    "id": i,
                    "content": self.blobs[i % len(self.blobs)],
                    "filename": "LICENSE",
                })
                self.rows.append(conn.request(line, self.timeout_s))
                i += 1
            except WireError as exc:
                # the front socket must never drop a session during a
                # reload: any reconnect is itself a finding (counted),
                # and a failure on a FRESH connection is a hard error
                if conn is None:
                    self.errors.append(str(exc))
                    self.stop.wait(0.2)
                else:
                    self.reconnects += 1
                    conn.close()
                    conn = None
            time.sleep(0.005)
        if conn is not None:
            conn.close()


def _fingerprints(supervisor: Supervisor) -> dict:
    """name -> reported corpus fingerprint for every probeable worker."""
    out = {}
    for name in supervisor.workers:
        stats = supervisor.probe(name)
        out[name] = ((stats or {}).get("corpus") or {}).get("fingerprint")
    return out


def _await_respawn(
    supervisor: Supervisor, name: str, timeout_s: float
) -> bool:
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if supervisor.probe(name) is not None:
            return True
        time.sleep(0.1)
    return False


def _patch_stub_argv(argv: list[str], corpus: str) -> list[str]:
    """The stub twin of Supervisor.patch_corpus_argv: a respawned stub
    must report the fingerprint its fleet was rolled onto."""
    out = list(argv)
    for i, arg in enumerate(out[:-1]):
        if arg == "--fingerprint":
            out[i + 1] = corpus
            return out
    return out + ["--fingerprint", corpus]


def selftest_reload(
    verbose: bool = True,
    stub: bool = False,
    n_workers: int = 2,
    device: str = "cuda",
) -> int:
    """The fault-drilled zero-downtime upgrade selftest (``licensee-tpu
    fleet --selftest-reload``): a live 2-worker fleet under continuous
    front-socket traffic completes >=3 rolling corpus reloads
    interleaved with injected failures — a corrupt-artifact reload, a
    refused (validation-failure) reload that triggers automatic
    rollback, and (stub mode) a SIGKILL mid-swap — gating that

    * the client sees ZERO errors across every drill;
    * every response carries exactly one KNOWN corpus fingerprint
      (old or new, never anything else — no half-swapped corpus);
    * failed rolls leave the fleet healthy on the previous fingerprint,
      rollback included;
    * a crash-restarted worker rejoins on the fleet's CURRENT corpus
      (the respawn argv is patched by the roll).

    ``stub=True`` runs protocol-faithful stub workers (real processes,
    sockets, and signals; no torch) — the fast CI path; ``stub=False``
    drives real serve workers on ``device`` through real corpus
    artifacts."""
    problems: list[str] = []
    tmpdir = tempfile.mkdtemp(prefix="licensee-reload-fleet-")
    sockets = {
        f"w{i}": os.path.join(tmpdir, f"w{i}.sock")
        for i in range(n_workers)
    }
    boot_timeout = 20.0 if stub else 240.0
    req_timeout = 10.0 if stub else 120.0
    env = worker_env(None, None)
    supervisor = Supervisor(
        sockets,
        argv_for=(
            _stub_reload_argv if stub
            else lambda name, sock: _serve_reload_argv(name, sock, device)
        ),
        env_for=lambda name, chips: env,
        probe_interval_s=0.25,
        backoff_base_s=0.25,
        backoff_max_s=2.0,
        startup_grace_s=boot_timeout,
    )
    router = Router(
        sockets,
        supervisor=supervisor,
        probe_interval_s=0.25,
        request_timeout_s=req_timeout,
        dispatch_wait_s=req_timeout + 30.0,
    )
    front_path = os.path.join(tmpdir, "front.sock")
    server = None
    server_thread = None
    traffic = None
    argv_patch = _patch_stub_argv if stub else None
    want_key = "stub-mit" if stub else "mit"
    allowed_fps: set[str] = set()
    good_rolls = 0
    try:
        supervisor.start()
        if not supervisor.wait_healthy(boot_timeout):
            problems.append(
                f"workers never became healthy: {supervisor.status()}"
            )
            raise _Abort()
        router.start()
        server = FrontServer(front_path, router)
        server_thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True,
        )
        server_thread.start()
        fp_old = _fingerprints(supervisor)["w0"]
        if not fp_old:
            problems.append("workers report no corpus fingerprint")
            raise _Abort()
        allowed_fps.add(fp_old)

        if stub:
            targets = ["fp-new-1", "fp-new-2", "fp-new-4"]
            bad_source = "corrupt:drill"
            deny_source = "deny-fp"
        else:
            from licensee_tpu_torch.corpus.artifact import write_artifact
            from licensee_tpu_torch.corpus.spdx import spdx_corpus

            artifact = os.path.join(tmpdir, "spdx.corpus.npz")
            write_artifact(artifact, spdx_corpus(None), source="spdx")
            bad_source = os.path.join(tmpdir, "corrupt.corpus.npz")
            with open(bad_source, "wb") as f:
                f.write(b"definitely not a corpus artifact")
            targets = [artifact, "vendored", artifact]
            deny_source = None

        traffic = _ReloadTraffic(
            front_path, _client_blobs(stub), req_timeout
        )
        traffic.start()
        time.sleep(0.5)  # rows in flight before the first roll

        def roll(source: str, expect_ok: bool, label: str):
            nonlocal good_rolls
            out = supervisor.reload_fleet(
                source, timeout_s=req_timeout + 60.0,
                health_timeout_s=30.0, argv_patch=argv_patch,
            )
            if bool(out["ok"]) != expect_ok:
                problems.append(f"{label}: unexpected outcome {out}")
            if out.get("fingerprint"):
                allowed_fps.add(out["fingerprint"])
            if out["ok"]:
                good_rolls += 1
                fps = set(_fingerprints(supervisor).values())
                if fps != {out["fingerprint"]}:
                    problems.append(
                        f"{label}: fleet fingerprints diverged: {fps}"
                    )
            return out

        # -- roll 1: clean fleet-wide reload --
        out1 = roll(targets[0], True, "roll-1")
        fp_roll1 = out1.get("fingerprint")

        # -- crash-restart keeps the ROLLED corpus (argv patch) --
        pid = supervisor.workers["w0"].pid
        if pid:
            faults.kill(pid)
        if not _await_respawn(supervisor, "w0", boot_timeout + 10.0):
            problems.append("w0 never respawned after SIGKILL")
        elif stub:
            # a real serve worker re-compiles the artifact on respawn —
            # same fingerprint; the stub proves the argv patch directly
            got = _fingerprints(supervisor)["w0"]
            if got != fp_roll1:
                problems.append(
                    f"respawned w0 on {got!r}, fleet rolled to "
                    f"{fp_roll1!r} — restart rolled it back"
                )

        # -- corrupt-artifact roll: refused, fleet unmoved --
        before = _fingerprints(supervisor)
        roll(bad_source, False, "roll-corrupt")
        after = _fingerprints(supervisor)
        if before != after:
            problems.append(
                f"corrupt roll moved fingerprints: {before} -> {after}"
            )

        # -- refused-validation roll with automatic rollback (stub:
        #    w1 denies, w0 already swapped -> rolled back) --
        if deny_source is not None:
            # w0 swaps to the denied source before w1 refuses it, so a
            # few rows legitimately carry it until the rollback lands
            allowed_fps.add(deny_source)
            out_deny = roll(deny_source, False, "roll-deny")
            if not out_deny.get("rolled_back"):
                problems.append(f"deny roll did not roll back: {out_deny}")
            fps = set(_fingerprints(supervisor).values())
            if fps != set(before.values()):
                problems.append(
                    f"rollback left fleet on {fps}, wanted "
                    f"{set(before.values())}"
                )

        # -- roll 2 --
        roll(targets[1], True, "roll-2")

        # -- SIGKILL mid-swap (stub: the slow reload window) --
        if stub:
            fps_before_kill = _fingerprints(supervisor)
            allowed_fps.add("fp-mid-3")  # a late kill may land post-swap
            killer_done: list[dict] = []

            def slow_roll() -> None:
                killer_done.append(supervisor.reload_fleet(
                    "slow:1500:fp-mid-3", timeout_s=req_timeout + 60.0,
                    health_timeout_s=30.0, argv_patch=argv_patch,
                ))

            rt = threading.Thread(target=slow_roll, daemon=True)
            rt.start()
            time.sleep(0.4)  # w0 is mid-swap (sleeping in the verb)
            pid = supervisor.workers["w0"].pid
            if pid:
                faults.kill(pid)
            rt.join(timeout=req_timeout + 90.0)
            if not killer_done or killer_done[0].get("ok"):
                problems.append(
                    f"SIGKILL mid-swap roll reported ok: {killer_done}"
                )
            if not _await_respawn(supervisor, "w0", boot_timeout + 10.0):
                problems.append("w0 never respawned after mid-swap kill")
            else:
                fps = _fingerprints(supervisor)
                if set(fps.values()) != set(fps_before_kill.values()):
                    problems.append(
                        f"mid-swap kill left fleet on {fps}, wanted "
                        f"{fps_before_kill}"
                    )

        # -- roll 3 --
        roll(targets[2], True, "roll-3")

        if good_rolls < 3:
            problems.append(f"only {good_rolls} clean rolls (< 3)")

        time.sleep(0.5)  # post-roll traffic on the final corpus
        traffic.finish()
        errors = [r for r in traffic.rows if r.get("error")]
        errors = traffic.errors + [str(e)[:200] for e in errors]
        if errors:
            problems.append(
                f"{len(errors)} client-visible errors, e.g. {errors[:3]}"
            )
        if traffic.reconnects:
            problems.append(
                f"front socket dropped the client session "
                f"{traffic.reconnects} time(s)"
            )
        wrong = [
            r for r in traffic.rows
            if not r.get("error") and r.get("key") != want_key
        ]
        if wrong:
            problems.append(f"wrong verdicts, e.g. {wrong[:3]}")
        if len(traffic.rows) < 50:
            problems.append(
                f"only {len(traffic.rows)} traffic rows — the drill "
                "did not run under load"
            )
        unattributed = [
            r for r in traffic.rows
            if not r.get("error") and not r.get("corpus")
        ]
        if unattributed:
            problems.append(
                f"{len(unattributed)} responses carry no corpus "
                f"fingerprint, e.g. {unattributed[:2]}"
            )
        short_allowed = {
            short_fingerprint(fp) for fp in allowed_fps
        } | allowed_fps
        alien = [
            r for r in traffic.rows
            if r.get("corpus") and r["corpus"] not in short_allowed
        ]
        if alien:
            problems.append(
                f"{len(alien)} responses attributed to an unknown "
                f"corpus, e.g. {alien[:2]} (known: {sorted(short_allowed)})"
            )
    except _Abort:
        pass
    except Exception as exc:  # noqa: BLE001 — selftest must report, not die
        problems.append(f"selftest crashed: {type(exc).__name__}: {exc}")
    finally:
        if traffic is not None and not traffic.stop.is_set():
            traffic.finish()
        if server is not None:
            server.shutdown()
            server.server_close()
        if server_thread is not None:
            server_thread.join(timeout=5.0)
        router.close()
        supervisor.stop()
    if verbose:
        summary = {
            "reload_fleet_selftest": "ok" if not problems else "FAIL",
            "stub_workers": stub,
            "clean_rolls": good_rolls,
            "traffic_rows": len(traffic.rows) if traffic else 0,
            "problems": problems,
        }
        sys.stderr.write(json.dumps(summary) + "\n")
    return 0 if not problems else 1


def _free_port() -> int:
    """Lease one loopback TCP port (bind :0, read, close).  A race
    against another process grabbing the port between close and our
    bind exists in principle; on a CI loopback it is noise-level, and
    the selftest reports a bind failure honestly if it ever loses."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]
    finally:
        sock.close()


class _HttpClient:
    """A sequential HTTP/1.1 keep-alive client for the federation
    drill: one TCP connection, one POST round trip at a time, real
    status-line + Content-Length parsing (the drill gates on status
    codes, so counting newlines is not enough)."""

    def __init__(self, target: str, token: str | None,
                 timeout_s: float):
        from licensee_tpu_torch.fleet.faults import _dial_stream

        self.sock = _dial_stream(target, timeout_s=timeout_s)
        self.reader = self.sock.makefile("rb")
        self.token = token

    def post(self, path: str, body: bytes) -> tuple[int, dict, bytes]:
        auth = (
            f"Authorization: Bearer {self.token}\r\n" if self.token else ""
        )
        head = (
            f"POST {path} HTTP/1.1\r\n"
            f"Host: edge\r\n{auth}"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n"
        ).encode("utf-8")
        self.sock.sendall(head + body)
        status_line = self.reader.readline()
        parts = status_line.decode("utf-8", "replace").split(" ", 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise OSError(f"bad status line {status_line!r}")
        code = int(parts[1])
        headers: dict = {}
        while True:
            line = self.reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode(
                "utf-8", "replace"
            ).partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0"))
        payload = self.reader.read(length) if length else b""
        return code, headers, payload

    def close(self) -> None:
        try:
            self.reader.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def _edge_burst(
    edge_target: str, token: str, problems: list[str],
    rate: float = 600.0, duration_s: float = 1.0, n_conns: int = 2,
) -> dict:
    """The HTTP open-loop burst through the real edge: subprocess
    clients write pipelined keep-alive POSTs at a fixed arrival rate.
    Gates: every request answered, all 200s, no stalled client."""
    import subprocess

    procs = []
    for _ in range(n_conns):
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "licensee_tpu_torch.fleet.faults",
                "--open-loop-http", edge_target,
                "--rate", str(rate / n_conns),
                "--duration-s", str(duration_s),
                "--token", token,
            ],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        )
        procs.append(proc)
    results = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=duration_s + 60.0)
            results.append(json.loads(stdout))
        except Exception:  # noqa: BLE001 — a dead client is a finding below
            p.kill()
    sent = sum(r["sent"] for r in results)
    answered = sum(r["answered"] for r in results)
    non_200 = sum(r.get("non_200") or 0 for r in results)
    stalled = any(r["stalled"] for r in results) or (
        len(results) < n_conns
    )
    if stalled or answered != sent:
        problems.append(
            f"HTTP burst stalled: {answered}/{sent} answered "
            f"({len(results)}/{n_conns} clients reported)"
        )
    if non_200:
        problems.append(f"HTTP burst saw {non_200} non-200 responses")
    send_elapsed = max(
        (r.get("send_elapsed_s") or 0.0 for r in results), default=0.0
    )
    return {
        "sent": sent,
        "answered": answered,
        "non_200": non_200,
        "offered_rps": round(sent / send_elapsed, 1)
        if send_elapsed else None,
    }


def selftest_tcp(
    verbose: bool = True,
    stub: bool = True,
    n_domains: int = 2,
    workers_per_domain: int = 1,
    n_requests: int = 120,
    device: str = "cuda",
) -> int:
    """The cross-host federation selftest (``licensee-tpu-torch fleet
    --selftest-tcp``): ``n_domains`` supervisor domains — each a
    supervisor, its worker(s), a domain router, and a domain front
    server, ALL on loopback TCP — federated behind one front router
    (``merge_label="host"``) and the HTTP/1.1 edge.  The drills:

    * an HTTP open-loop keep-alive burst through the edge: every
      request answers 200, no stalled client;
    * SIGKILL of one domain's worker mid-stream: ZERO client-visible
      errors — the domain answers ``no_backend_available`` fast and
      the FRONT router fails the attempt over to the other host (the
      federated failover path), while the domain's supervisor respawns
      the worker and the host rejoins;
    * auth: a wrong bearer token answers 401 without touching a
      backend;
    * a slowloris dribbling HTTP HEADERS over TCP is reaped by the
      stall sweep while the drill traffic keeps answering;
    * the front router's merged exposition nests ``host=`` outside the
      per-domain ``worker=`` labels and parses clean.

    ``stub=True`` (the CI path) runs protocol-faithful stub workers
    over TCP; ``stub=False`` boots real serve workers on TCP ports, on
    ``device``."""
    problems: list[str] = []
    burst: dict | None = None
    boot_timeout = 20.0 if stub else 240.0
    req_timeout = 10.0 if stub else 120.0
    token = "edge-selftest-token"
    domains: list[dict] = []
    front_router = None
    edge = None
    edge_thread = None
    statuses: list[int] = []

    def stub_tcp_argv(name: str, target: str) -> list[str]:
        return [
            sys.executable, "-m", "licensee_tpu_torch.fleet.faults",
            "--socket", target, "--name", name, "--service-ms", "5",
        ]

    def serve_tcp_argv(name: str, target: str) -> list[str]:
        return [
            sys.executable, "-m", "licensee_tpu_torch.cli.main", "serve",
            "--socket", target, "--max-delay-ms", "5",
            "--device", device,
        ]

    env = worker_env(None, None)
    try:
        # -- boot the per-host supervisor domains --
        for d in range(n_domains):
            workers = {
                f"d{d}w{i}": f"127.0.0.1:{_free_port()}"
                for i in range(workers_per_domain)
            }
            # the restart backoff is LONGER than the domain's dispatch
            # deadline below, so a killed worker's domain provably
            # answers no_backend_available before its replacement
            # boots — the drill must exercise the CROSS-HOST failover
            # path, not win a race against the local respawn.  Real
            # workers too: one re-boots in seconds, inside a longer
            # deadline, and the drill would then see no failover
            supervisor = Supervisor(
                workers,
                argv_for=(stub_tcp_argv if stub else serve_tcp_argv),
                env_for=lambda name, chips: env,
                probe_interval_s=0.25,
                backoff_base_s=1.5,
                backoff_max_s=3.0,
                startup_grace_s=boot_timeout,
            )
            # dispatch_wait_s is SHORT on the domain tier: a domain
            # with its worker down must answer no_backend_available
            # quickly so the front tier fails over to another host,
            # instead of parking the request until the local respawn
            router = Router(
                workers,
                supervisor=supervisor,
                probe_interval_s=0.1,
                request_timeout_s=req_timeout,
                dispatch_wait_s=1.0,
                trace_sample=0.0,
            )
            domains.append({
                "supervisor": supervisor,
                "router": router,
                "front_target": None,
                "server": None,
                "thread": None,
            })
        for dom in domains:
            dom["supervisor"].start()
        for d, dom in enumerate(domains):
            if not dom["supervisor"].wait_healthy(boot_timeout):
                problems.append(
                    f"domain {d} workers never became healthy: "
                    f"{dom['supervisor'].status()}"
                )
                raise _Abort()
            dom["router"].start()
            # in-process listeners lease their ports race-free: bind
            # :0, read bound_port (only the worker SUBPROCESS targets
            # above need the close-then-rebind _free_port lease)
            dom["server"] = FrontServer(
                "127.0.0.1:0", dom["router"], stall_timeout_s=2.0
            )
            dom["front_target"] = f"127.0.0.1:{dom['server'].bound_port}"
            dom["thread"] = threading.Thread(
                target=dom["server"].serve_forever,
                kwargs={"poll_interval": 0.05}, daemon=True,
            )
            dom["thread"].start()

        # -- the federation tier: one front router over the domains --
        hosts = {
            f"host{d}": dom["front_target"]
            for d, dom in enumerate(domains)
        }
        front_router = Router(
            hosts,
            probe_interval_s=0.1,
            request_timeout_s=req_timeout + 5.0,
            dispatch_wait_s=req_timeout + 30.0,
            trace_sample=0.0,
            merge_label="host",
        )
        front_router.start()
        edge = HttpEdgeServer(
            "127.0.0.1:0", front_router,
            tokens={token: "drill"},
            rate_per_client=100000.0,
            stall_timeout_s=2.0,
        )
        edge_target = f"127.0.0.1:{edge.bound_port}"
        edge_thread = threading.Thread(
            target=edge.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True,
        )
        edge_thread.start()

        # -- HTTP open-loop burst through the edge --
        burst = _edge_burst(
            edge_target, token, problems,
            rate=600.0 if stub else 60.0,
        )

        # -- auth: a wrong token answers 401, backends untouched --
        client = _HttpClient(edge_target, "wrong-token", req_timeout)
        try:
            code, _hdrs, _body = client.post(
                "/classify", b'{"content": "auth probe"}'
            )
        finally:
            client.close()
        if code != 401:
            problems.append(f"bad token answered {code}, wanted 401")

        # -- SIGKILL one host's worker mid-stream: zero client errors,
        #    the front tier fails over across hosts --
        loris = faults.Slowloris(
            edge_target, mode="dribble", byte_interval_s=0.25,
            give_up_s=30.0,
            payload=b"POST /classify HTTP/1.1\r\nHost: edge\r\nContent-Le",
        )
        loris_box: dict = {}
        loris_thread = threading.Thread(
            target=lambda: loris_box.update(loris.run()), daemon=True
        )
        loris_thread.start()
        victim = domains[0]["supervisor"]
        kill_at = n_requests // 3
        client = _HttpClient(edge_target, token, req_timeout + 30.0)
        traces = set()
        try:
            for i in range(n_requests):
                body = json.dumps(
                    {"id": i, "content": f"federation drill {i}"}
                ).encode("utf-8")
                code, hdrs, _payload = client.post("/classify", body)
                statuses.append(code)
                if hdrs.get("x-trace-id"):
                    traces.add(hdrs["x-trace-id"])
                if i + 1 == kill_at:
                    handle = next(iter(victim.workers.values()))
                    if handle.pid is None:
                        problems.append("victim worker had no pid")
                    else:
                        faults.kill(handle.pid)
        except OSError as exc:
            problems.append(f"drill client failed: {exc}")
        finally:
            client.close()
        bad = [c for c in statuses if c != 200]
        if bad:
            problems.append(
                f"{len(bad)} non-200 responses during the SIGKILL "
                f"drill (e.g. {bad[:5]}) — a client saw the failure"
            )
        if len(statuses) != n_requests:
            problems.append(
                f"drill answered {len(statuses)}/{n_requests} requests"
            )
        if not traces:
            problems.append(
                "no X-Trace-Id header echoed — the telemetry plane "
                "does not span the edge"
            )
        # -- the front tier actually failed over across hosts --
        fstats = front_router.stats()["router"]
        if fstats["failovers"] + fstats["retries"] < 1:
            problems.append(
                f"no cross-host failover recorded — did the kill "
                f"land? {fstats}"
            )
        # -- the dead worker rejoined its domain --
        name = next(iter(victim.workers))
        deadline = time.perf_counter() + boot_timeout
        revived = False
        while time.perf_counter() < deadline:
            handle = victim.workers[name]
            if handle.restarts >= 1 and victim.probe(name) is not None:
                revived = True
                break
            time.sleep(0.1)
        if not revived:
            problems.append(
                f"domain-0 worker never rejoined: {victim.status()}"
            )
        health = victim.host_health()
        if not health.get("serving"):
            problems.append(f"domain-0 host health not serving: {health}")
        loris_thread.join(timeout=40.0)
        if not loris_box.get("reaped"):
            problems.append(
                f"HTTP header slowloris was not reaped: {loris_box}"
            )
        # -- merged exposition: host label OUTSIDE worker label --
        exposition = front_router.prometheus()
        grammar = check_exposition(exposition)
        if grammar:
            problems.append(f"merged exposition grammar: {grammar[:3]}")
        if 'host="host1"' not in exposition:
            problems.append("merged exposition missing host labels")
        if not re.search(r'host="host\d",worker="', exposition):
            problems.append(
                "merged exposition does not nest host= outside the "
                "per-domain worker= labels"
            )
    except _Abort:
        pass
    except Exception as exc:  # noqa: BLE001 — selftest must report, not die
        problems.append(f"selftest crashed: {type(exc).__name__}: {exc}")
    finally:
        if edge is not None:
            edge.shutdown()
            edge.server_close()
        if edge_thread is not None:
            edge_thread.join(timeout=5.0)
        if front_router is not None:
            front_router.close()
        for dom in domains:
            if dom["server"] is not None:
                dom["server"].shutdown()
                dom["server"].server_close()
            if dom["thread"] is not None:
                dom["thread"].join(timeout=5.0)
            dom["router"].close()
            dom["supervisor"].stop()
    if verbose:
        summary = {
            "fleet_tcp_selftest": "ok" if not problems else "FAIL",
            "stub_workers": stub,
            "domains": n_domains,
            "burst": burst,
            "drill_requests": len(statuses),
            "problems": problems,
        }
        sys.stderr.write(json.dumps(summary) + "\n")
    return 0 if not problems else 1


def _drive_traffic(
    front_path: str,
    blobs: list[str],
    n_requests: int,
    supervisor: Supervisor,
    problems: list[str],
    read_timeout: float,
    kill_at_fraction: float = 1.0 / 3.0,
) -> list[dict]:
    """Stream ``n_requests`` through the front socket from a writer
    thread, SIGKILL worker w0 once a third of the stream is out, and
    collect every response row."""
    kill_at = max(1, int(n_requests * kill_at_fraction))
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    f = None
    try:
        sock.connect(front_path)
        sock.settimeout(read_timeout)
        f = sock.makefile("rwb")
        stream = f

        def writer() -> None:
            try:
                for i in range(n_requests):
                    line = json.dumps({
                        "id": i,
                        "content": blobs[i % len(blobs)],
                        "filename": "LICENSE",
                    })
                    stream.write(line.encode("utf-8") + b"\n")
                    stream.flush()
                    if i + 1 == kill_at:
                        pid = supervisor.workers["w0"].pid
                        if pid is None:
                            problems.append("w0 had no pid at kill time")
                        else:
                            faults.kill(pid)
                    # unpaced burst right before the kill: the paced
                    # stream can be fully drained at kill time (the
                    # probe conn's EOF flips the backend unhealthy the
                    # same instant, so nothing would ever fail over) —
                    # the gate wants the kill to land WITH requests in
                    # flight on the victim
                    if not (kill_at - 10 <= i + 1 < kill_at):
                        time.sleep(0.005)
            except OSError as exc:
                problems.append(f"client writer failed: {exc}")

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
        rows: list[dict] = []
        try:
            for _ in range(n_requests):
                raw = f.readline()
                if not raw:
                    problems.append(
                        f"front socket closed after {len(rows)} responses"
                    )
                    break
                rows.append(
                    json.loads(raw.decode("utf-8", errors="replace"))
                )
        except (OSError, ValueError) as exc:
            problems.append(f"client reader failed: {exc}")
        wt.join(timeout=read_timeout)
        return rows
    finally:
        # close on EVERY path (the static resource-leak rule's point):
        # a reader failure must not leak the session socket into the
        # next selftest stage
        try:
            if f is not None:
                f.close()
            sock.close()
        except OSError:
            pass


def _err_code(row: dict) -> str | None:
    """The error-code prefix of a response row, or None."""
    err = row.get("error")
    if not isinstance(err, str):
        return None
    return err.split(":", 1)[0]


class _TenantTraffic:
    """Continuous per-tenant HTTP traffic through the edge for the
    tenancy drill: sequential keep-alive POSTs under one bearer token,
    every answer collected (status + parsed body row, so the gates can
    read the worker name and corpus fingerprint each answer carries)."""

    def __init__(self, edge_target: str, token: str, timeout_s: float):
        self.edge_target = edge_target
        self.token = token
        self.timeout_s = timeout_s
        self.rows: list[dict] = []
        self.errors: list[str] = []
        self.reconnects = 0
        self.stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def finish(self) -> None:
        self.stop.set()
        self._thread.join(timeout=self.timeout_s + 10.0)

    def _run(self) -> None:
        client = None
        i = 0
        while not self.stop.is_set():
            try:
                if client is None:
                    client = _HttpClient(
                        self.edge_target, self.token, self.timeout_s
                    )
                body = json.dumps({
                    "id": i,
                    "content": f"tenant drill {self.token} {i}",
                }).encode("utf-8")
                code, _hdrs, payload = client.post("/classify", body)
                try:
                    row = json.loads(payload.decode("utf-8", "replace"))
                except ValueError:
                    row = {}
                if not isinstance(row, dict):
                    row = {}
                row["_status"] = code
                self.rows.append(row)
                i += 1
            except OSError as exc:
                # the edge must never drop a keep-alive session during
                # a roll or an in-pool failover: reconnects are counted
                # as findings, a failure on a fresh connection is hard
                if client is None:
                    self.errors.append(str(exc))
                    self.stop.wait(0.2)
                else:
                    self.reconnects += 1
                    client.close()
                    client = None
            time.sleep(0.005)
        if client is not None:
            client.close()


def selftest_tenant(
    verbose: bool = True,
    stub: bool = True,
    workers_per_pool: int = 2,
    device: str = "cuda",
) -> int:
    """The multi-tenant serving selftest (``fleet --selftest-tenant``):
    two tenants with DISJOINT corpora on separate
    worker pools behind one router and one HTTP edge, drilled under
    live traffic.  The gates:

    * tagged routing: a ``corpus`` tag (tenant name, pool name, or
      fingerprint) lands on the right pool, untagged rows fall back to
      the default pool, an unknown tag answers ``unknown_corpus``;
    * ZERO cross-tenant rows: every answer a tenant's token receives
      stamps that tenant's corpus fingerprint and a worker from that
      tenant's pool — across an upload-roll and a SIGKILL;
    * self-serve onboarding: an authenticated ``POST /corpus`` from
      tenant A validates, journals, and rolls A's pool zero-downtime
      while tenant B's traffic keeps answering inside its latency SLO;
    * auth: a wrong bearer token answers 401; a valid token bound to
      no tenant answers 403 on ``POST /corpus``; a garbage artifact
      answers 400 ``corpus_invalid`` without touching the fleet;
    * SIGKILL of one pool's worker fails over ONLY inside that pool
      with zero client-visible errors, and the worker rejoins;
    * crash recovery: a dangling journaled ``roll_start`` is replayed
      by a fresh onboarder and the pool lands on the rolled corpus.

    ``stub=True`` (the CI path) runs protocol-faithful stub workers
    whose "corpus" is the fingerprint string their reload installs;
    ``stub=False`` boots the port's serve workers on ``device``, pool
    acme on the vendored corpus (T=47) and pool beta on a 608-template
    synthetic SPDX directory (`corpus/spdx_synth.py`), and onboards a
    real corpus artifact."""
    from licensee_tpu_torch.tenancy import (
        CorpusOnboarder, OnboardError, Tenant, TenantPools,
        TenantRegistry,
    )

    problems: list[str] = []
    tmpdir = tempfile.mkdtemp(prefix="licensee-tenant-fleet-")
    boot_timeout = 20.0 if stub else 240.0
    req_timeout = 10.0 if stub else 120.0
    pool_names = ("acme", "beta")
    pool_sockets = {
        pool: {
            f"{pool}{i}": os.path.join(tmpdir, f"{pool}{i}.sock")
            for i in range(workers_per_pool)
        }
        for pool in pool_names
    }
    if stub:
        boot_corpus = {"acme": "fp-acme-1", "beta": "fp-beta-1"}

        def argv_for(name: str, sock: str) -> list[str]:
            pool = name.rstrip("0123456789")
            return [
                sys.executable, "-m", "licensee_tpu_torch.fleet.faults",
                "--socket", sock, "--name", name, "--service-ms", "5",
                "--fingerprint", boot_corpus[pool],
            ]
    else:
        from licensee_tpu_torch.corpus.spdx_synth import synth_spdx_dir

        boot_corpus = {
            "acme": "vendored",
            "beta": synth_spdx_dir(os.path.join(tmpdir, "spdx608")),
        }

        def argv_for(name: str, sock: str) -> list[str]:
            pool = name.rstrip("0123456789")
            return _serve_argv(name, sock, device) + [
                "--corpus", boot_corpus[pool]
            ]

    env = worker_env(None, None)
    pools = TenantPools({
        pool: Supervisor(
            sockets,
            argv_for=argv_for,
            env_for=lambda name, chips: env,
            probe_interval_s=0.25,
            backoff_base_s=0.25,
            backoff_max_s=2.0,
            startup_grace_s=boot_timeout,
        )
        for pool, sockets in pool_sockets.items()
    }, default_pool="acme")
    router = Router(
        pools.workers,
        supervisor=pools,
        probe_interval_s=0.25,
        request_timeout_s=req_timeout,
        dispatch_wait_s=req_timeout + 30.0,
        trace_sample=0.0,
        pools=pools.worker_pools(),
        default_pool="acme",
    )
    registry = TenantRegistry(
        os.path.join(tmpdir, "tenants.json"), create=True
    )
    registry.set_tenant(
        Tenant("acme", "tok-acme", boot_corpus["acme"]), save=False
    )
    registry.set_tenant(Tenant("beta", "tok-beta", boot_corpus["beta"]))
    front_path = os.path.join(tmpdir, "front.sock")
    server = None
    server_thread = None
    edge = None
    edge_thread = None
    traffic: dict[str, _TenantTraffic] = {}
    onboard_result: dict | None = None
    recovered: list[dict] = []
    try:
        pools.start()
        if not pools.wait_healthy(boot_timeout):
            problems.append(
                f"pools never became healthy: {pools.status()}"
            )
            raise _Abort()
        router.start()

        if stub:
            def validator(path: str) -> str:
                with open(path, encoding="utf-8", errors="replace") as fh:
                    text = fh.read().strip()
                if not text.startswith("fp-"):
                    raise ValueError(
                        f"stub artifact must start with 'fp-', got "
                        f"{text[:20]!r}"
                    )
                return text

            onboarder = CorpusOnboarder(
                registry, pools, router,
                staging_dir=os.path.join(tmpdir, "staging"),
                validator=validator,
                source_for=lambda path, fp: fp,
                reload_kwargs={
                    "timeout_s": req_timeout + 60.0,
                    "health_timeout_s": 30.0,
                    "argv_patch": _patch_stub_argv,
                },
            )
            pool_fps = dict(boot_corpus)
        else:
            onboarder = CorpusOnboarder(
                registry, pools, router,
                staging_dir=os.path.join(tmpdir, "staging"),
                reload_kwargs={
                    "timeout_s": req_timeout + 60.0,
                    "health_timeout_s": 30.0,
                },
            )
            fps = _fingerprints(pools)
            owners = pools.worker_pools()
            pool_fps = {
                owners[name]: fp
                for name, fp in fps.items() if fp
            }
            if set(pool_fps) != set(pool_names):
                problems.append(
                    f"workers report no fingerprints: {fps}"
                )
                raise _Abort()
        onboarder.sync_routes(fingerprints=pool_fps)

        server = FrontServer(front_path, router, stall_timeout_s=2.0)
        server_thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True,
        )
        server_thread.start()
        edge_tokens = dict(registry.tokens())
        edge_tokens["tok-anon"] = "anon"  # valid token, no tenant
        edge = HttpEdgeServer(
            "127.0.0.1:0", router,
            tokens=edge_tokens,
            tenancy=onboarder,
            rate_per_client=100000.0,
            stall_timeout_s=2.0,
        )
        edge_target = f"127.0.0.1:{edge.bound_port}"
        edge_thread = threading.Thread(
            target=edge.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True,
        )
        edge_thread.start()

        workers_of = {
            pool: set(socks) for pool, socks in pool_sockets.items()
        }
        fp_observed: dict[str, set] = {pool: set() for pool in pool_names}

        def allowed_fps(pool: str, *fps) -> set:
            out = set()
            for fp in fps:
                if fp:
                    out.add(fp)
                    short = short_fingerprint(fp)
                    if short:
                        out.add(short)
            return out

        def check_row(label: str, row: dict, pool: str,
                      allowed: set) -> None:
            if _err_code(row) is not None:
                problems.append(f"{label}: error row {row}")
                return
            worker = row.get("worker")
            if worker not in workers_of[pool]:
                problems.append(
                    f"{label}: answered by {worker!r}, not a {pool} "
                    f"pool worker"
                )
            fp = row.get("corpus")
            fp_observed[pool].add(fp)
            if fp not in allowed:
                problems.append(
                    f"{label}: stamps corpus {fp!r}, allowed "
                    f"{sorted(allowed)}"
                )

        # -- phase 1: tagged JSONL routing through the front socket --
        probe_timeout = req_timeout + 30.0
        for tag, pool in (
            ("acme", "acme"),             # tenant name
            ("beta", "beta"),
            (pool_fps["beta"], "beta"),   # full fingerprint
            (None, "acme"),               # untagged -> default pool
        ):
            msg: dict = {"id": 1, "content": f"probe {tag}"}
            if tag is not None:
                msg["corpus"] = tag
            row = oneshot(front_path, msg, probe_timeout)
            check_row(
                f"tagged probe {tag!r}", row, pool,
                allowed_fps(pool, pool_fps[pool]),
            )
        row = oneshot(
            front_path,
            {"id": 1, "content": "probe", "corpus": "no-such-tenant"},
            probe_timeout,
        )
        if _err_code(row) != "unknown_corpus":
            problems.append(
                f"unknown corpus tag answered {row}, wanted an "
                f"unknown_corpus error"
            )

        # -- phase 2: live per-tenant HTTP traffic, then an upload-roll
        #    of tenant acme mid-stream --
        for name, token in (("acme", "tok-acme"), ("beta", "tok-beta")):
            traffic[name] = _TenantTraffic(
                edge_target, token, req_timeout + 30.0
            )
            traffic[name].start()
        time.sleep(0.6 if stub else 2.0)

        if stub:
            upload_blob = b"fp-acme-2"
        else:
            from licensee_tpu_torch.corpus.artifact import write_artifact
            from licensee_tpu_torch.corpus.compiler import default_corpus

            artifact_path = os.path.join(tmpdir, "upload.corpus.npz")
            write_artifact(
                artifact_path, default_corpus(), source="vendored"
            )
            with open(artifact_path, "rb") as fh:
                upload_blob = fh.read()
        import base64 as _b64

        upload_body = json.dumps({
            "artifact_b64": _b64.b64encode(upload_blob).decode("ascii"),
            "name": "upload.corpus.npz",
        }).encode("utf-8")
        client = _HttpClient(
            edge_target, "tok-acme", req_timeout + 120.0
        )
        try:
            code, _hdrs, payload = client.post("/corpus", upload_body)
        finally:
            client.close()
        if code != 200:
            problems.append(
                f"corpus upload answered {code}: {payload[:300]!r}"
            )
        else:
            onboard_result = (
                json.loads(payload.decode("utf-8", "replace"))
            ).get("corpus") or {}
            if onboard_result.get("pool") != "acme":
                problems.append(
                    f"upload rolled pool {onboard_result.get('pool')!r},"
                    f" wanted 'acme'"
                )
        rolled_fp = (onboard_result or {}).get("fingerprint")
        if stub and rolled_fp != "fp-acme-2":
            problems.append(
                f"upload rolled to {rolled_fp!r}, wanted 'fp-acme-2'"
            )
        time.sleep(0.4 if stub else 2.0)

        # -- phase 3: SIGKILL one beta worker under traffic: in-pool
        #    failover only, zero client-visible errors --
        victim = pools.pools["beta"]
        pid = victim.workers["beta0"].pid
        # the failover gate below wants the kill to land with a request
        # in flight on the victim; beta's one sequential client leaves
        # beta0 idle most of the time, and a kill in an idle moment is
        # seen by the router's probe first (no failover, no retry), so
        # the kill waits (at most 5 s) for an outstanding request there
        # (a port deviation: the JAX drill kills at once and fails its
        # own gate about one run in six on a loaded host)
        deadline = time.perf_counter() + 5.0
        while router.backends["beta0"].outstanding == 0 and \
                time.perf_counter() < deadline:
            time.sleep(0.0002)
        if pid is None:
            problems.append("beta0 had no pid at kill time")
        else:
            faults.kill(pid)
        if not _await_respawn(victim, "beta0", boot_timeout + 10.0):
            problems.append("beta0 never respawned after SIGKILL")
        time.sleep(0.4 if stub else 2.0)
        for t in traffic.values():
            t.finish()

        # -- the cross-tenant fence, across roll AND kill --
        acme_allowed = allowed_fps("acme", pool_fps["acme"], rolled_fp)
        beta_allowed = allowed_fps("beta", pool_fps["beta"])
        for name, allowed in (
            ("acme", acme_allowed), ("beta", beta_allowed),
        ):
            t = traffic[name]
            if t.errors:
                problems.append(
                    f"{name} traffic errors: {t.errors[:3]}"
                )
            if t.reconnects:
                problems.append(
                    f"{name} edge session dropped {t.reconnects} time(s)"
                )
            bad = [r for r in t.rows if r.get("_status") != 200]
            if bad:
                problems.append(
                    f"{name}: {len(bad)} non-200 answers, e.g. {bad[:3]}"
                )
            if len(t.rows) < 20:
                problems.append(
                    f"{name}: only {len(t.rows)} rows — the drill did "
                    f"not run under load"
                )
            for row in t.rows:
                if row.get("_status") != 200:
                    continue
                check_row(f"{name} traffic", row, name, allowed)
        if stub and "fp-acme-2" not in fp_observed["acme"]:
            problems.append(
                "acme traffic never reached the rolled corpus "
                f"(saw {sorted(fp_observed['acme'])})"
            )
        crossed = fp_observed["acme"] & fp_observed["beta"]
        if crossed:
            problems.append(
                f"cross-tenant fingerprints observed: {sorted(crossed)}"
            )

        # -- tenant B's latency SLO survived tenant A's roll --
        slo = router.stats().get("slo") or {}
        beta_slo = (
            (slo.get("objectives") or {}).get("pool_beta_latency_p99")
            or {}
        )
        if not beta_slo:
            problems.append(f"router stats carries no beta pool SLO: {slo}")
        else:
            if not (beta_slo.get("good") or 0) > 0:
                problems.append(f"beta pool SLO saw no traffic: {beta_slo}")
            max_burn = beta_slo.get("max_burn")
            if max_burn is None or not (max_burn < 1.0):
                problems.append(
                    f"beta latency SLO breached during acme's roll: "
                    f"max_burn={max_burn}"
                )
        # -- the kill actually exercised failover --
        rstats = router.stats()["router"]
        if rstats["failovers"] + rstats["retries"] < 1:
            problems.append(
                f"no failover recorded — did the kill land? {rstats}"
            )

        # -- auth probes --
        client = _HttpClient(edge_target, "wrong-token", req_timeout)
        try:
            code, _h, _b = client.post(
                "/classify", b'{"content": "auth probe"}'
            )
        finally:
            client.close()
        if code != 401:
            problems.append(f"bad token answered {code}, wanted 401")
        client = _HttpClient(edge_target, "tok-anon", req_timeout)
        try:
            code, _h, _b = client.post("/corpus", upload_body)
        finally:
            client.close()
        if code != 403:
            problems.append(
                f"tenant-less token answered {code} on POST /corpus, "
                f"wanted 403"
            )
        garbage = json.dumps({
            "artifact_b64": _b64.b64encode(
                b"garbage, not an artifact"
            ).decode("ascii"),
        }).encode("utf-8")
        client = _HttpClient(edge_target, "tok-acme", req_timeout + 60.0)
        try:
            code, _h, body = client.post("/corpus", garbage)
        finally:
            client.close()
        bad_row = {}
        try:
            bad_row = json.loads(body.decode("utf-8", "replace"))
        except ValueError:
            pass
        if code != 400 or _err_code(bad_row) != "corpus_invalid":
            problems.append(
                f"garbage artifact answered {code} {bad_row}, wanted "
                f"400 corpus_invalid"
            )

        # -- phase 4 (stub): crash recovery — a dangling journaled
        #    roll_start is replayed by a FRESH onboarder at boot --
        if stub:
            registry.record_roll(
                "roll_start", "acme",
                corpus="fp-acme-3", fingerprint="fp-acme-3",
            )
            recovery = CorpusOnboarder(
                registry, pools, router,
                staging_dir=os.path.join(tmpdir, "staging"),
                validator=validator,
                source_for=lambda path, fp: fp,
                reload_kwargs={
                    "timeout_s": req_timeout + 60.0,
                    "health_timeout_s": 30.0,
                    "argv_patch": _patch_stub_argv,
                },
            )
            try:
                recovered = recovery.recover()
            except OnboardError as exc:
                problems.append(f"journal recovery raised: {exc}")
            if len(recovered) != 1 or (
                recovered[0].get("fingerprint") != "fp-acme-3"
            ):
                problems.append(
                    f"journal recovery did not replay the dangling "
                    f"roll: {recovered}"
                )
            fps_now = {
                fp for name, fp in _fingerprints(pools).items()
                if name in workers_of["acme"]
            }
            if fps_now != {"fp-acme-3"}:
                problems.append(
                    f"recovered acme pool serves {fps_now}, wanted "
                    "{'fp-acme-3'}"
                )
            if router.pool_fingerprints().get("acme") != "fp-acme-3":
                problems.append(
                    f"router fence not re-armed after recovery: "
                    f"{router.pool_fingerprints()}"
                )
            if registry.pending_rolls():
                problems.append(
                    f"journal still pending after recovery: "
                    f"{registry.pending_rolls()}"
                )
    except _Abort:
        pass
    except Exception as exc:  # noqa: BLE001 — selftest must report, not die
        problems.append(f"selftest crashed: {type(exc).__name__}: {exc}")
    finally:
        for t in traffic.values():
            if not t.stop.is_set():
                t.finish()
        if edge is not None:
            edge.shutdown()
            edge.server_close()
        if edge_thread is not None:
            edge_thread.join(timeout=5.0)
        if server is not None:
            server.shutdown()
            server.server_close()
        if server_thread is not None:
            server_thread.join(timeout=5.0)
        router.close()
        pools.stop()
        registry.close()
    if verbose:
        summary = {
            "tenant_fleet_selftest": "ok" if not problems else "FAIL",
            "stub_workers": stub,
            "device": device,
            "traffic_rows": {
                name: len(t.rows) for name, t in traffic.items()
            },
            "onboarded": onboard_result,
            "recovered": recovered,
            "problems": problems,
        }
        sys.stderr.write(json.dumps(summary) + "\n")
    return 0 if not problems else 1
