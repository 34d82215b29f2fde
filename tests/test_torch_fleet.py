"""The port's fleet tier against the JAX package's, on the CPU.

Each scenario runs twice, once over the JAX package's router, supervisor
and protocol-faithful stub workers (`licensee_tpu.fleet.faults`, real
processes on real Unix sockets, real SIGKILL and SIGSTOP), once over the
port's (`licensee_tpu_torch.fleet`), and the outcomes must be equal:
answers, least-loaded dispatch, failover through a SIGKILL, queue-full
failover and surfacing, hedge winner and loser accounting, trace
propagation, the front socket's session, supervisor restart, backoff,
wedge kill, drain, add and remove, and `reload_fleet`'s rolls, rollback
and refusals.  What depends on timing (trace IDs, latencies, how many
requests were in flight at a kill) is masked or reduced to the fact the
scenario is about.  The HTTP edge's answers are compared byte for byte
(status line, headers, body; trace IDs and fingerprints masked), the two
503s of an edge built without the jobs and tenancy tiers included, and
the `fleet` verb's argument errors and its tenancy and jobs flags
against the JAX CLI's.  Every test runs under the
lock-order sanitizer, as the JAX package's fleet tests do."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import types

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest

import licensee_tpu.fleet.faults as jax_faults
import licensee_tpu.fleet.http_edge as jax_edge
import licensee_tpu.fleet.router as jax_router
import licensee_tpu.fleet.supervisor as jax_supervisor
import licensee_tpu.fleet.wire as jax_wire
import licensee_tpu_torch.fleet.faults as port_faults
import licensee_tpu_torch.fleet.http_edge as port_edge
import licensee_tpu_torch.fleet.router as port_router
import licensee_tpu_torch.fleet.supervisor as port_supervisor
import licensee_tpu_torch.fleet.wire as port_wire
from licensee_tpu.cli.main import main as jax_main
from licensee_tpu_torch.cli.main import main as port_main

pytestmark = pytest.mark.usefixtures("lock_order_sanitizer")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB_ENV = {**os.environ, "PYTHONPATH": REPO}

JAX = types.SimpleNamespace(
    name="jax", stub="licensee_tpu.fleet.faults", faults=jax_faults,
    Router=jax_router.Router, FrontServer=jax_router.FrontServer,
    Supervisor=jax_supervisor.Supervisor, edge=jax_edge,
    oneshot=jax_wire.oneshot, WireError=jax_wire.WireError)
PORT = types.SimpleNamespace(
    name="port", stub="licensee_tpu_torch.fleet.faults", faults=port_faults,
    Router=port_router.Router, FrontServer=port_router.FrontServer,
    Supervisor=port_supervisor.Supervisor, edge=port_edge,
    oneshot=port_wire.oneshot, WireError=port_wire.WireError)
TRACE_RE = re.compile(r"\b[0-9a-f]{16}\b")


def stub_argv(side, sock: str, name: str, *extra: str) -> list[str]:
    return [sys.executable, "-m", side.stub, "--socket", sock,
            "--name", name, *extra]


@dataclasses.dataclass
class Stubs:
    """Stub workers of one side under ``root``; kills what survives."""

    side: types.SimpleNamespace
    root: str
    procs: dict = dataclasses.field(default_factory=dict)

    def spawn(self, name: str, *extra: str) -> str:
        sock = os.path.join(self.root, f"{self.side.name}-{name}.sock")
        self.procs[name] = subprocess.Popen(
            stub_argv(self.side, sock, name, *extra), env=STUB_ENV,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        deadline = time.perf_counter() + 15.0
        while time.perf_counter() < deadline:
            try:
                self.side.oneshot(sock, {"op": "stats"}, 1.0)
                return sock
            except self.side.WireError:
                time.sleep(0.02)
        raise AssertionError(f"stub on {sock} never answered")

    def cleanup(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def both(tmp_path, scenario):
    """``scenario(side, stubs)`` over the JAX package, then the port."""
    out = []
    for side in (JAX, PORT):
        stubs = Stubs(side, str(tmp_path))
        try:
            out.append(scenario(side, stubs))
        finally:
            stubs.cleanup()
    return out


def mask(row: dict) -> dict:
    return {k: v for k, v in row.items() if k != "trace"}


# -- the router ---------------------------------------------------------------


def least_loaded(side, stubs):
    sockets = {"w_busy": stubs.spawn("w_busy", "--report-load", "50"),
               "w_idle": stubs.spawn("w_idle")}
    with side.Router(sockets, probe_interval_s=0.05) as router:
        return [mask(router.dispatch({"id": i, "content": f"b{i}"}))
                for i in range(6)]


def diff_relay(side, stubs):
    sockets = {"w0": stubs.spawn("w0")}
    with side.Router(sockets, probe_interval_s=0.05) as router:
        return mask(router.dispatch({"id": 7, "op": "diff",
                                     "content": "some license text"}))


def sigkill_failover(side, stubs):
    sockets = {n: stubs.spawn(n, "--service-ms", "20") for n in ("w0", "w1")}
    with side.Router(sockets, probe_interval_s=0.05, request_timeout_s=10.0,
                     dispatch_wait_s=15.0) as router:
        rows, lock = [], threading.Lock()

        def send(k: int) -> None:
            for i in range(25):
                row = router.dispatch({"id": k * 100 + i,
                                       "content": f"c{k} {i}"})
                with lock:
                    rows.append(row)

        threads = [threading.Thread(target=send, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        side.faults.kill(stubs.procs["w0"].pid)
        for t in threads:
            t.join(timeout=60.0)
        stats = router.stats()
    return {"answers": sorted((r["id"], r.get("key"), r.get("error"))
                              for r in rows),
            "failed_over": stats["router"]["failovers"] >= 1,
            "w0_healthy": stats["backends"]["w0"]["healthy"],
            "requests": stats["router"]["requests"]}


def queue_full_failover(side, stubs):
    sockets = {"w_full": stubs.spawn("w_full", "--queue-full"),
               "w_ok": stubs.spawn("w_ok", "--report-load", "10")}
    with side.Router(sockets, probe_interval_s=0.05) as router:
        row = mask(router.dispatch({"id": 1, "content": "x"}))
        stats = router.stats()["router"]
    return row, stats["queue_full_failovers"], stats["queue_full_returned"]


def queue_full_surfaced(side, stubs):
    sockets = {"a": stubs.spawn("a", "--queue-full"),
               "b": stubs.spawn("b", "--queue-full")}
    with side.Router(sockets, probe_interval_s=0.05) as router:
        row = mask(router.dispatch({"id": 9, "content": "x"}))
        stats = router.stats()["router"]
    return row, stats["queue_full_returned"], stats["ok"]


def hedges(side, stubs):
    """The slow primary's hedge wins on the fast twin; with the roles
    flipped the primary wins and the hedge loses."""
    out = []
    for primary, twin in ((("w_slow", "800"), ("w_fast", None)),
                          (("w_mid", "200"), ("w_slow2", "800"))):
        sockets = {
            primary[0]: stubs.spawn(primary[0], "--service-ms", primary[1]),
            twin[0]: stubs.spawn(twin[0], "--report-load", "5",
                                 *(("--service-ms", twin[1]) if twin[1]
                                   else ())),
        }
        with side.Router(sockets, probe_interval_s=0.05, hedge_ms=50.0,
                         request_timeout_s=10.0) as router:
            row = mask(router.dispatch({"id": 1, "content": "hedge-me"}))
            stats = router.stats()["router"]
        out.append((row, {k: stats[k] for k in (
            "hedges_started", "hedges_won", "hedges_lost", "ok",
            "requests")}))
    return out


def hung_hedged(side, stubs):
    sockets = {"w_wedge": stubs.spawn("w_wedge", "--hang-after", "1"),
               "w_live": stubs.spawn("w_live", "--report-load", "5")}
    with side.Router(sockets, probe_interval_s=0.05, hedge_ms=50.0,
                     request_timeout_s=20.0) as router:
        return [mask(router.dispatch({"id": i, "content": c}))
                for i, c in ((1, "warm"), (2, "now-hangs"))]


def trace_propagation(side, stubs):
    sockets = {"w0": stubs.spawn("w0")}
    with side.Router(sockets, probe_interval_s=0.05,
                     trace_sample=1.0) as router:
        rows = [router.dispatch({"id": i, "content": f"t{i}"})
                for i in range(3)]
        tail = router.trace_tail(10)
    ids = [r["trace"] for r in rows]
    worker = side.oneshot(sockets["w0"], {"op": "trace", "n": 10}, 2.0)
    return {"distinct": len(set(ids)),
            "routed": sorted(s["name"] for t in tail if t["trace"] in ids
                             for s in t["spans"]),
            "in_worker": set(ids) <= {t["trace"] for t in worker["traces"]}}


def front_session(side, stubs):
    sockets = {"w0": stubs.spawn("w0")}
    front = os.path.join(stubs.root, f"{side.name}-front.sock")
    with side.Router(sockets, probe_interval_s=0.05,
                     trace_sample=1.0) as router:
        server = side.FrontServer(front, router)
        thread = threading.Thread(target=server.serve_forever,
                                  kwargs={"poll_interval": 0.05}, daemon=True)
        thread.start()
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.connect(front)
                s.settimeout(10.0)
                f = s.makefile("rwb")
                lines = [{"id": 1, "content": "one"},
                         {"id": 2, "content": "two"},
                         {"id": 3, "op": "stats"},
                         {"id": 4, "op": "stats", "format": "prometheus"},
                         {"id": 5, "op": "trace", "n": 5},
                         {"id": 6, "op": "nope"},
                         {"id": 7, "op": "diff", "content": "blob"},
                         {"id": 8, "op": "query", "list": True},
                         {"id": 9, "op": "alerts"},
                         {"id": 10, "op": "traces", "n": 3},
                         "not json"]
                for row in lines:
                    f.write((row if isinstance(row, str) else json.dumps(
                        row)).encode() + b"\n")
                f.flush()
                rows = [json.loads(f.readline()) for _ in lines]
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=5.0)
    stats, prom = rows[2]["stats"], rows[3]["prometheus"]
    families = sorted({line.split()[2] for line in prom.splitlines()
                       if line.startswith("# TYPE ")})
    return {"content": [mask(r) for r in (rows[0], rows[1], rows[6])],
            "stats_keys": sorted(stats), "backend": sorted(
                stats["backends"]["w0"]), "families": families,
            "traces": bool(rows[4]["traces"]),
            "errors": [rows[5]["error"], rows[10].get("error")],
            "alerts": sorted(rows[8]["alerts"]),
            "assembled": type(rows[9].get("traces")).__name__,
            "ids": [r.get("id") for r in rows]}


@pytest.mark.parametrize("scenario", [
    least_loaded, diff_relay, sigkill_failover, queue_full_failover,
    queue_full_surfaced, hedges, hung_hedged, trace_propagation,
    front_session], ids=lambda f: f.__name__)
def test_router_matches_jax(tmp_path, scenario):
    want, got = both(tmp_path, scenario)
    assert got == want
    # the JAX package's outcome is the one its own tests pin
    if scenario is least_loaded:
        assert {r["worker"] for r in want} == {"w_idle"}
    elif scenario is sigkill_failover:
        assert want["failed_over"] and not want["w0_healthy"]
        assert all(e is None for _i, _k, e in want["answers"])
    elif scenario is queue_full_failover:
        assert want[0]["worker"] == "w_ok" and want[1] >= 1
    elif scenario is queue_full_surfaced:
        assert want[0]["error"] == "queue_full" and want[1] == 1
    elif scenario is hedges:
        assert [r["worker"] for r, _s in want] == ["w_fast", "w_mid"]
    elif scenario is hung_hedged:
        assert [r["worker"] for r in want] == ["w_wedge", "w_live"]
    elif scenario is trace_propagation:
        assert want["distinct"] == 3 and want["in_worker"]


# -- the supervisor -----------------------------------------------------------


def supervisor(side, root, *extra, names=("w0",), **kwargs):
    sockets = {n: os.path.join(root, f"{side.name}-{n}.sock") for n in names}
    opts = dict(probe_interval_s=0.05, backoff_base_s=0.1, backoff_max_s=1.0,
                startup_grace_s=15.0)
    opts.update(kwargs)
    return side.Supervisor(
        sockets, argv_for=lambda name, sock: stub_argv(side, sock, name,
                                                       *extra),
        env_for=lambda name, chips: dict(STUB_ENV), **opts)


def until(cond, timeout: float = 20.0) -> bool:
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def crash_restart(side, stubs):
    with supervisor(side, stubs.root) as sup:
        assert sup.wait_healthy(15.0)
        first = sup.workers["w0"].pid
        side.faults.kill(first)
        back = until(lambda: sup.workers["w0"].restarts >= 1
                     and sup.workers["w0"].pid not in (None, first)
                     and sup.probe("w0") is not None)
        entry = sup.workers["w0"].restart_log[-1]
        return (back, sup.workers["w0"].exit_codes[-1],
                {k: entry[k] for k in ("reason", "exit_code", "signal",
                                       "backoff_s", "restarts")})


def wedge_kill(side, stubs):
    with supervisor(side, stubs.root, probe_timeout_s=0.3,
                    wedged_after=2) as sup:
        assert sup.wait_healthy(15.0)
        frozen = sup.workers["w0"].pid
        side.faults.hang(frozen)
        # the replacement sometimes takes ~15 s to answer, in both
        # packages alike
        back = until(lambda: sup.workers["w0"].pid not in (None, frozen)
                     and sup.probe("w0") is not None, timeout=45.0)
        entry = sup.workers["w0"].restart_log[-1]
        return back, sup.workers["w0"].restarts >= 1, entry["reason"]


def drain(side, stubs):
    with supervisor(side, stubs.root, "--service-ms", "400") as sup:
        assert sup.wait_healthy(15.0)
        with side.Router({"w0": sup.workers["w0"].socket_path},
                         supervisor=sup, probe_interval_s=0.05) as router:
            result = {}
            t = threading.Thread(target=lambda: result.update(
                router.dispatch({"id": 1, "content": "slow"})))
            t.start()
            time.sleep(0.1)
            t0 = time.perf_counter()
            clean = sup.drain("w0", timeout_s=10.0, restart=False)
            waited = time.perf_counter() - t0 >= 0.2
            t.join(timeout=10.0)
            return (clean, mask(result), waited, sup.workers["w0"].state,
                    sup.workers["w0"].exit_codes[-1], router.pick())


def add_remove(side, stubs):
    with supervisor(side, stubs.root) as sup:
        assert sup.wait_healthy(15.0)
        handle = sup.add_worker(
            "auto0", os.path.join(stubs.root, f"{side.name}-auto0.sock"))
        with pytest.raises(ValueError) as dup:
            sup.add_worker("auto0", os.path.join(stubs.root, "dup.sock"))
        healthy = sup.wait_healthy(15.0)
        probed = sup.probe("auto0") is not None
        removed = sup.remove_worker("auto0")
        return (handle.name, str(dup.value), healthy, probed, removed,
                "auto0" in sup.workers, sup.probe("auto0"),
                sup.probe("w0") is not None)


def backoff_and_chips(side, stubs):
    sup = side.Supervisor({"w0": "/nonexistent.sock"},
                          argv_for=lambda name, sock: ["true"],
                          backoff_base_s=0.25, backoff_max_s=10.0)
    chips = side.Supervisor(
        {n: os.path.join(stubs.root, f"{n}.sock") for n in ("w0", "w1")},
        argv_for=lambda name, sock: ["true"], chips_per_worker=2)
    return ([sup.backoff_delay_s(n) for n in range(8)],
            [chips.workers[w].env["LICENSEE_TPU_VISIBLE_CHIPS"]
             for w in ("w0", "w1")],
            side.Supervisor({"w0": "x.sock"}).workers["w0"].argv[1:])


@pytest.mark.parametrize("scenario", [
    crash_restart, wedge_kill, drain, add_remove, backoff_and_chips],
    ids=lambda f: f.__name__)
def test_supervisor_matches_jax(tmp_path, scenario):
    want, got = both(tmp_path, scenario)
    if scenario is backoff_and_chips:
        # the default worker is each package's own serve
        assert want[2][:2] == ["-m", "licensee_tpu.cli.main"]
        assert got[2][:2] == ["-m", "licensee_tpu_torch.cli.main"]
        want, got = want[:2], got[:2]
        assert want[0][:4] == [0.25, 0.5, 1.0, 2.0] and want[0][-1] == 10.0
    assert got == want
    if scenario is crash_restart:
        assert want[0] and want[1] == -9 and want[2]["signal"] == 9
    elif scenario is wedge_kill:
        assert want[:2] == (True, True)
    elif scenario is drain:
        assert want[0] and want[1]["key"] == "stub-mit" and want[2]
        assert want[3:] == ("stopped", -15, None)


def test_port_worker_env_derives_cuda_devices():
    """The port's worker env: the chip subset as CUDA_VISIBLE_DEVICES,
    derived in the child's dict, never in this process."""
    env = port_supervisor.worker_env({"PATH": "/bin"}, ["4", "5"])
    assert env["LICENSEE_TPU_VISIBLE_CHIPS"] == "4,5"
    assert env["CUDA_VISIBLE_DEVICES"] == "4,5"
    assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert os.environ.get("CUDA_VISIBLE_DEVICES") != "4,5"


# -- reload_fleet ---------------------------------------------------------------


def patch(argv, corpus):
    out = list(argv)
    out[out.index("--fingerprint") + 1] = corpus
    return out


def fps(sup):
    return {n: ((sup.probe(n) or {}).get("corpus") or {}).get("fingerprint")
            for n in sup.workers}


def roll_outcome(out: dict) -> dict:
    keep = ("ok", "rolled_back", "fingerprint", "error", "corpus")
    return {**{k: out.get(k) for k in keep},
            "workers": {n: {k: (re.sub(r"\d+\.\d+", "N", v)
                                if isinstance(v, str) else v)
                            for k, v in w.items() if k != "elapsed_s"}
                        for n, w in out["workers"].items()}}


def reload_case(case: str):
    def scenario(side, stubs):
        extra = {"w1": ("--reload-deny", "deny-")} if case == "deny" else {}
        sockets = {n: os.path.join(stubs.root, f"{side.name}-{n}.sock")
                   for n in ("w0", "w1")}
        sup = side.Supervisor(
            sockets, argv_for=lambda name, sock: stub_argv(
                side, sock, name, "--fingerprint", "fp-old",
                *extra.get(name, ())),
            env_for=lambda name, chips: dict(STUB_ENV), probe_interval_s=0.05,
            backoff_base_s=0.1, backoff_max_s=1.0, startup_grace_s=15.0)
        with sup:
            assert sup.wait_healthy(15.0)
            kwargs = dict(timeout_s=10.0, health_timeout_s=10.0,
                          argv_patch=patch)
            if case in ("roll", "deny", "corrupt"):
                source = {"roll": "fp-new", "deny": "deny-fp",
                          "corrupt": "corrupt:artifact"}[case]
                out = roll_outcome(sup.reload_fleet(source, **kwargs))
                after = {}
                if case == "roll":
                    first = sup.workers["w0"].pid
                    side.faults.kill(first)
                    until(lambda: sup.workers["w0"].pid not in (None, first)
                          and sup.probe("w0") is not None)
                return out, fps(sup), after, [
                    "deny-fp" in h.argv for h in sup.workers.values()]
            results = {}
            slow = "slow:1500:fp-mid" if case == "dead" else "slow:800:fp-a"
            t = threading.Thread(target=lambda: results.update(
                out=sup.reload_fleet(slow, **kwargs)))
            t.start()
            time.sleep(0.4 if case == "dead" else 0.3)
            second = None
            if case == "dead":
                side.faults.kill(sup.workers["w0"].pid)
            else:
                second = sup.reload_fleet("fp-b", **kwargs)
            t.join(timeout=30.0)
            until(lambda: sup.probe("w0") is not None)
            return results["out"]["ok"], second, fps(sup)
    scenario.__name__ = case
    return scenario


@pytest.mark.parametrize("case", ["roll", "deny", "corrupt", "dead",
                                  "concurrent"])
def test_reload_fleet_matches_jax(tmp_path, case):
    want, got = both(tmp_path, reload_case(case))
    assert got == want
    if case == "roll":
        assert want[0]["ok"] and want[1] == {"w0": "fp-new", "w1": "fp-new"}
    elif case == "deny":
        assert want[0]["rolled_back"] and want[0]["workers"]["w0"][
            "rolled_back"]
        assert want[1] == {"w0": "fp-old", "w1": "fp-old"}
    elif case == "corrupt":
        assert "injected refusal" in want[0]["workers"]["w0"]["error"]
    elif case == "dead":
        assert want == (False, None, {"w0": "fp-old", "w1": "fp-old"})
    else:
        assert want[0] and want[1]["error"] == "fleet_reload_in_progress"
        assert want[2] == {"w0": "fp-a", "w1": "fp-a"}


def reload_verbs(side, stubs):
    """The worker's reload_in_progress guard and the front door's reload
    verb delegating to the supervisor."""
    sock = stubs.spawn("solo", "--fingerprint", "fp-old")
    rows = []
    t = threading.Thread(target=lambda: rows.append(side.oneshot(
        sock, {"op": "reload", "corpus": "slow:800:fp-a"}, 10.0)))
    t.start()
    time.sleep(0.2)
    fast = side.oneshot(sock, {"op": "reload", "corpus": "fp-b"}, 10.0)
    t.join(timeout=15.0)
    out = [fast.get("error"), rows[0]["reload"]["ok"],
           side.oneshot(sock, {"op": "stats"}, 5.0)["stats"]["corpus"]]
    sockets = {n: os.path.join(stubs.root, f"{side.name}-{n}.sock")
               for n in ("w0", "w1")}
    sup = side.Supervisor(
        sockets, argv_for=lambda name, s: stub_argv(
            side, s, name, "--fingerprint", "fp-old"),
        env_for=lambda name, chips: dict(STUB_ENV), probe_interval_s=0.05,
        startup_grace_s=15.0)
    front = os.path.join(stubs.root, f"{side.name}-front.sock")
    with sup, side.Router(sockets, supervisor=sup,
                          probe_interval_s=0.05) as router:
        assert sup.wait_healthy(15.0)
        server = side.FrontServer(front, router)
        st = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
        st.start()
        try:
            row = side.oneshot(front, {"id": 9, "op": "reload",
                                       "corpus": "fp-front"}, 30.0)
            bad = side.oneshot(front, {"id": 10, "op": "reload"}, 10.0)
        finally:
            server.shutdown()
            server.server_close()
            st.join(timeout=5.0)
        return out, roll_outcome(row["reload"]), bad, fps(sup)


def test_reload_verbs_match_jax(tmp_path):
    want, got = both(tmp_path, reload_verbs)
    assert got == want
    assert want[0][:2] == ["reload_in_progress", True]
    assert want[1]["fingerprint"] == "fp-front"
    assert want[3] == {"w0": "fp-front", "w1": "fp-front"}


# -- the HTTP edge ------------------------------------------------------------


def http_exchange(port: int, raw: bytes) -> list:
    """Send ``raw`` (its requests, or one malformed head) on one
    connection; the answers, each (status line, headers, body), until
    every request has one or the edge closes."""
    want = max(1, raw.count(b" HTTP/1.1\r\n"))
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=10.0) as s:
        with contextlib.suppress(OSError):  # an early 413 closes mid-body
            s.sendall(raw)
        f = s.makefile("rb")
        while len(out) < want:
            status = f.readline()
            if not status:
                break
            headers, length = [], 0
            while (line := f.readline()) not in (b"\r\n", b""):
                name, _, value = line.decode().partition(":")
                headers.append((name, value.strip()))
                if name.lower() == "content-length":
                    length = int(value)
            out.append((status.decode(), headers, f.read(length).decode()))
            if ("Connection", "close") in headers:
                break
    return out


def post(path: str, body: bytes, *headers: str) -> bytes:
    head = "".join(f"{h}\r\n" for h in headers)
    return (f"POST {path} HTTP/1.1\r\nHost: edge\r\n{head}"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def get(path: str, *headers: str) -> bytes:
    head = "".join(f"{h}\r\n" for h in headers)
    return f"GET {path} HTTP/1.1\r\nHost: edge\r\n{head}\r\n".encode()


AUTH = "Authorization: Bearer tok-a"
EDGE_CASES = {
    "classify": post("/classify", b'{"id": 1, "content": "x"}', AUTH),
    "classify_pipelined": post("/classify", b'{"id": 1, "content": "a"}',
                               AUTH) + post("/classify",
                                            b'{"id": 2, "content": "b"}',
                                            AUTH),
    "healthz": get("/healthz"),
    "no_token": post("/classify", b'{"id": 1, "content": "x"}'),
    "bad_token": post("/classify", b'{"content": "x"}',
                      "Authorization: Bearer nope"),
    "bad_json": post("/classify", b"{not json", AUTH),
    "not_object": post("/classify", b"[1, 2]", AUTH),
    # the head alone: the edge answers 413 from Content-Length and
    # closes, with nothing unread that would turn its close into a reset
    "too_large": post("/classify", b"", AUTH).replace(
        b"Content-Length: 0", b"Content-Length: %d" % (2 << 20)),
    "wrong_method": get("/classify", AUTH),
    "no_route": get("/nowhere", AUTH),
    "jobs_post": post("/jobs", b'{"manifest": "m"}', AUTH),
    "jobs_get": get("/jobs/abc123", AUTH),
    "jobs_delete": b"DELETE /jobs/abc123 HTTP/1.1\r\nHost: edge\r\n"
                   + AUTH.encode() + b"\r\n\r\n",
    "corpus_post": post("/corpus", b'{"artifact_b64": ""}', AUTH),
    "history_bad": get("/metrics/history?series=", AUTH),
    "history_unknown": get("/metrics/history?series=absent_total", AUTH),
    "bad_request_line": b"NONSENSE\r\n\r\n",
    "bad_header": b"POST /classify HTTP/1.1\r\nno colon here\r\n\r\n",
    "rate_limited": post("/classify", b'{"id": 1, "content": "x"}', AUTH)
    * 3,
}


def edge_answers(side, stubs):
    sockets = {"w0": stubs.spawn("w0", "--fingerprint", "fp-edge")}
    out = {}
    with side.Router(sockets, probe_interval_s=0.05) as router:
        edge = side.edge.HttpEdgeServer(
            "127.0.0.1:0", router, tokens={"tok-a": "alice"},
            rate_per_client=1.0, burst=2.0, max_body_bytes=1 << 20)
        thread = threading.Thread(target=edge.serve_forever,
                                  kwargs={"poll_interval": 0.05}, daemon=True)
        thread.start()
        try:
            for name, raw in EDGE_CASES.items():
                # each case its own client (a fresh token bucket) but the
                # rate drill, which spends one bucket of depth 2
                edge.tokens = {"tok-a": name}
                out[name] = [
                    (status, [(h, TRACE_RE.sub("T", v)) for h, v in headers],
                     TRACE_RE.sub("T", body))
                    for status, headers, body in http_exchange(
                        edge.bound_port, raw)]
            metrics = http_exchange(edge.bound_port, get("/metrics", AUTH))
        finally:
            edge.shutdown()
            edge.server_close()
            thread.join(timeout=5.0)
    status, headers, body = metrics[0]
    out["metrics"] = (status, [h for h, _v in headers], sorted(
        {line.split()[2] for line in body.splitlines()
         if line.startswith("# TYPE ")}))
    return out


def test_http_edge_bytes_match_jax(tmp_path):
    want, got = both(tmp_path, edge_answers)
    assert set(got) == set(want)
    for case in want:
        assert got[case] == want[case], case
    assert want["classify"][0][0] == "HTTP/1.1 200 OK\r\n"
    assert [s for s, _h, _b in want["rate_limited"]] == [
        "HTTP/1.1 200 OK\r\n"] * 2 + ["HTTP/1.1 429 Too Many Requests\r\n"]
    for case, code in (("no_token", 401), ("too_large", 413),
                       ("wrong_method", 405), ("no_route", 404),
                       ("jobs_post", 503), ("jobs_get", 503),
                       ("corpus_post", 503), ("bad_request_line", 400)):
        assert want[case][0][0].split()[1] == str(code), case
    assert "jobs_disabled" in want["jobs_post"][0][2]
    assert "tenancy_disabled" in want["corpus_post"][0][2]


# -- the fleet verb's own surface -------------------------------------------------


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("flags", [
    ["--tenants", "reg.json", "--socket", "f.sock"],
    ["--jobs-dir", "jobs", "--http", "127.0.0.1:0"],
    ["--selftest-jobs", "--stub"],
    ["--selftest-tenant", "--stub"],
    ["--jobs-dir", "jobs", "--socket", "f.sock"],
    ["--tenants", "reg.json", "--federate", "h:1", "--socket", "f.sock"],
    ["--tenants", "empty.json", "--socket", "f.sock"],
    ["--tenants", "two.json", "--http", "127.0.0.1:0", "--jobs-dir", "jobs"],
])
def test_fleet_tiers_match_jax(tmp_path, monkeypatch, flags):
    """The tenancy and jobs flags of `fleet` against the JAX CLI's: a
    missing or empty registry, `--jobs-dir` without `--http` and
    `--tenants` with `--federate` answer the same errors; a fleet with a
    jobs dir (its workers' boot stubbed to fail in both packages) stops
    at the same point; the selftest flags reach each package's selftest
    with ``stub`` (the port's with ``device``, default cuda)."""
    import licensee_tpu.fleet.selftest as jax_fleet_selftest
    import licensee_tpu.jobs.selftest as jax_jobs_selftest
    import licensee_tpu_torch.fleet.selftest as port_fleet_selftest
    import licensee_tpu_torch.jobs.selftest as port_jobs_selftest

    monkeypatch.chdir(tmp_path)
    (tmp_path / "empty.json").write_text('{"version": 1, "tenants": {}}')
    (tmp_path / "two.json").write_text(json.dumps({"version": 1, "tenants": {
        "acme": {"token": "t-a", "corpus": "vendored"},
        "beta": {"token": "t-b", "corpus": "spdx"}}}))
    calls = []
    for module, name in ((jax_jobs_selftest, "selftest_jobs"),
                         (jax_fleet_selftest, "selftest_tenant"),
                         (port_jobs_selftest, "selftest_jobs"),
                         (port_fleet_selftest, "selftest_tenant")):
        monkeypatch.setattr(module, name, lambda _n=name, **kw: (
            calls.append((_n, kw)), 0)[1])

    def fail_boot(side):
        class NoBoot(side.Supervisor):
            def start(self):
                pass

            def wait_healthy(self, timeout):
                return False

            def status(self):
                return {}

        monkeypatch.setattr(sys.modules[side.Supervisor.__module__],
                            "Supervisor", NoBoot)

    fail_boot(JAX)
    fail_boot(PORT)
    # the socket directory is a fresh temporary one in each run
    want, got = (tuple(re.sub(r"licensee-fleet-\w+", "D", part)
                       if isinstance(part, str) else part
                       for part in run(main, ["fleet", *flags]))
                 for main in (jax_main, port_main))
    assert got == want
    if flags[0].startswith("--selftest"):
        assert want[0] == 0 and calls[0][1] == {"stub": True}
        assert calls[1][1] == {"stub": True, "device": "cuda"}
    else:
        assert want[0] == 1 and "error: " in want[2]


@pytest.mark.parametrize("flags", [
    [],
    ["--socket", "f.sock", "--hedge-ms", "soon"],
    ["--socket", "f.sock", "--hedge-ms", "-3"],
    ["--federate", " , ", "--socket", "f.sock"],
])
def test_fleet_argument_errors_match_jax(flags):
    got = run(port_main, ["fleet", *flags])
    assert got == run(jax_main, ["fleet", *flags])
    assert got[0] == 1 and got[2].startswith("error: ")


def test_fleet_passes_device_to_its_workers(tmp_path, monkeypatch):
    """`fleet` builds each worker's argv from its serve flags with
    `--device` (default cuda), so a respawn keeps it; the workers never
    boot here, the supervisor's start is stubbed."""
    seen = {}

    class Recorder(port_supervisor.Supervisor):
        def start(self):
            seen.update({n: h.argv for n, h in self.workers.items()})

        def wait_healthy(self, timeout):
            return False

    monkeypatch.setattr(port_supervisor, "Supervisor", Recorder)
    for flags, device in (([], "cuda"), (["--device", "cpu"], "cpu")):
        rc, _out, err = run(port_main, [
            "fleet", "--workers", "2", "--socket", str(tmp_path / "f.sock"),
            "--socket-dir", str(tmp_path), "--corpus", "vendored", *flags])
        assert rc == 1 and "workers failed to boot" in err
        for argv in seen.values():
            assert argv[1:4] == ["-m", "licensee_tpu_torch.cli.main",
                                 "serve"]
            assert argv[argv.index("--device") + 1] == device
            patched = port_supervisor.Supervisor.patch_corpus_argv(
                argv, "x.npz")
            assert patched[patched.index("--device") + 1] == device
