"""The port's jobs tier against the JAX package's, on the CPU.

The same record sequences go through both packages' `JobJournal`s (a
torn tail and a corrupt middle included) and each replays the other's
file; `validate_spec` and `forward_args_for` give equal answers over
`tests/test_jobs.py`'s good and bad specs; the same scenarios run
through each package's `JobExecutor` over its own stub runners (submit,
a duplicate key, cancel while queued, cancel while running across a
restart, close and requeue, a SIGKILLed executor's replay, a failed
runner) with equal status rows and journal records; one real job runs
through both executors' stripe children (the port's on the CPU), with
byte-identical results and container verdicts; the HTTP edge answers
`/jobs*` with equal status lines, headers and bodies; the `jobs` verb
prints what the JAX CLI prints; and chip_smoke.py's phase 12 (the tenant
fleet, its roll, two jobs) runs at its tiny size on the CPU.  Job IDs
and trace IDs are masked: they are random."""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tarfile
import threading
import time
import types

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest

import licensee_tpu.fleet.http_edge as jax_edge
import licensee_tpu.fleet.router as jax_router
import licensee_tpu.fleet.wire as jax_wire
import licensee_tpu.jobs.client as jax_client
import licensee_tpu.jobs.executor as jax_executor
import licensee_tpu.jobs.journal as jax_journal
import licensee_tpu.parallel.stripes as jax_stripes
import licensee_tpu_torch.fleet.http_edge as port_edge
import licensee_tpu_torch.fleet.router as port_router
import licensee_tpu_torch.fleet.wire as port_wire
import licensee_tpu_torch.jobs.client as port_client
import licensee_tpu_torch.jobs.executor as port_executor
import licensee_tpu_torch.jobs.journal as port_journal
import licensee_tpu_torch.parallel.stripes as port_stripes
from licensee_tpu.cli.main import main as jax_main
from licensee_tpu_torch.cli.main import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB_ENV = {**os.environ, "PYTHONPATH": REPO}
TOKEN = "test-jobs-token"

JAX = types.SimpleNamespace(
    name="jax", journal=jax_journal, executor=jax_executor,
    StripeStopped=jax_stripes.StripeStopped, Router=jax_router.Router,
    edge=jax_edge, client=jax_client, oneshot=jax_wire.oneshot,
    WireError=jax_wire.WireError, stub="licensee_tpu.fleet.faults",
    main=jax_main)
PORT = types.SimpleNamespace(
    name="port", journal=port_journal, executor=port_executor,
    StripeStopped=port_stripes.StripeStopped, Router=port_router.Router,
    edge=port_edge, client=port_client, oneshot=port_wire.oneshot,
    WireError=port_wire.WireError, stub="licensee_tpu_torch.fleet.faults",
    main=port_main)
SIDES = (JAX, PORT)
ID_RE = re.compile(r"\b[0-9a-f]{12}(?:[0-9a-f]{4})?\b")


def mask(value, tmp: str = ""):
    """``value`` with job and trace IDs (and ``tmp``) replaced."""
    text = json.dumps(value, sort_keys=True) if not isinstance(
        value, str) else value
    if tmp:
        text = text.replace(tmp, "TMP")
    return ID_RE.sub("ID", text)


# -- the journal ---------------------------------------------------------------


RECORDS = [
    {"rec": "submit", "job": "aa", "spec": {"stripes": 1}},
    {"rec": "state", "job": "aa", "state": "running"},
    {"rec": "submit", "note": "a\nb"},
    {"rec": "state", "job": "aa", "state": "completed"},
]
# what a crash or a disk fault leaves after the durable records
TAILS = {
    "clean": b"",
    "torn_tail": b'{"rec":"state","job":"aa","sta',
    "torn_line_with_newline": b'{"rec":"state","jo\n',
    "corrupt_middle": b"not json\n" + json.dumps(RECORDS[0]).encode()
    + b"\n",
    "blank_lines": b"\n\n",
    "non_object": b"[1, 2]\n",
}


def journal_replay(side, path: str):
    try:
        return side.journal.JobJournal(path).replay()
    except side.journal.JournalError as exc:
        return ("JournalError", str(exc).replace(path, "PATH"))


@pytest.mark.parametrize("tail", sorted(TAILS))
def test_journal_replay_matches_jax(tmp_path, tail):
    """Each package writes the records, the fault is appended, and each
    package replays both files: four equal answers."""
    paths = {}
    for side in SIDES:
        path = str(tmp_path / side.name / "journal.jsonl")
        journal = side.journal.JobJournal(path)
        for rec in RECORDS[:2]:
            journal.append(rec)
        journal.close()
        # a reopened journal appends after what is there
        journal = side.journal.JobJournal(path)
        for rec in RECORDS[2:]:
            journal.append(rec)
        journal.close()
        with open(path, "ab") as f:
            f.write(TAILS[tail])
        paths[side.name] = path
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    answers = [journal_replay(side, path) for side in SIDES
               for path in paths.values()]
    assert all(a == answers[0] for a in answers), answers
    if tail == "corrupt_middle":
        assert answers[0][0] == "JournalError"
    else:
        assert answers[0] == RECORDS


def test_journal_missing_file_replays_empty(tmp_path):
    for side in SIDES:
        assert side.journal.JobJournal(str(tmp_path / "none")).replay() == []


# -- spec validation -------------------------------------------------------------


SPECS = [
    {"manifest": ["  /a/b  ", "t.tar::*"], "stripes": 2,
     "options": {"batch_size": 16, "confidence": 1},
     "idempotency_key": "k1"},
    {"manifest": ["/a"], "stripes": "elastic",
     "options": {"autoscale_min": 1, "autoscale_max": 4,
                 "autoscale_cooldown_s": 2, "mode": "auto"}},
    {"manifest": ["/a"], "options": {"mesh": "none", "method": "matmul",
                                     "corpus": "/c", "workers": 2}},
    "nope",
    {},
    {"manifest": []},
    {"manifest": ["a\nb"]},
    {"manifest": [" "]},
    {"manifest": ["a"], "stripes": 0},
    {"manifest": ["a"], "stripes": True},
    {"manifest": ["a"], "stripes": 999},
    {"manifest": ["a"], "options": {"argv": ["rm"]}},
    {"manifest": ["a"], "options": {"batch_size": "big"}},
    {"manifest": ["a"], "options": {"autoscale_min": 2}},
    {"manifest": ["a"], "stripes": "elastic",
     "options": {"autoscale_min": 5, "autoscale_max": 2}},
    {"manifest": ["a"], "options": []},
    {"manifest": ["a"], "idempotency_key": "x" * 300},
]


@pytest.mark.parametrize("index", range(len(SPECS)))
def test_validate_spec_matches_jax(index):
    spec = SPECS[index]
    want = jax_executor.validate_spec(spec)
    got = port_executor.validate_spec(spec)
    assert got == want
    if want[0] is not None:
        assert port_executor.forward_args_for(got[0]["options"]) == \
            jax_executor.forward_args_for(want[0]["options"])


def test_validate_spec_remote_probes_match_jax():
    """A remote container entry is probed at submit: a served archive
    passes, a missing one, a host without byte ranges and git over HTTP
    are refused with the JAX package's reasons."""
    from licensee_tpu_torch.ingest.loopback import LoopbackBlobHost

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        info = tarfile.TarInfo("LICENSE")
        info.size = 4
        tf.addfile(info, io.BytesIO(b"MIT\n"))
    with LoopbackBlobHost({"r.tar": buf.getvalue()}) as host:
        cases = [[host.url("r.tar") + "::*", "/loose"],
                 [host.url("gone.zip") + "::*"],
                 [host.url("x.git") + "::HEAD"]]
        answers = [(jax_executor.validate_spec({"manifest": m}),
                    port_executor.validate_spec({"manifest": m}))
                   for m in cases]
        host.no_range = True
        m = [host.url("r.tar") + "::*"]
        answers.append((jax_executor.validate_spec({"manifest": m}),
                        port_executor.validate_spec({"manifest": m})))
    for want, got in answers:
        assert got == want
    assert answers[0][1][1] is None
    assert all(got[0] is None for _w, got in answers[1:])


# -- the executor over stub runners ---------------------------------------------


def runners(side):
    """The stub runners of ``side``: ``Quick`` completes at once with one
    row a manifest entry; ``Gate`` blocks until its gate opens, and a
    stop request (cancel, close) ends it in the side's StripeStopped."""

    class Quick:
        def __init__(self, job, on_progress):
            self.job = job
            self.cb = on_progress
            self._stop = False

        def request_stop(self):
            self._stop = True

        def run(self):
            self.cb("spawn", {"stripe": 0, "pid": 1, "first": True})
            if self._stop:
                raise side.StripeStopped("operator stop")
            with open(self.job.manifest_path, encoding="utf-8") as f:
                entries = [line.strip() for line in f if line.strip()]
            with open(self.job.output_path, "w", encoding="utf-8") as f:
                for e in entries:
                    f.write(json.dumps({"path": e, "key": "mit"}) + "\n")
            with open(f"{self.job.output_path}.stats.json", "w",
                      encoding="utf-8") as f:
                json.dump({"total": len(entries)}, f)
            self.cb("progress", {"shard_bytes": [7]})
            self.cb("stripe_done", {"stripe": 0})
            return {"stripes": 1, "rows_written": len(entries),
                    "elapsed_s": 0.01, "files_per_sec": 1.0,
                    "already_complete": False}

    class Gate(Quick):
        def __init__(self, job, on_progress, gate, poison):
            super().__init__(job, on_progress)
            self.gate = gate
            self.poison = poison

        def request_stop(self):
            self._stop = True
            self.gate.set()

        def run(self):
            self.cb("spawn", {"stripe": 0, "pid": 1, "first": True})
            self.gate.wait(timeout=30.0)
            if self._stop or self.poison.is_set():
                raise side.StripeStopped("operator stop")
            return super().run()

    return Quick, Gate


def wait_state(ex, job_id, states, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        row = ex.status(job_id)
        if row and row["state"] in states:
            return row
        time.sleep(0.01)
    raise AssertionError(f"{job_id} never reached {states}: "
                         f"{ex.status(job_id)}")


def spec_of(side, entries, key=None):
    spec, reason = side.executor.validate_spec(
        {"manifest": list(entries), "stripes": 1, "idempotency_key": key})
    assert reason is None
    return spec


def run_scenario(side, root: str, scenario: str) -> list:
    """One executor scenario; the status rows and results it saw, then
    the journal's records."""
    Quick, Gate = runners(side)
    gate, poison = threading.Event(), threading.Event()
    JobExecutor = side.executor.JobExecutor
    terminal = side.executor.TERMINAL_STATES
    seen = []
    executors = []

    def executor(factory, **kwargs):
        ex = JobExecutor(root, runner_factory=factory, **kwargs)
        ex.start()
        executors.append(ex)
        return ex

    quick = lambda j, cb: Quick(j, cb)  # noqa: E731
    gated = lambda j, cb: Gate(j, cb, gate, poison)  # noqa: E731
    try:
        if scenario == "submit":
            ex = executor(quick)
            job, created = ex.submit(spec_of(side, ["/a", "/b"], "k1"))
            seen.append(created)
            seen.append(wait_state(ex, job.job_id, ("completed",)))
            with open(ex.results_path(job.job_id), encoding="utf-8") as f:
                seen.append(f.read())
            seen.append(ex.results_path("feedfacefeed"))
        elif scenario == "duplicate_key":
            ex = executor(quick)
            job, created = ex.submit(spec_of(side, ["/a"], "dup"))
            twin, twin_created = ex.submit(spec_of(side, ["/a"], "dup"))
            seen += [created, twin_created, twin.job_id == job.job_id]
            seen.append(wait_state(ex, job.job_id, ("completed",)))
        elif scenario == "cancel_queued":
            ex = executor(lambda j, cb: (
                gated if j.spec.get("idempotency_key") == "blocker"
                else quick)(j, cb))
            blocker, _ = ex.submit(spec_of(side, ["/a"], "blocker"))
            seen.append(wait_state(ex, blocker.job_id, ("running",)))
            queued, _ = ex.submit(spec_of(side, ["/b"], "victim"))
            seen.append(ex.cancel(queued.job_id))
            seen.append(ex.cancel("feedfacefeed"))
            gate.set()
            seen.append(wait_state(ex, blocker.job_id, ("completed",)))
            seen.append(ex.status(queued.job_id))
            seen.append(ex.results_path(queued.job_id))
        elif scenario == "cancel_running_across_restart":
            ex = executor(gated)
            job, _ = ex.submit(spec_of(side, ["/a"], "k1"))
            wait_state(ex, job.job_id, ("running",))
            ex.cancel(job.job_id)
            seen.append(wait_state(ex, job.job_id, terminal))
            ex.close()
            ex2 = executor(quick)
            seen += [ex2.status(job.job_id), ex2.resumed_jobs]
        elif scenario == "close_requeues":
            ex = executor(gated)
            job, _ = ex.submit(spec_of(side, ["/a", "/b"], "k1"))
            wait_state(ex, job.job_id, ("running",))
            ex.close()
            ex2 = executor(quick)
            seen.append(ex2.resumed_jobs)
            seen.append(wait_state(ex2, job.job_id, ("completed",)))
        elif scenario == "killed_executor_replays":
            ex_a = executor(gated)
            job, _ = ex_a.submit(spec_of(side, ["/a", "/b", "/c"], "k1"))
            wait_state(ex_a, job.job_id, ("running",))
            # executor A is abandoned mid-run, its journal at "running"
            ex_b = JobExecutor(root, runner_factory=quick)
            ex_b.start()
            seen.append(ex_b.resumed_jobs)
            seen.append(wait_state(ex_b, job.job_id, ("completed",)))
            twin, created = ex_b.submit(spec_of(side, ["/a"], "k1"))
            seen += [created, twin.job_id == job.job_id]
            ex_b.close()
            poison.set()
            gate.set()
        elif scenario == "failed_runner":
            class Boom(Quick):
                def run(self):
                    raise ValueError("manifest exploded")

            ex = executor(lambda j, cb: Boom(j, cb))
            job, _ = ex.submit(spec_of(side, ["/a"]))
            seen.append(wait_state(ex, job.job_id, terminal))
            seen.append(ex.results_path(job.job_id))
    finally:
        poison.set()
        gate.set()
        for ex in executors:
            ex.close()
    return seen + side.journal.JobJournal(
        os.path.join(root, "journal.jsonl")).replay()


SCENARIOS = ("submit", "duplicate_key", "cancel_queued",
             "cancel_running_across_restart", "close_requeues",
             "killed_executor_replays", "failed_runner")


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_executor_scenarios_match_jax(tmp_path, scenario):
    want, got = (run_scenario(side, str(tmp_path / side.name), scenario)
                 for side in SIDES)
    assert mask(got) == mask(want)
    assert want  # the scenario saw something


def test_executor_forwards_its_device_to_the_stripes(tmp_path):
    """`JobExecutor(device=)` adds ``--device D`` to every stripe
    child's argv (the spec's options never carry it), and a spec valid
    in one package is valid in the other."""
    for device in ("cuda", "cpu"):
        ex = port_executor.JobExecutor(str(tmp_path / device),
                                       device=device)
        spec = spec_of(PORT, ["/a"])
        job = port_executor.Job("a" * 12, spec, str(tmp_path / device))
        job.write_manifest()
        runner = ex._build_runner(job, lambda kind, info: None)
        assert runner._forward_args[-2:] == ("--device", device)
        assert "--device" not in port_executor.forward_args_for(
            spec["options"])
        ex.journal.close()


def test_save_upload_matches_jax(tmp_path):
    paths = []
    for side in SIDES:
        root = str(tmp_path / side.name)
        ex = side.executor.JobExecutor(root)
        got = [ex.save_upload(name, data) for name, data in (
            ("x.tar", b"same bytes"), ("../evil/x.tar", b"same bytes"),
            ("x.tar", b"other bytes"), (" ", b"z"))]
        paths.append([os.path.relpath(p, root) for p in got])
        ex.journal.close()
    assert paths[0] == paths[1]


# -- a real job through both executors --------------------------------------------


def write_job_inputs(root: str) -> list:
    """Six loose license files and a tar of eight more: a manifest in the
    ingest grammar whose container verdicts fill the sidecar."""
    from licensee_tpu_torch.corpus.license import License

    bodies = [re.sub(r"\[(\w+)\]", "example", License.find(k).content)
              for k in ("mit", "isc", "bsd-3-clause", "apache-2.0")]
    os.makedirs(root, exist_ok=True)
    entries = []
    for i in range(6):
        path = os.path.join(root, f"LICENSE_{i}")
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"Copyright (c) {2000 + i} Author {i}\n\n"
                    + bodies[i % len(bodies)] + f"\nzq{i}\n")
        entries.append(path)
    tar_path = os.path.join(root, "pkg.tar")
    with tarfile.open(tar_path, "w") as tf:
        for i in range(8):
            data = (bodies[i % len(bodies)] + f"\nmember {i}\n").encode()
            info = tarfile.TarInfo(f"pkg{i}/LICENSE")
            info.size = len(data)
            info.mtime = 1_600_000_000
            tf.addfile(info, io.BytesIO(data))
    return entries + [f"{tar_path}::*"]


def test_a_real_job_matches_jax(tmp_path):
    """One spec through the JAX executor's stripe children and the
    port's on the CPU, side by side: the merged results and container
    verdicts are byte-identical, and the status rows equal."""
    entries = write_job_inputs(str(tmp_path / "in"))
    spec = {"manifest": entries, "stripes": 2,
            "options": {"batch_size": 16, "mesh": "none"}}
    executors = {
        "jax": jax_executor.JobExecutor(
            str(tmp_path / "jax"),
            base_env={**os.environ, "JAX_PLATFORMS": "cpu"}),
        "port": port_executor.JobExecutor(str(tmp_path / "port"),
                                          device="cpu"),
    }
    out = {}
    try:
        jobs = {}
        for name, ex in executors.items():
            ex.start()
            normalized, reason = (jax_executor if name == "jax"
                                  else port_executor).validate_spec(spec)
            assert reason is None
            jobs[name], _ = ex.submit(normalized)
        for name, ex in executors.items():
            row = wait_state(ex, jobs[name].job_id,
                             ("completed", "failed"), timeout_s=240.0)
            path = ex.results_path(jobs[name].job_id)
            assert row["state"] == "completed", row
            with open(path, "rb") as f, \
                    open(f"{path}.containers.jsonl", "rb") as g:
                out[name] = (row, f.read(), g.read())
    finally:
        for ex in executors.values():
            ex.close()
    (want_row, want, want_c), (got_row, got, got_c) = out["jax"], out["port"]
    assert got == want and got_c == want_c
    assert len(want.splitlines()) == 14 and want_c
    drop = ("job_id", "elapsed_s", "shard_bytes")
    assert {k: v for k, v in got_row.items() if k not in drop} == \
        {k: v for k, v in want_row.items() if k not in drop}


def test_a_stripe_without_a_card_fails_its_job(tmp_path):
    """On a host without a CUDA device a job on the card fails with the
    stripe child's error: nothing reruns it on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device (the card test covers it)")
    entries = write_job_inputs(str(tmp_path / "in"))[:2]
    ex = port_executor.JobExecutor(str(tmp_path / "jobs"))
    ex.start()
    try:
        job, _ = ex.submit(spec_of(PORT, entries))
        row = wait_state(ex, job.job_id, port_executor.TERMINAL_STATES,
                         timeout_s=120.0)
    finally:
        ex.close()
    assert row["state"] == "failed", row
    assert "failing deterministically" in row["error"]
    assert ex.results_path(job.job_id) is None


# -- the HTTP edge and the jobs verb -----------------------------------------------


class JobsFleet:
    """One stub worker, a router, the HTTP edge and a stub-runner
    executor of ``side`` under ``root``."""

    def __init__(self, side, root: str, factory=None):
        os.makedirs(root, exist_ok=True)
        self.side = side
        sock = os.path.join(root, "w0.sock")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", side.stub, "--socket", sock,
             "--name", "w0", "--service-ms", "1"], env=STUB_ENV,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        deadline = time.perf_counter() + 15.0
        while True:
            try:
                side.oneshot(sock, {"op": "stats"}, 1.0)
                break
            except side.WireError:
                if time.perf_counter() > deadline:
                    raise
                time.sleep(0.02)
        self.router = side.Router({"w0": sock}, probe_interval_s=0.1,
                                  request_timeout_s=10.0,
                                  dispatch_wait_s=5.0, trace_sample=1.0)
        self.router.start()
        Quick, _Gate = runners(side)
        self.executor = side.executor.JobExecutor(
            os.path.join(root, "jobs"), registry=self.router.obs.registry,
            runner_factory=factory or (lambda j, cb: Quick(j, cb)))
        self.executor.start()
        self.edge = side.edge.HttpEdgeServer(
            "127.0.0.1:0", self.router, tokens={TOKEN: "tester"},
            rate_per_client=10000.0, stall_timeout_s=1.0,
            jobs=self.executor)
        self.target = f"127.0.0.1:{self.edge.bound_port}"
        self.thread = threading.Thread(
            target=self.edge.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True)
        self.thread.start()

    def client(self, token=TOKEN):
        return self.side.client.JobsClient(self.target, token=token)

    def close(self):
        self.edge.shutdown()
        self.edge.server_close()
        self.thread.join(timeout=5.0)
        self.executor.close()
        self.router.close()
        self.proc.kill()
        self.proc.wait()


def edge_answers(side, root: str) -> list:
    """Every `/jobs*` exchange of the JAX package's edge tests, each as
    (status, headers, body)."""
    import base64

    gate, poison = threading.Event(), threading.Event()
    Quick, Gate = runners(side)

    def factory(job, cb):
        if job.spec.get("idempotency_key") == "gated":
            return Gate(job, cb, gate, poison)
        return Quick(job, cb)

    fleet = JobsFleet(side, root, factory)
    out = []
    client = fleet.client()

    def ask(method, path, body=None):
        code, headers, payload = client.request(method, path, body)
        out.append((code, sorted(headers.items()), payload.decode()))
        try:
            return json.loads(payload)
        except ValueError:
            return None

    try:
        spec = {"manifest": ["/a", "/b"], "stripes": 1,
                "idempotency_key": "flow"}
        row = ask("POST", "/jobs", json.dumps(spec).encode())
        job_id = row["job_id"]
        client.wait(job_id, timeout_s=15.0)
        ask("GET", f"/jobs/{job_id}")
        ask("POST", "/jobs", json.dumps(spec).encode())
        ask("GET", f"/jobs/{job_id}/results")
        ask("GET", f"/jobs/{job_id}/containers")
        ask("GET", "/jobs/deadbeefdead")
        ask("GET", "/jobs/deadbeefdead/results")
        ask("GET", "/jobs/NOPE!")
        ask("POST", "/jobs", b"{nope")
        ask("POST", "/jobs", b'{"manifest": []}')
        ask("POST", "/jobs", b'{"manifest": ["/a"], "options": {"x": 1}}')
        ask("PUT", "/jobs")
        row = ask("POST", "/jobs", json.dumps(
            {"manifest": ["/a"], "idempotency_key": "gated"}).encode())
        gated = row["job_id"]
        wait_state(fleet.executor, gated, ("running",))
        ask("GET", f"/jobs/{gated}/results")
        ask("DELETE", f"/jobs/{gated}")
        client.wait(gated, timeout_s=15.0)
        ask("GET", f"/jobs/{gated}")
        ask("DELETE", "/jobs/deadbeefdead")
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tf:
            info = tarfile.TarInfo("pkg/LICENSE")
            info.size = 12
            info.mtime = 1_600_000_000
            tf.addfile(info, io.BytesIO(b"MIT License\n"))
        row = ask("POST", "/jobs", json.dumps({
            "archive_b64": base64.b64encode(buf.getvalue()).decode(),
            "archive_name": "up.tar", "stripes": 1}).encode())
        client.wait(row["job_id"], timeout_s=15.0)
        ask("GET", f"/jobs/{row['job_id']}/results")
        ask("POST", "/jobs", b'{"archive_b64": "!!!"}')
        bad = fleet.client(token="wrong")
        try:
            code, _row = bad.submit({"manifest": ["/a"]})
            out.append(code)
        finally:
            bad.close()
    finally:
        poison.set()
        gate.set()
        client.close()
        fleet.close()
    return out


def test_edge_jobs_answers_match_jax(tmp_path):
    # equal-length roots: a body's length names the paths in it
    want, got = (mask(edge_answers(side, str(tmp_path / side.name[:3])),
                      str(tmp_path / side.name[:3])) for side in SIDES)
    assert got == want
    codes = [row[0] for row in json.loads(want)[:-1]]
    assert codes[:8] == [202, 200, 200, 200, 200, 404, 404, 404]
    assert json.loads(want)[-1] == 401


def cli(main, argv):
    """(exit code, stdout, stderr) of one in-process CLI call; stdout
    has a byte buffer, as `jobs results` writes bytes."""
    raw = io.BytesIO()
    out = io.TextIOWrapper(raw, encoding="utf-8")
    err = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    out.flush()
    return rc, raw.getvalue().decode(), err.getvalue()


def verb_answers(side, root: str) -> list:
    """The `jobs` verb of ``side``'s CLI against ``side``'s edge."""
    fleet = JobsFleet(side, root)
    manifest = os.path.join(root, "m.txt")
    with open(manifest, "w", encoding="utf-8") as f:
        f.write("/a\n\n/b\n")
    edge = ["--edge", fleet.target, "--token", TOKEN]
    out = []
    try:
        def run(*argv):
            got = cli(side.main, ["jobs", *argv])
            out.append(got)
            return got

        _rc, stdout, _err = run("submit", *edge, "--manifest", manifest,
                                "--stripes", "1", "--option",
                                "batch_size=16", "--option", "mode=license",
                                "--idempotency-key", "v1", "--wait")
        job_id = json.loads(stdout)["job_id"]
        run("submit", *edge, "--manifest", manifest, "--idempotency-key",
            "v1")
        for action in ("status", "wait", "results", "containers"):
            run(action, job_id, *edge)
        run("results", job_id, *edge, "--output",
            os.path.join(root, "r.jsonl"))
        with open(os.path.join(root, "r.jsonl"), encoding="utf-8") as f:
            out.append(f.read())
        run("cancel", job_id, *edge)
        run("status", "deadbeefdead", *edge)
        run("results", "deadbeefdead", *edge)
        run("status", *edge)
        run("submit", *edge)
        run("submit", *edge, "--manifest", manifest, "--option", "nokey")
        run("submit", *edge, "--manifest", os.path.join(root, "none"))
        run("submit", *edge, "--manifest", manifest, "--option", "argv=rm")
        run("submit", "--edge", fleet.target, "--token", "wrong",
            "--manifest", manifest)
    finally:
        fleet.close()
    run_refused = cli(side.main, ["jobs", "status", "abc", "--edge",
                                  fleet.target])
    out.append(run_refused[0])
    return out


def test_jobs_verb_matches_jax(tmp_path):
    want, got = (
        mask(verb_answers(side, str(tmp_path / side.name)),
             str(tmp_path / side.name)).replace("licensee-tpu-torch",
                                                "licensee-tpu")
        for side in SIDES)
    assert got == want
    rows = json.loads(want)
    assert rows[0][0] == 0 and json.loads(rows[0][1])["state"] == \
        "completed"
    assert rows[-1] == 1  # the edge is gone: cannot reach it


def test_jobs_help_matches_jax():
    """`help jobs` and the listing's line are the JAX CLI's, the program
    name (and the wrapping it moves) aside."""
    want = cli(jax_main, ["help", "jobs"])
    got = cli(port_main, ["help", "jobs"])
    assert got[0] == want[0] == 0
    assert got[1].replace("licensee-tpu-torch", "licensee-tpu").split() == \
        want[1].split()
    jax_line = [line for line in cli(jax_main, ["help"])[1].splitlines()
                if line.split()[1:2] == ["jobs"]]
    port_line = [line for line in cli(port_main, ["help"])[1].splitlines()
                 if line.split()[1:2] == ["jobs"]]
    assert [line.replace("licensee-tpu-torch", "licensee-tpu")
            for line in port_line] == jax_line != []


# -- chip_smoke.py's phase 12 on the CPU -------------------------------------------


def test_chip_smoke_phase12_on_cpu():
    """Phase 12 at its tiny size with `device="cpu"`: the tenant fleet
    answers each token from its own pool and fingerprint, acme's roll
    moves acme alone, jobs (a) and (b) give the CPU executor's bytes, and
    the native parity selftest passes; nothing launches on a card."""
    import numpy as np
    import torch

    import chip_smoke

    report = chip_smoke.phase_tenancy(np, torch, seed=0, device="cpu",
                                      scale=chip_smoke.TenancyScale.tiny())
    timing = report["timing"]
    assert set(report["launches"].values()) == {0}
    assert list(timing["runs"]) == [
        "acme T=47", "beta T=608", "beta T=608 during the roll",
        "acme after the roll"]
    assert timing["jobs"]["a"]["stripes"] == 2
    assert timing["jobs"]["b"]["rows"] == 1000
    assert "parity OK" in timing["native"]
