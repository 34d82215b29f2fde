"""The durable-jobs selftest (``fleet --selftest-jobs`` of the port's CLI).

The port's copy of `licensee_tpu/jobs/selftest.py`.  The one
end-to-end crash drill the jobs tier promises: a REAL fleet
process (stub or serve workers + router + front socket + HTTP edge +
JobExecutor, booted by this module's ``__main__`` child mode) takes a
tar-manifest job over ``POST /jobs``, and the WHOLE process tree —
executor, its stripe children, the workers — is SIGKILLed mid-drain.
A second fleet process booted on the same jobs dir must replay the
journal, resume the interrupted job from its stripe shards, and serve
merged results byte-identical to a direct ``StripeRunner`` run of the
same spec (the ``batch-detect --stripes`` machinery).  The gates:

* the job completed BEFORE the kill stays completed after replay;
* the killed job resumes (``resumed`` in its status) and completes;
* its merged results JSONL and container-verdict sidecar are
  sha256-identical to the direct striped reference run;
* zero client-visible errors: every HTTP round trip answers its
  expected code (202 accepted, 200 status/results, 401 bad token,
  404 unknown id, 409 results-before-done, 200 duplicate submit —
  idempotency keys survive the restart via the journal);
* a job submitted to the restarted fleet assembles ONE trace tree
  joining the edge's submit span (proc ``router``) and the executor's
  queue-wait/stripe/merge spans (proc ``jobs``) over the front
  socket's ``{"op": "traces"}`` verb.

``stub=True`` (the CI path) runs the protocol-faithful stub worker
behind the router in place of a serve worker on ``device``; the stripe
children are ALWAYS real batch-detect processes, on ``device`` (the
card unless ``"cpu"`` is asked for) — resume byte-identity is the
whole point, and the reference run is a StripeRunner on the same
device.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import signal
import subprocess
import sys
import tarfile
import threading
import time

_EDGE_TOKEN = "jobs-selftest-token"


# -- the child: one fleet process with a jobs tier -----------------------


def _stub_argv(name: str, sock: str) -> list[str]:
    return [
        sys.executable, "-m", "licensee_tpu_torch.fleet.faults",
        "--socket", sock, "--name", name, "--service-ms", "5",
    ]


def _serve_argv(name: str, sock: str, device: str) -> list[str]:
    return [
        sys.executable, "-m", "licensee_tpu_torch.cli.main", "serve",
        "--socket", sock, "--max-delay-ms", "5", "--device", device,
    ]


def _serve_child(jobs_dir: str, stub: bool, device: str) -> int:
    """Boot worker + router + front socket + HTTP edge + JobExecutor
    over ``jobs_dir``, write one READY line (JSON: edge port, front
    socket path) to stdout, and serve until killed.  The drill parent
    SIGKILLs this process's whole group — there is no graceful exit."""
    from licensee_tpu_torch.fleet.http_edge import HttpEdgeServer
    from licensee_tpu_torch.fleet.router import FrontServer, Router
    from licensee_tpu_torch.fleet.supervisor import Supervisor, worker_env
    from licensee_tpu_torch.jobs.executor import JobExecutor

    run_dir = os.path.join(jobs_dir, "run")
    os.makedirs(run_dir, exist_ok=True)
    # per-boot socket names: the previous incarnation's files survive
    # its SIGKILL, and a rebind on the same path would refuse
    worker_sock = os.path.join(run_dir, f"w0-{os.getpid()}.sock")
    front_sock = os.path.join(run_dir, f"front-{os.getpid()}.sock")
    env = worker_env(None, None)
    boot_timeout = 30.0 if stub else 300.0
    supervisor = Supervisor(
        {"w0": worker_sock},
        argv_for=(
            _stub_argv if stub
            else lambda name, sock: _serve_argv(name, sock, device)
        ),
        env_for=lambda name, chips: env,
        probe_interval_s=0.25,
        startup_grace_s=boot_timeout,
    )
    supervisor.start()
    if not supervisor.wait_healthy(boot_timeout):
        sys.stderr.write(
            f"jobs-selftest child: worker never healthy: "
            f"{supervisor.status()}\n"
        )
        supervisor.stop()
        return 1
    router = Router(
        {"w0": worker_sock},
        supervisor=supervisor,
        probe_interval_s=0.25,
        trace_sample=1.0,
    )
    router.start()
    executor = JobExecutor(
        jobs_dir,
        max_concurrent=1,
        registry=router.obs.registry,
        device=device,
    )
    executor.start()
    router.collector.add_source("jobs", executor.trace_tail)
    front = FrontServer(front_sock, router, stall_timeout_s=5.0)
    edge = HttpEdgeServer(
        "127.0.0.1:0", router,
        tokens={_EDGE_TOKEN: "drill"},
        rate_per_client=100000.0,
        stall_timeout_s=5.0,
        jobs=executor,
    )
    threading.Thread(
        target=front.serve_forever, kwargs={"poll_interval": 0.05},
        daemon=True,
    ).start()
    sys.stdout.write(json.dumps({
        "ready": True,
        "port": edge.bound_port,
        "front": front_sock,
        "resumed": executor.resumed_jobs,
    }) + "\n")
    sys.stdout.flush()
    try:
        edge.serve_forever(poll_interval=0.05)
    except KeyboardInterrupt:
        pass
    return 0


# -- the drill parent ----------------------------------------------------


def _build_corpus(tmpdir: str) -> tuple[list[str], str]:
    """42 synthetic license files plus a tarball of all of them under
    their absolute names (so per-blob JSONL rows from the tar run are
    byte-identical to a loose-file run — the stripes selftest's
    construction)."""
    import re

    from licensee_tpu_torch.corpus.license import License

    bodies = [
        re.sub(r"\[(\w+)\]", "example", License.find(k).content or "")
        for k in ("mit", "isc", "bsd-3-clause")
    ]
    paths = []
    for i in range(42):
        p = os.path.join(tmpdir, f"LICENSE_{i}")
        with open(p, "w", encoding="utf-8") as f:
            f.write(
                f"Copyright (c) {2000 + i} Example Author {i}\n\n"
                + bodies[i % len(bodies)]
            )
        paths.append(p)
    tar_path = os.path.join(tmpdir, "archive.tar")
    with tarfile.open(tar_path, "w") as tf:
        for p in paths:
            with open(p, "rb") as f:
                data = f.read()
            info = tarfile.TarInfo(name=p)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return paths, tar_path


def _reference_run(
    tmpdir: str, tar_path: str, stripes: int, say, device: str,
) -> tuple[bytes, bytes]:
    """The direct ``batch-detect --stripes`` run the job's results
    must byte-match: same manifest, same stripe count, same forwarded
    knobs, the same device, no jobs tier in the path."""
    from licensee_tpu_torch.parallel.stripes import StripeRunner

    manifest = os.path.join(tmpdir, "ref_manifest.txt")
    with open(manifest, "w", encoding="utf-8") as f:
        f.write(f"{tar_path}::*\n")
    out = os.path.join(tmpdir, "ref.jsonl")
    runner = StripeRunner(
        manifest, out, stripes,
        forward_args=("--batch-size", "16", "--mesh", "none",
                      "--device", device),
        on_event=say,
    )
    runner.run()
    with open(out, "rb") as f:
        results = f.read()
    with open(f"{out}.containers.jsonl", "rb") as f:
        containers = f.read()
    return results, containers


def _spawn_fleet(
    jobs_dir: str, stub: bool, device: str, log_path: str,
    timeout_s: float,
) -> tuple[subprocess.Popen | None, dict | None]:
    """Start one fleet child in its OWN session (so ``killpg`` takes
    the executor AND its stripe children down in one blow) and wait
    for its READY line."""
    argv = [
        sys.executable, "-m", "licensee_tpu_torch.jobs.selftest",
        "--serve", "--jobs-dir", jobs_dir, "--device", device,
    ]
    if stub:
        argv.append("--stub")
    log = open(log_path, "ab")
    try:
        proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=log,
            start_new_session=True,
        )
    finally:
        log.close()
    box: dict = {}

    def read() -> None:
        line = proc.stdout.readline()
        try:
            row = json.loads(line)
            if isinstance(row, dict):
                box.update(row)
        except json.JSONDecodeError:
            box["raw"] = line.decode("utf-8", "replace")

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    if not box.get("ready"):
        _killpg(proc)
        return None, None
    return proc, box


def _killpg(proc: subprocess.Popen) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (OSError, ProcessLookupError):
        pass
    try:
        proc.wait(timeout=10.0)
    except subprocess.TimeoutExpired:
        pass
    if proc.stdout is not None:
        proc.stdout.close()


def _tail_of(path: str, n: int = 800) -> str:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return ""
    return data[-n:].decode("utf-8", "replace")


def selftest_jobs(verbose: bool = True, stub: bool = True,
                  device: str = "cuda") -> int:
    """Run the drill on ``device``; returns 0 on success, 1 with a
    problem report."""
    import tempfile

    from licensee_tpu_torch.fleet.wire import WireError, oneshot
    from licensee_tpu_torch.jobs.client import JobsClient, JobsClientError

    stream = sys.stderr

    def say(msg: str) -> None:
        if verbose:
            stream.write(f"jobs-selftest: {msg}\n")
            stream.flush()

    problems: list[str] = []
    boot_timeout = 30.0 if stub else 300.0
    job_timeout = 180.0 if stub else 600.0
    kill_had_shard_bytes = False
    resume_s = None
    resumed_row: dict = {}
    sha_match = False
    procs_joined: list[str] = []
    child_a = child_b = None
    client = None
    with tempfile.TemporaryDirectory(prefix="licensee-jobs-") as tmpdir:
        jobs_dir = os.path.join(tmpdir, "jobs")
        os.makedirs(jobs_dir)
        log_a = os.path.join(tmpdir, "fleet-a.log")
        log_b = os.path.join(tmpdir, "fleet-b.log")
        try:
            paths, tar_path = _build_corpus(tmpdir)
            say("reference run: direct 2-stripe batch-detect")
            ref_results, ref_containers = _reference_run(
                tmpdir, tar_path, 2, say, device
            )
            ref_sha = hashlib.sha256(ref_results).hexdigest()

            say("booting fleet A (stub workers)" if stub
                else "booting fleet A (serve workers)")
            child_a, ready = _spawn_fleet(
                jobs_dir, stub, device, log_a, boot_timeout
            )
            if child_a is None:
                problems.append(
                    f"fleet A never became ready: {_tail_of(log_a)!r}"
                )
                raise _Abort()
            target = f"127.0.0.1:{ready['port']}"

            # -- auth: a wrong bearer token answers 401 --
            bad = JobsClient(target, token="wrong-token")
            try:
                code, _row = bad.submit({"manifest": ["x"]})
            finally:
                bad.close()
            if code != 401:
                problems.append(f"bad token answered {code}, wanted 401")

            client = JobsClient(target, token=_EDGE_TOKEN)

            # -- a 404 for an id the journal has never seen --
            code, row = client.status("deadbeefdead")
            if code != 404:
                problems.append(
                    f"unknown job id answered {code}: {row}"
                )

            # -- job 1: small, completes before the kill --
            spec1 = {
                "manifest": paths[:6],
                "stripes": 1,
                "options": {"batch_size": 16, "mesh": "none"},
                "idempotency_key": "drill-job1",
            }
            code, row = client.submit(spec1)
            if code != 202:
                problems.append(f"job1 submit answered {code}: {row}")
                raise _Abort()
            job1 = row["job_id"]
            row = client.wait(job1, timeout_s=job_timeout)
            if row.get("state") != "completed":
                problems.append(f"job1 never completed: {row}")
                raise _Abort()
            say(f"job1 {job1}: completed "
                f"({row.get('rows_written')} rows)")

            # -- duplicate submit, same idempotency key: original id --
            code, row = client.submit(spec1)
            if code != 200 or row.get("job_id") != job1 or not row.get(
                "duplicate"
            ):
                problems.append(
                    f"duplicate submit answered {code}: {row}"
                )

            # -- job 2: the victim — tar manifest, 2 stripes --
            spec2 = {
                "manifest": [f"{tar_path}::*"],
                "stripes": 2,
                "options": {"batch_size": 16, "mesh": "none"},
                "idempotency_key": "drill-job2",
            }
            code, row = client.submit(spec2)
            if code != 202:
                problems.append(f"job2 submit answered {code}: {row}")
                raise _Abort()
            job2 = row["job_id"]

            # -- results before completion: 409 --
            code, payload = client.results(job2)
            if code != 409:
                problems.append(
                    f"early results answered {code}, wanted 409"
                )

            # -- SIGKILL the whole fleet A tree mid-drain --
            deadline = time.perf_counter() + job_timeout
            killed = False
            while time.perf_counter() < deadline:
                code, row = client.status(job2)
                if code != 200:
                    problems.append(
                        f"job2 status poll answered {code}: {row}"
                    )
                    raise _Abort()
                if row.get("state") in ("completed", "failed"):
                    problems.append(
                        f"job2 reached {row['state']} before the kill "
                        "landed — the drill never drilled"
                    )
                    raise _Abort()
                if row.get("state") == "running" and row.get(
                    "first_progress"
                ):
                    kill_had_shard_bytes = bool(row.get("shard_bytes"))
                    say(
                        f"job2 {job2}: running "
                        f"(shard_bytes={row.get('shard_bytes')}) — "
                        "SIGKILL fleet A"
                    )
                    _killpg(child_a)
                    killed = True
                    break
                time.sleep(0.05)
            if not killed:
                problems.append("job2 never reached running+progress")
                raise _Abort()
            client.close()
            client = None

            # -- fleet B on the same jobs dir: replay + resume --
            say("booting fleet B on the same jobs dir")
            t_resume = time.perf_counter()
            child_b, ready = _spawn_fleet(
                jobs_dir, stub, device, log_b, boot_timeout
            )
            if child_b is None:
                problems.append(
                    f"fleet B never became ready: {_tail_of(log_b)!r}"
                )
                raise _Abort()
            if ready.get("resumed") != 1:
                problems.append(
                    f"fleet B resumed {ready.get('resumed')} job(s), "
                    "wanted exactly the killed one"
                )
            target = f"127.0.0.1:{ready['port']}"
            front_sock = ready["front"]
            client = JobsClient(target, token=_EDGE_TOKEN)

            # -- the executor's black box survived the SIGKILL: fleet
            # A's flight recorder spilled its submit/finish events to
            # the jobs dir before the kill, and the harvest must not
            # come back empty (the whole point of a black box) --
            from licensee_tpu_torch.obs import load_flight_dump

            box = load_flight_dump(os.path.join(jobs_dir, "flight.json"))
            box_kinds = {
                e.get("kind") for e in (box or {}).get("events") or ()
            }
            if not box or not box_kinds:
                problems.append(
                    "executor flight recorder left no harvest after "
                    f"the SIGKILL drill: {box}"
                )
            elif not box_kinds & {"job_submit", "job_resume"}:
                # fleet A's box carries the submits; if fleet B's
                # flusher already rewrote the file, its replay carries
                # the resume of the killed job — either proves the
                # black box closed the loop
                problems.append(
                    f"flight harvest has no job events: {box_kinds}"
                )
            else:
                say(f"flight harvest: {sorted(box_kinds)}")

            # the completed job survived the journal replay
            code, row = client.status(job1)
            if code != 200 or row.get("state") != "completed":
                problems.append(
                    f"job1 after replay: {code} {row} — a terminal "
                    "state was lost"
                )

            # the idempotency key survived too: resubmit folds to the
            # SAME job id across the restart
            code, row = client.submit(spec2)
            if code != 200 or row.get("job_id") != job2:
                problems.append(
                    f"job2 resubmit after restart answered {code}: "
                    f"{row} — the idempotency fence broke"
                )

            resumed_row = client.wait(job2, timeout_s=job_timeout)
            resume_s = time.perf_counter() - t_resume
            if resumed_row.get("state") != "completed":
                problems.append(f"job2 never completed: {resumed_row}")
                raise _Abort()
            if not resumed_row.get("resumed"):
                problems.append(
                    f"job2 completed without the resumed flag: "
                    f"{resumed_row} — did the replay re-run it fresh?"
                )
            say(f"job2 {job2}: resumed and completed "
                f"({resumed_row.get('rows_written')} rows)")

            # -- byte identity against the direct striped run --
            code, payload = client.results(job2)
            if code != 200:
                problems.append(f"job2 results answered {code}")
                raise _Abort()
            got_sha = hashlib.sha256(payload).hexdigest()
            sha_match = got_sha == ref_sha
            if not sha_match:
                problems.append(
                    f"job2 results sha {got_sha[:16]} != direct-run "
                    f"sha {ref_sha[:16]} ({len(payload)} vs "
                    f"{len(ref_results)} bytes)"
                )
            code, payload = client.containers(job2)
            if code != 200 or payload != ref_containers:
                problems.append(
                    f"job2 container sidecar mismatch (code {code}, "
                    f"{len(payload)} vs {len(ref_containers)} bytes)"
                )

            # -- the assembled trace: edge submit + executor spans --
            spec3 = {
                "manifest": paths[:4],
                "stripes": 1,
                "options": {"batch_size": 16, "mesh": "none"},
            }
            code, row = client.submit(spec3)
            if code != 202 or not row.get("trace"):
                problems.append(
                    f"job3 submit answered {code}: {row} (no trace id)"
                )
                raise _Abort()
            job3, trace_id = row["job_id"], row["trace"]
            row = client.wait(job3, timeout_s=job_timeout)
            if row.get("state") != "completed":
                problems.append(f"job3 never completed: {row}")
                raise _Abort()
            try:
                answer = oneshot(
                    front_sock,
                    {"op": "traces", "n": 5, "trace_id": trace_id},
                    10.0,
                )
            except WireError as exc:
                problems.append(f"traces verb failed: {exc}")
                answer = {}
            trees = answer.get("traces") or []
            if not trees:
                problems.append(
                    f"no assembled tree for job3 trace {trace_id}"
                )
            else:
                procs_joined = trees[0].get("procs") or []
                span_names = _span_names(trees[0].get("root") or {})
                if "jobs" not in procs_joined:
                    problems.append(
                        f"assembled tree joined procs {procs_joined} "
                        "— the executor's spans are missing"
                    )
                if "router" not in procs_joined:
                    problems.append(
                        f"assembled tree joined procs {procs_joined} "
                        "— the edge submit span is missing"
                    )
                if not any(n.startswith("stripe") for n in span_names):
                    problems.append(
                        f"no stripe span in the tree: {span_names}"
                    )
        except _Abort:
            pass
        except (OSError, JobsClientError, KeyError) as exc:
            problems.append(
                f"selftest crashed: {type(exc).__name__}: {exc}"
            )
        finally:
            if client is not None:
                client.close()
            for child in (child_a, child_b):
                if child is not None:
                    _killpg(child)
        if problems:
            for log in (log_a, log_b):
                tail = _tail_of(log)
                if tail:
                    say(f"{os.path.basename(log)} tail: {tail!r}")
    if verbose:
        stream.write(json.dumps({
            "jobs_selftest": "ok" if not problems else "FAIL",
            "stub_workers": stub,
            "device": device,
            "resumed_state": resumed_row.get("state"),
            "resume_s": resume_s,
            "results_sha_match": sha_match,
            "shards_had_bytes_at_kill": kill_had_shard_bytes,
            "trace_procs": procs_joined,
            "problems": problems,
        }) + "\n")
        stream.flush()
    return 0 if not problems else 1


class _Abort(Exception):
    """Bail out of the drill body into cleanup; the problem that
    triggered it is already recorded."""


def _span_names(node: dict) -> list[str]:
    names = [node.get("name", "")]
    for child in node.get("children") or []:
        if isinstance(child, dict):
            names.extend(_span_names(child))
    return names


def _main(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="jobs-selftest")
    parser.add_argument("--serve", action="store_true")
    parser.add_argument("--jobs-dir", default=None)
    parser.add_argument("--stub", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.serve:
        if not args.jobs_dir:
            sys.stderr.write("--serve needs --jobs-dir\n")
            return 2
        return _serve_child(args.jobs_dir, args.stub, args.device)
    return selftest_jobs(stub=args.stub, device=args.device)


if __name__ == "__main__":
    raise SystemExit(_main(sys.argv[1:]))
