"""The job executor: a library parent over the striped batch runner.

The port's copy of `licensee_tpu/jobs/executor.py`.  ``JobExecutor``
owns a jobs directory (journal + one subdirectory per job), a bounded
pool of job-runner threads, and a ``proc="jobs"`` tracer whose tail the
fleet's TraceCollector pulls so job spans join the assembled trace
trees.  Each running job IS a
:class:`~licensee_tpu_torch.parallel.stripes.StripeRunner` — the
executor adds exactly what the CLI parent never needed: durable
submission (the journal), idempotent duplicate detection, bounded
concurrency, per-job cancellation, and resume-on-restart.

Every stripe child is a `batch-detect` process on the executor's
``device`` (``--device D`` in its argv; the card unless ``"cpu"`` is
asked for).  The device is the executor's, never a spec option: the
spec's options are the JAX package's closed set, so a spec valid in one
package is valid in the other.  A child that cannot open the card exits
non-zero and the job fails with its error; nothing reruns it on the CPU.

Resume is the executor's one hard promise: a SIGKILLed executor
replays the journal on ``start()``, re-enqueues every job that never
reached a terminal state, and the re-run StripeRunner resumes each
stripe from its shard's completed prefix — the merged output is
bit-identical to an uninterrupted run because the shards and the
merge are (parallel/stripes.py's contract, drilled by the jobs
selftest).

Threading: ``submit``/``cancel``/``status`` are thread-safe and
non-blocking apart from journal fsyncs and small file reads — the
HTTP edge calls them from the router's ops executor, never the event
loop.  House rules: monotonic clocks only, no prints.
"""

from __future__ import annotations

import json
import os
import threading
import time

from licensee_tpu_torch.obs import FlightRecorder, MetricsRegistry, Tracer
from licensee_tpu_torch.parallel.distributed import shard_output_path
from licensee_tpu_torch.parallel.stripes import (
    StripeError,
    StripeRunner,
    StripeStopped,
)

from licensee_tpu_torch.jobs.journal import JobJournal

__all__ = [
    "JOB_STATES",
    "Job",
    "JobExecutor",
    "TERMINAL_STATES",
    "validate_spec",
]

# the lifecycle: queued -> running -> one terminal state.  A resumed
# job re-enters "queued" (its journal already says "running"; replay
# folds to the LAST record, and the executor re-appends "running" when
# a thread picks it up again).
JOB_STATES: tuple[str, ...] = (
    "queued", "running", "completed", "failed", "cancelled",
)
TERMINAL_STATES: frozenset[str] = frozenset(
    ("completed", "failed", "cancelled")
)

# submit-spec "options" the executor will forward to the batch-detect
# children, typed: everything else in the options dict is refused (an
# authenticated client still never composes child argv directly)
_OPTION_FORWARD: dict[str, tuple[type, str]] = {
    "batch_size": (int, "--batch-size"),
    "workers": (int, "--workers"),
    "mesh": (str, "--mesh"),
    "mode": (str, "--mode"),
    "corpus": (str, "--corpus"),
    "method": (str, "--method"),
    "confidence": (float, "--confidence"),
}

# runner-level options, typed like the forwarded ones but consumed by
# the SUPERVISOR (the elastic autoscaler's bounds/cooldown) — they
# never reach child argv, and they only make sense with
# spec.stripes == "elastic"
_RUNNER_OPTIONS: dict[str, type] = {
    "autoscale_min": int,
    "autoscale_max": int,
    "autoscale_cooldown_s": float,
}

_MAX_MANIFEST_ENTRIES = 1_000_000
_MAX_STRIPES = 64


def validate_spec(spec) -> tuple[dict | None, str | None]:
    """Normalize a submit spec: returns ``(normalized, None)`` or
    ``(None, reason)``.  A spec names the work (manifest entries in
    the ingest grammar — loose paths and ``tar::*``/``zip::*``/
    ``repo.git::REV`` container forms), the stripe count, and typed
    child options; it never carries raw argv."""
    if not isinstance(spec, dict):
        return None, "spec must be a JSON object"
    manifest = spec.get("manifest")
    if not isinstance(manifest, list) or not manifest:
        return None, "spec.manifest must be a non-empty list of entries"
    if len(manifest) > _MAX_MANIFEST_ENTRIES:
        return None, (
            f"spec.manifest has {len(manifest)} entries, over the "
            f"{_MAX_MANIFEST_ENTRIES} cap"
        )
    entries: list[str] = []
    for entry in manifest:
        if not isinstance(entry, str) or not entry.strip():
            return None, "spec.manifest entries must be non-empty strings"
        if "\n" in entry:
            return None, "spec.manifest entries must not embed newlines"
        entries.append(entry.strip())
    stripes = spec.get("stripes", 1)
    if stripes != "elastic" and (
        not isinstance(stripes, int) or isinstance(stripes, bool)
        or not (1 <= stripes <= _MAX_STRIPES)
    ):
        return None, (
            f"spec.stripes must be an int in [1, {_MAX_STRIPES}] or "
            "'elastic'"
        )
    options = spec.get("options", {})
    if not isinstance(options, dict):
        return None, "spec.options must be an object"
    normalized_options: dict = {}
    for name, value in options.items():
        typed = _OPTION_FORWARD.get(name)
        if typed is None:
            want = _RUNNER_OPTIONS.get(name)
            if want is None:
                return None, f"unknown option {name!r}"
            if stripes != "elastic":
                return None, (
                    f"option {name!r} needs spec.stripes = 'elastic'"
                )
        else:
            want, _flag = typed
        if want is float and isinstance(value, int):
            value = float(value)
        if not isinstance(value, want) or isinstance(value, bool):
            return None, f"option {name!r} must be {want.__name__}"
        normalized_options[name] = value
    if stripes == "elastic":
        lo = normalized_options.get("autoscale_min", 1)
        hi = normalized_options.get("autoscale_max", 8)
        if not 1 <= lo <= hi <= _MAX_STRIPES:
            return None, (
                "need 1 <= autoscale_min <= autoscale_max <= "
                f"{_MAX_STRIPES}, got [{lo}, {hi}]"
            )
        if normalized_options.get("autoscale_cooldown_s", 30.0) < 0:
            return None, "autoscale_cooldown_s must be >= 0"
    key = spec.get("idempotency_key")
    if key is not None and (
        not isinstance(key, str) or not key or len(key) > 200
    ):
        return None, "spec.idempotency_key must be a short string"
    problem = _probe_remote_entries(entries)
    if problem is not None:
        return None, problem
    return {
        "manifest": entries,
        "stripes": stripes,
        "options": normalized_options,
        "idempotency_key": key,
    }, None


def _probe_remote_entries(entries: list[str]) -> str | None:
    """Submit-time validation of remote-source manifest entries: a
    cheap HEAD + 1-byte ranged probe of each distinct remote container
    URL (ingest/remote.py), so an unreachable artifact, a server
    without Range support, or a refused shape (git-over-HTTP) is a 400
    at SUBMIT — not a stripe crash minutes into the job.  validate_spec
    runs on the edge's ops thread (like check_corpus_source's
    submit-time IO), never on the event loop."""
    from licensee_tpu_torch.ingest.remote import (
        RemoteError,
        probe_remote,
        remote_entry_kind,
    )
    from licensee_tpu_torch.ingest.sources import SEP

    seen: set[str] = set()
    for entry in entries:
        container = entry.split(SEP, 1)[0]
        if container in seen or remote_entry_kind(container) is None:
            continue
        seen.add(container)
        try:
            probe_remote(container, timeout_s=5.0)
        except RemoteError as exc:
            return f"remote source {container!r} failed its probe: {exc}"
    return None


def forward_args_for(options: dict) -> tuple[str, ...]:
    """The child argv fragment a normalized options dict forwards."""
    forward: list[str] = []
    for name, value in sorted(options.items()):
        typed = _OPTION_FORWARD.get(name)
        if typed is None:
            continue  # runner-level option (autoscale_*): never argv
        _want, flag = typed
        forward += [flag, str(value)]
    return tuple(forward)


class Job:
    """One job's in-memory state: identity, normalized spec, lifecycle,
    and live progress (fed by the runner's structured callbacks plus
    the per-stripe stats artifacts as each stripe completes)."""

    def __init__(self, job_id: str, spec: dict, job_dir: str,
                 trace_id: str | None = None):
        self.job_id = job_id
        self.spec = spec
        self.job_dir = job_dir
        self.trace_id = trace_id
        self.manifest_path = os.path.join(job_dir, "manifest.txt")
        self.output_path = os.path.join(job_dir, "results.jsonl")
        self.state = "queued"
        self.error: str | None = None
        self.resumed = False
        self.cancel_requested = False
        self.runner: StripeRunner | None = None
        self.summary: dict | None = None
        # progress, updated by the runner's on_progress callback on
        # the job thread and read by status() on ops threads — plain
        # dict swaps under the executor lock
        self.stripes_done = 0
        self.shard_bytes: list[int] = []
        self.first_progress = False
        self.stripe_stats: dict[int, dict] = {}
        self.enqueued_at = time.perf_counter()

    def write_manifest(self) -> None:
        os.makedirs(self.job_dir, exist_ok=True)
        tmp = f"{self.manifest_path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("\n".join(self.spec["manifest"]) + "\n")
        os.replace(tmp, self.manifest_path)

    def status_row(self) -> dict:
        files_done = sum(
            int(s.get("total", 0)) for s in self.stripe_stats.values()
        )
        row = {
            "job_id": self.job_id,
            "state": self.state,
            "stripes": self.spec["stripes"],
            "stripes_done": self.stripes_done,
            "entries": len(self.spec["manifest"]),
            "first_progress": self.first_progress,
            "files_classified": files_done,
            "shard_bytes": sum(self.shard_bytes),
            "resumed": self.resumed,
        }
        if self.trace_id:
            row["trace"] = self.trace_id
        if self.error is not None:
            row["error"] = self.error
        if self.summary is not None:
            row["rows_written"] = self.summary.get("rows_written")
            row["elapsed_s"] = self.summary.get("elapsed_s")
        return row


class JobExecutor:
    """Bounded job-runner pool + durable journal over one jobs dir.

    ``runner_factory(job, on_progress)`` overrides StripeRunner
    construction so tests drive the full submit/journal/resume
    machinery over stub runners; production leaves it None.
    ``device`` is forwarded as ``--device`` to every stripe child."""

    def __init__(
        self,
        jobs_dir: str,
        *,
        max_concurrent: int = 1,
        registry: MetricsRegistry | None = None,
        base_env: dict | None = None,
        runner_factory=None,
        on_event=None,
        trace_capacity: int = 256,
        device: str = "cuda",
    ):
        if max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be >= 1, got {max_concurrent!r}"
            )
        self.jobs_dir = jobs_dir
        self.journal = JobJournal(os.path.join(jobs_dir, "journal.jsonl"))
        # the jobs tier's black box: every submit/resume/cancel/merge
        # transition lands in the ring, spilled to jobs_dir/flight.json
        # — after a SIGKILL the harvest tells the story the journal's
        # terse state rows cannot
        self.flight = FlightRecorder(
            os.path.join(jobs_dir, "flight.json"), proc="jobs"
        )
        self.max_concurrent = int(max_concurrent)
        self.base_env = base_env
        self.device = device
        self.runner_factory = runner_factory
        self._on_event = on_event
        # every job trace is retained: jobs are few and coarse, and
        # the fleet collector joins their spans into the edge's trees
        self.tracer = Tracer(
            sample_rate=1.0, slow_ms=0.0, capacity=trace_capacity,
            proc="jobs",
        )
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._jobs: dict[str, Job] = {}
        self._by_key: dict[str, str] = {}
        self._queue: list[str] = []
        self._threads: list[threading.Thread] = []
        self._closing = False
        self._started = False
        self._seq = 0
        self.resumed_jobs = 0
        self._register_metrics(registry)

    # -- metrics --

    def _register_metrics(self, registry: MetricsRegistry | None) -> None:
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        self._submitted = reg.counter(
            "jobs_submitted_total", "Jobs accepted at the edge"
        )
        self._completed = reg.counter(
            "jobs_completed_total", "Jobs that reached completed"
        )
        self._failed = reg.counter(
            "jobs_failed_total", "Jobs that reached failed"
        )
        self._cancelled = reg.counter(
            "jobs_cancelled_total", "Jobs that reached cancelled"
        )
        self._resumed = reg.counter(
            "jobs_resumed_total",
            "In-flight jobs re-enqueued by journal replay after a restart",
        )
        reg.gauge(
            "jobs_queue_depth", "Jobs queued behind the runner pool"
        ).set_fn(lambda: len(self._queue))
        reg.gauge(
            "jobs_running", "Jobs currently draining through stripes"
        ).set_fn(self._running_count)

    def _running_count(self) -> int:
        with self._lock:
            return sum(
                1 for j in self._jobs.values() if j.state == "running"
            )

    def _event(self, message: str) -> None:
        if self._on_event is not None:
            self._on_event(message)

    # -- identity --

    def _mint_job_id(self) -> str:
        with self._lock:
            self._seq += 1
        return os.urandom(6).hex()

    def job_dir_for(self, job_id: str) -> str:
        return os.path.join(self.jobs_dir, job_id)

    def save_upload(self, name: str, data: bytes) -> str:
        """Stage an uploaded archive under the jobs dir, content-
        addressed: an idempotent resubmit of the same bytes lands on
        the same path and writes nothing.  Returns the saved path (the
        manifest references it through the ingest ``::*`` grammar)."""
        import hashlib

        digest = hashlib.sha256(data).hexdigest()[:16]
        safe = os.path.basename(name.strip()) or "archive"
        updir = os.path.join(self.jobs_dir, "uploads")
        os.makedirs(updir, exist_ok=True)
        path = os.path.join(updir, f"{digest}-{safe}")
        if not os.path.exists(path):
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        return path

    # -- lifecycle --

    def start(self) -> None:
        """Replay the journal, re-enqueue every non-terminal job, and
        start the runner pool.  Idempotent."""
        records = self.journal.replay()
        with self._lock:
            if self._started:
                return
            self._started = True
            for rec in records:
                kind = rec.get("rec")
                if kind == "submit":
                    spec = rec.get("spec")
                    job_id = rec.get("job")
                    if not (
                        isinstance(spec, dict)
                        and isinstance(job_id, str)
                    ):
                        continue
                    job = Job(
                        job_id, spec, self.job_dir_for(job_id),
                        trace_id=rec.get("trace"),
                    )
                    self._jobs[job_id] = job
                    key = spec.get("idempotency_key")
                    if key:
                        self._by_key[key] = job_id
                elif kind == "state":
                    job = self._jobs.get(rec.get("job"))
                    if job is not None and rec.get("state") in JOB_STATES:
                        job.state = rec["state"]
                        job.error = rec.get("error")
            for job_id, job in self._jobs.items():
                if job.state in TERMINAL_STATES:
                    continue
                # an interrupted "running" job resumes from its stripe
                # shards; a "queued" one simply runs for the first time
                if job.state == "running":
                    job.resumed = True
                    self.resumed_jobs += 1
                    self._resumed.inc()
                job.state = "queued"
                job.enqueued_at = time.perf_counter()
                self._queue.append(job_id)
            n_resumed = self.resumed_jobs
            n_queued = len(self._queue)
            for job_id in self._queue:
                if self._jobs[job_id].resumed:
                    self.flight.record("job_resume", job=job_id)
        self.flight.start()
        if n_queued:
            self._event(
                f"journal replay: {n_queued} job(s) re-enqueued "
                f"({n_resumed} resumed mid-run)"
            )
        for i in range(self.max_concurrent):
            t = threading.Thread(
                target=self._worker, name=f"job-runner-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def close(self, wait: bool = True, timeout_s: float = 30.0) -> None:
        """Stop accepting work and stop the pool.  Running jobs get a
        ``request_stop()`` (their shards stay resume-safe); a later
        ``start()`` on the same dir resumes them."""
        with self._lock:
            self._closing = True
            runners = [
                j.runner for j in self._jobs.values()
                if j.state == "running" and j.runner is not None
            ]
            self._wake.notify_all()
        for runner in runners:
            runner.request_stop()
        if wait:
            deadline = time.perf_counter() + timeout_s
            for t in self._threads:
                t.join(timeout=max(0.1, deadline - time.perf_counter()))
        self.journal.close()
        self.flight.stop()

    # -- the client surface (ops threads) --

    def submit(self, spec: dict, trace_id: str | None = None) -> tuple[Job, bool]:
        """Accept one normalized spec (see :func:`validate_spec`).
        Returns ``(job, created)`` — a duplicate idempotency key
        returns the ORIGINAL job with ``created=False`` and appends
        nothing."""
        key = spec.get("idempotency_key")
        with self._lock:
            if self._closing:
                raise RuntimeError("executor is closing")
            if key:
                existing = self._by_key.get(key)
                if existing is not None:
                    return self._jobs[existing], False
        job_id = self._mint_job_id()
        job = Job(job_id, spec, self.job_dir_for(job_id), trace_id=trace_id)
        job.write_manifest()
        record = {"rec": "submit", "job": job_id, "spec": spec}
        if trace_id:
            record["trace"] = trace_id
        with self._lock:
            if key:
                # re-check under the lock: two racing submits with the
                # same key must converge on one job
                existing = self._by_key.get(key)
                if existing is not None:
                    return self._jobs[existing], False
                self._by_key[key] = job_id
            self._jobs[job_id] = job
        self.journal.append(record)
        self._submitted.inc()
        self.flight.record(
            "job_submit", job=job_id, entries=len(spec["manifest"])
        )
        with self._lock:
            self._queue.append(job_id)
            self._wake.notify()
        self._event(f"job {job_id}: accepted ({len(spec['manifest'])} entries)")
        return job, True

    def cancel(self, job_id: str) -> dict | None:
        """Request cancellation; returns the status row or None when
        the id is unknown.  A queued job cancels immediately; a
        running one drains via ``request_stop()`` and lands in
        "cancelled" with resume-safe shards."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            job.cancel_requested = True
            runner = job.runner
            was_queued = job.state == "queued"
            if was_queued:
                try:
                    self._queue.remove(job_id)
                except ValueError:
                    pass
                job.state = "cancelled"
        self.flight.record(
            "job_cancel", job=job_id, queued=was_queued
        )
        if was_queued:
            self._append_state(job, "cancelled")
            self._cancelled.inc()
        elif runner is not None:
            runner.request_stop()
        return self.status(job_id)

    def status(self, job_id: str) -> dict | None:
        with self._lock:
            job = self._jobs.get(job_id)
            return job.status_row() if job is not None else None

    def results_path(self, job_id: str) -> str | None:
        """The merged output path, only once the job completed."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.state != "completed":
                return None
            return job.output_path

    def job(self, job_id: str) -> Job | None:
        with self._lock:
            return self._jobs.get(job_id)

    def trace_tail(self, n: int = 200) -> list[dict]:
        return self.tracer.tail(n)

    # -- the runner pool --

    def _worker(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closing:
                    self._wake.wait(timeout=0.5)
                if self._closing:
                    return
                job_id = self._queue.pop(0)
                job = self._jobs[job_id]
                if job.state == "cancelled":
                    continue
                job.state = "running"
            self._run_job(job)

    def _append_state(self, job: Job, state: str,
                      error: str | None = None) -> None:
        record: dict = {"rec": "state", "job": job.job_id, "state": state}
        if error is not None:
            record["error"] = error[:2000]
        self.journal.append(record)

    def _build_runner(self, job: Job, on_progress) -> StripeRunner:
        spec = job.spec
        forward = forward_args_for(spec["options"]) + (
            "--device", self.device,
        )
        stripes = spec["stripes"]
        elastic = None
        if stripes == "elastic":
            from licensee_tpu_torch.parallel.autoscale import AutoscaleConfig

            opts = spec["options"]
            elastic = AutoscaleConfig(
                min_units=opts.get("autoscale_min", 1),
                max_units=opts.get("autoscale_max", 8),
                cooldown_s=opts.get("autoscale_cooldown_s", 30.0),
            )
            stripes = elastic.min_units
        return StripeRunner(
            job.manifest_path,
            job.output_path,
            stripes,
            forward_args=forward,
            resume=True,
            auto_clamp=True,
            base_env=self.base_env,
            progress_every=0.25,
            on_progress=on_progress,
            elastic=elastic,
        )

    def _run_job(self, job: Job) -> None:
        self._append_state(job, "running")
        trace = self.tracer.start(job.job_id, trace_id=job.trace_id)
        t_run0 = time.perf_counter()
        with self._lock:
            enqueued_at = job.enqueued_at
        trace.add_span(
            "job.queue_wait", t_run0 - enqueued_at, t0=enqueued_at
        )
        stripe_t0: dict[int, float] = {}
        last_done_t = [t_run0]

        def on_progress(kind: str, info: dict) -> None:
            now = time.perf_counter()
            if kind == "spawn":
                stripe_t0.setdefault(info["stripe"], now)
                with self._lock:
                    job.first_progress = True
            elif kind == "stripe_done":
                index = info["stripe"]
                t0 = stripe_t0.get(index, t_run0)
                trace.add_span(f"stripe{index}", now - t0, t0=t0)
                last_done_t[0] = now
                stats = self._read_stripe_stats(job, index)
                with self._lock:
                    job.stripes_done += 1
                    if stats is not None:
                        job.stripe_stats[index] = stats
            elif kind == "progress":
                with self._lock:
                    job.first_progress = True
                    job.shard_bytes = list(info.get("shard_bytes", ()))

        try:
            factory = self.runner_factory or self._build_runner
            runner = factory(job, on_progress)
            with self._lock:
                job.runner = runner
                if job.cancel_requested:
                    runner.request_stop()
            summary = runner.run()
        except StripeStopped as exc:
            with self._lock:
                was_cancel = job.cancel_requested
            if was_cancel:
                self._finish(job, trace, "cancelled", str(exc))
                self._cancelled.inc()
            else:
                # the executor itself is draining (close()): leave the
                # job non-terminal so the next start() resumes it
                self._append_state(job, "queued")
                with self._lock:
                    job.state = "queued"
                    job.runner = None
                self.tracer.finish(trace, "stopped")
            return
        except (StripeError, ValueError, OSError) as exc:
            self._finish(job, trace, "failed", str(exc))
            self._failed.inc()
            return
        t_end = time.perf_counter()
        trace.add_span(
            "job.merge", t_end - last_done_t[0], t0=last_done_t[0]
        )
        self.flight.record(
            "job_merge", job=job.job_id,
            rows=summary.get("rows_written"),
            merge_ms=round((t_end - last_done_t[0]) * 1000.0, 3),
        )
        with self._lock:
            job.summary = {
                k: summary.get(k)
                for k in ("rows_written", "elapsed_s", "stripes",
                          "files_per_sec", "already_complete")
            }
            # the runner may have clamped the stripe count to the
            # manifest length: done == what actually ran
            job.stripes_done = summary.get("stripes", job.spec["stripes"])
        self._finish(job, trace, "completed")
        self._completed.inc()
        self._event(
            f"job {job.job_id}: completed "
            f"({summary.get('rows_written')} rows)"
        )

    def _read_stripe_stats(self, job: Job, index: int) -> dict | None:
        """The per-stripe ``--stats-file`` artifact, once that stripe's
        child exited clean — the progress the status verb reports."""
        stripes = job.spec["stripes"]
        if not isinstance(stripes, int):
            # elastic: the shard layout is whatever the runner is
            # currently at (an autoscale rescale renames the shards)
            runner = job.runner
            if runner is None:
                return None
            stripes = runner.stripes
        shard = shard_output_path(job.output_path, index, stripes)
        try:
            with open(f"{shard}.stats.json", encoding="utf-8") as f:
                row = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        return row if isinstance(row, dict) else None

    def _finish(self, job: Job, trace, state: str,
                error: str | None = None) -> None:
        self._append_state(job, state, error)
        with self._lock:
            job.state = state
            job.error = error
            job.runner = None
        self.flight.record("job_finish", job=job.job_id, state=state)
        self.tracer.finish(
            trace, "ok" if state == "completed" else state
        )
