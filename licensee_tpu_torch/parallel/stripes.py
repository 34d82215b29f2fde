"""One-command striped scale-out for the offline batch path.

The port's counterpart of `licensee_tpu/parallel/stripes.py`.  One
process's pipeline is bounded by its serial section (its interpreter,
its writer, its reads) whatever the core count, so the batch path
scales past one process by striping the manifest over several::

    python -m licensee_tpu_torch.cli.main batch-detect manifest.txt \\
        --output out.jsonl --stripes 4

The runner spawns N co-located worker processes on this host, each
classifying a contiguous stripe of the manifest (the same
``manifest_stripe`` math the multi-host path uses, so a stripe IS a
rank) and writing its own resume-safe JSONL shard.  Container
manifests ('::' forms) stripe by their EXPANDED blob count — a single
million-member tarball splits across stripes, each worker expanding
the same manifest metadata-only and reading just its span — and the
container-verdict sidecar is derived once from the MERGED output
(exactly one row per container, even when its blobs spanned stripes).  No
``torch.distributed`` bootstrap is involved: the scoring has no
cross-blob collectives, so co-located stripes need no coordinator — the
stripe index/count ride the child's argv and device subsets ride the
``LICENSEE_TPU_VISIBLE_CHIPS`` dict-env contract (``chips_for_worker``
+ ``apply_visible_chips`` over the CHILD's env dict — this process's
environment is never touched, and it never opens a CUDA context).  A
child inherits the runner's ``--device``; a child that cannot open the
card exits non-zero, and the runner counts and reports it — it never
reruns the stripe on the CPU.

Supervision uses the helpers of fleet/supervisor.py: crash restart with capped exponential backoff
(``BackoffPolicy``) — a restarted stripe RESUMES from its own shard's
``_resume_point``, never re-scoring rows another stripe owns — a
progress probe that SIGKILLs a wedged worker (alive but its shard has
not grown past the stall timeout), and a graceful SIGTERM drain
(``request_stop()`` forwards SIGTERM and waits; a mid-write kill leaves
at most one torn line, which the per-shard resume truncates).

When every stripe exits clean the runner deterministically merges:

* **rows** — shards concatenate in stripe order into ``<output>``
  (atomic ``os.replace``), after verifying each shard's newline-
  terminated row count equals its stripe span, so the merged file is
  bit-identical to a single-process run over the same manifest;
* **stats** — per-stripe ``BatchStats`` JSON sums into one dict
  (``merge_stats``);
* **metrics** — per-stripe Prometheus expositions merge into
  ``<output>.prom`` via the fleet's ``merge_expositions`` with a
  ``stripe`` label.

House rules: monotonic clocks only, and nothing is ever
printed from this module — progress surfaces through the ``on_event``
callback (the CLI points it at stderr), so the runner can never corrupt
a pipeline that shares its stdout.

The runner is a LIBRARY first and a CLI second: ``run()`` raises
(``StripeError`` / ``StripeStopped``) instead of exiting, touches no
terminal, and reports machine-readable lifecycle through the optional
``on_progress(kind, info)`` callback (``spawn`` / ``stripe_done`` /
``restart`` / ``progress`` / ``merged``) so an embedding parent — the
jobs executor (licensee_tpu/jobs) is the first — can mirror stripe
lifecycle into its own telemetry without parsing the human strings
``on_event`` carries.  ``request_stop()`` stays signal-handler safe,
and a stop surfaces as ``StripeStopped`` so parents can tell an
operator cancel from a permanent failure.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

from licensee_tpu_torch.fleet.supervisor import (
    BackoffPolicy,
    terminate_process,
    worker_env,
)
from licensee_tpu_torch.parallel.distributed import (
    chips_for_worker,
    count_manifest_entries,
    manifest_stripe,
    shard_output_path,
)

__all__ = [
    "StripeError",
    "StripeRunner",
    "StripeStopped",
    "auto_stripe_count",
    "count_manifest_entries",
    "merge_stats",
    "parse_stripes_arg",
    "selftest",
    "selftest_autoscale",
    "stripe_argv",
]

# the fewest cores a stripe needs to overlap its produce workers with
# its serial loop: one core feeding the workers, one for the dispatch,
# finish and writer loop
CORES_PER_STRIPE_MIN = 2
AUTO_STRIPE_CAP = 16


class StripeError(RuntimeError):
    """A stripe failed permanently (restart budget exhausted), a shard
    failed verification at merge time, or the runner was stopped."""


class StripeStopped(StripeError):
    """The runner drained because ``request_stop()`` was called — not a
    failure: the shards are resume-safe and a rerun continues.  A
    subclass so existing ``except StripeError`` callers keep working
    while an embedding parent can tell a cancel from a crash."""


def auto_stripe_count(cores: int | None = None) -> int:
    """``--stripes auto``: how many stripes this host should run.

    Every stripe needs ``CORES_PER_STRIPE_MIN`` cores, so the host
    supports ``cores // 2`` stripes, capped at ``AUTO_STRIPE_CAP``.  The
    JAX package also floors this at its TPU bench's
    ``striped_processes_needed_10M_60s``; with that model's value (3)
    the floor never changes the answer (``min(3, cores // 2)`` never
    exceeds the core rule), so the port, which reads no such file,
    keeps the core rule alone."""
    if cores is None:
        cores = os.cpu_count() or 1
    by_cores = max(1, cores // CORES_PER_STRIPE_MIN)
    return min(by_cores, AUTO_STRIPE_CAP)


def parse_stripes_arg(value: str) -> int | str:
    """CLI ``--stripes`` value: a positive int, ``auto`` (sized once
    from the host's cores), or ``elastic`` (start small
    and let the runner's autoscaler grow/shrink against the measured
    per-stripe lane gauges — returned as the literal string)."""
    if value == "auto":
        return auto_stripe_count()
    if value == "elastic":
        return "elastic"
    try:
        n = int(value)
    except ValueError:
        raise ValueError(
            f"--stripes wants a positive integer, 'auto' or 'elastic', "
            f"got {value!r}"
        ) from None
    if n < 1:
        raise ValueError(f"--stripes must be >= 1, got {n}")
    return n


def stripe_argv(
    manifest: str,
    output: str,
    index: int,
    count: int,
    forward: tuple[str, ...] = (),
    *,
    resume: bool = True,
) -> list[str]:
    """The child command for one stripe: the batch-detect CLI with the
    internal stripe rank args plus the per-stripe stats/metrics dump
    paths the merge reads.  ``resume=False`` (first spawn of a
    ``--no-resume`` run) restarts the shard from scratch; RESTARTS
    always resume — that is the whole point of the per-shard
    ``_resume_point``."""
    shard = shard_output_path(output, index, count)
    argv = [
        sys.executable, "-m", "licensee_tpu_torch.cli.main", "batch-detect",
        manifest,
        "--output", output,
        "--stripe-index", str(index),
        "--stripe-count", str(count),
        "--stats-file", f"{shard}.stats.json",
        "--prom-file", f"{shard}.prom",
    ]
    if not resume:
        argv.append("--no-resume")
    argv.extend(forward)
    return argv


def merge_stats(stats_list: list[dict]) -> dict:
    """Sum per-stripe ``BatchStats.as_dict()`` rows into one fleet-level
    dict: integer counters add, ``routed`` adds per route, and
    ``stage_seconds`` adds per stage (they are already thread-seconds,
    so cross-process addition keeps the same unit; ``elapsed`` becomes
    the sum of per-stripe elapsed — the runner reports wall clock
    separately).

    Resume semantics, same as a single-process resumed run: each
    stripe's stats count the rows ITS FINAL INCARNATION classified, so
    after a crash-restart the merged ``total`` is less than
    ``rows_written`` (the rows the dead incarnation already wrote are
    on disk, not re-scored).  ``rows_written`` in the runner summary is
    the completeness guarantee; the stats are the work accounting."""
    merged: dict = {}
    routed: dict = {}
    stages: dict = {}
    for stats in stats_list:
        for key, value in stats.items():
            if key == "routed":
                for route, n in value.items():
                    routed[route] = routed.get(route, 0) + n
            elif key == "stage_seconds":
                for stage, s in value.items():
                    stages[stage] = round(stages.get(stage, 0.0) + s, 4)
            elif isinstance(value, (int, float)):
                merged[key] = merged.get(key, 0) + value
    if routed:
        merged["routed"] = routed
    merged["stage_seconds"] = stages
    return merged


def _forwarded_int(forward: tuple[str, ...], flag: str) -> int | None:
    """The int value a forward-args tuple carries for ``flag``, or
    None (absent or malformed — the child argv parser owns erroring)."""
    for i, arg in enumerate(forward):
        if arg == flag and i + 1 < len(forward):
            try:
                return int(forward[i + 1])
            except ValueError:
                return None
    return None


class _StripeHandle:
    """One supervised stripe worker: its argv/env, live process, and
    restart/progress bookkeeping (the offline twin of the fleet's
    WorkerHandle)."""

    def __init__(self, index: int, shard: str, argv_first, argv_resume, env):
        self.index = index
        self.shard = shard
        self.argv_first = list(argv_first)
        self.argv_resume = list(argv_resume)
        self.env = dict(env)
        self.proc: subprocess.Popen | None = None
        self.log: str = f"{shard}.log"
        self.done = False
        # restarts is the BACKOFF-WINDOW counter (reset after sustained
        # progress, like the fleet supervisor's stable_after_s earn-
        # back); total_restarts is the lifetime count status reports
        self.restarts = 0
        self.total_restarts = 0
        self.spawned_at: float | None = None
        self.next_spawn_at = 0.0
        self.exit_codes: list[int] = []
        # progress probe state: (last observed shard size, when it last
        # changed) — a live process whose shard stops growing is wedged
        self.last_size = -1
        self.last_growth_t: float | None = None
        # deterministic-failure detector: consecutive nonzero exits
        # whose incarnation never CHANGED the shard at all (a config
        # error, a broken argv — those die before touching the file) —
        # burning the whole restart-backoff budget on those only delays
        # the real error message.  "Changed", not "grew": a --no-resume
        # child legitimately truncates a stale shard below its old size
        # and must still count as progress.
        self.size_at_spawn = -1
        self.changed_since_spawn = False
        self.no_growth_failures = 0

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def as_dict(self) -> dict:
        return {
            "shard": self.shard,
            "pid": self.pid,
            "done": self.done,
            "restarts": self.total_restarts,
            "exit_codes": self.exit_codes[-5:],
        }


class StripeRunner:
    """Spawn + supervise + merge N manifest-striped batch workers.

    ``argv_for(index, count, resume)`` / ``env_for(index, chips)``
    override the child command/environment so tests and the fault
    harness can drive the exact production restart/merge machinery over
    stub workers (the fleet Supervisor's ``argv_for`` pattern)."""

    def __init__(
        self,
        manifest: str,
        output: str,
        stripes: int,
        *,
        forward_args: tuple[str, ...] = (),
        resume: bool = True,
        auto_clamp: bool = False,
        chips_per_stripe: int | None = None,
        argv_for=None,
        env_for=None,
        base_env: dict | None = None,
        max_restarts: int = 5,
        backoff: BackoffPolicy | None = None,
        stall_timeout_s: float = 600.0,
        startup_grace_s: float = 180.0,
        poll_interval_s: float = 0.25,
        sigterm_timeout_s: float = 10.0,
        progress_every: float = 0,
        on_event=None,
        on_progress=None,
        container_layout: dict | None = None,
        elastic=None,
        elastic_interval_s: float = 2.0,
        elastic_stale_after_s: float = 10.0,
    ):
        if stripes < 1:
            raise ValueError(f"stripes must be >= 1, got {stripes!r}")
        if chips_per_stripe is not None and chips_per_stripe < 1:
            raise ValueError(
                f"chips_per_stripe must be >= 1, got {chips_per_stripe!r}"
            )
        if max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {max_restarts!r}"
            )
        self.manifest = manifest
        self.output = output
        self.n_entries = count_manifest_entries(manifest)
        # container manifests ('::' forms): the striping denominator
        # moves to the EXPANDED blob count — a single million-member
        # tarball splits across stripes (each worker expands the same
        # manifest metadata-only and keeps its span; the span math
        # agrees with this layout by construction) — and the merged
        # output's container-verdict sidecar is derived HERE after the
        # merge (exactly one row per container, even when its blobs
        # spanned stripes), so workers write per-blob shards only.
        self.container_layout = None
        from licensee_tpu_torch.ingest.sources import is_container_entry

        # streamed probe first: a 50M-line LOOSE manifest must never
        # materialize in the supervisor
        with open(manifest, encoding="utf-8") as f:
            has_containers = any(
                is_container_entry(line.strip()) for line in f
            )
        if has_containers:
            if container_layout is None:
                from licensee_tpu_torch.ingest.sources import expanded_layout

                with open(manifest, encoding="utf-8") as f:
                    entries = [
                        line.strip() for line in f if line.strip()
                    ]
                # metadata-only counting pass; every handle closed
                # before returning (workers open their own)
                container_layout = expanded_layout(entries)
            # else: the caller already paid the expansion (the CLI's
            # resume preflight probe) — don't rescan the archives
            self.container_layout = container_layout
            self.n_entries = self.container_layout["total"]
        if stripes > max(1, self.n_entries):
            if auto_clamp:
                # `--stripes auto` sized from the HOST; a small manifest
                # simply can't use that many — clamp, don't lecture the
                # operator about a number they never chose
                stripes = max(1, self.n_entries)
            else:
                raise ValueError(
                    f"more stripes ({stripes}) than manifest entries "
                    f"({self.n_entries}); an empty stripe would write "
                    "an empty shard forever — lower --stripes"
                )
        self.stripes = int(stripes)
        self.resume = bool(resume)
        self.max_restarts = int(max_restarts)
        self.backoff = backoff or BackoffPolicy(base_s=0.5, max_s=30.0)
        self.stall_timeout_s = float(stall_timeout_s)
        self.startup_grace_s = float(startup_grace_s)
        self.poll_interval_s = float(poll_interval_s)
        self.sigterm_timeout_s = float(sigterm_timeout_s)
        # CLI --progress: emit a shard-growth event at most every SECS
        # (per-stripe shard BYTES — cheap stat()s, no row counting on
        # the supervision path); 0 disables
        self.progress_every = float(progress_every or 0)
        if not (self.progress_every >= 0):  # rejects negatives AND NaN
            raise ValueError(
                f"progress_every must be >= 0, got {progress_every!r}"
            )
        self._on_event = on_event
        self._on_progress = on_progress
        self._stop_requested = False
        # spawn ingredients, kept so an elastic rescale can rebuild the
        # handle set at a different stripe count / featurize-procs
        self._forward_args = tuple(forward_args)
        self._argv_for = argv_for
        self._env_for = env_for
        self._base_env = base_env
        self._chips_per_stripe = chips_per_stripe
        # --stripes elastic (parallel/autoscale.py): ``elastic`` is an
        # AutoscaleConfig; the runner scrapes each live stripe's
        # --prom-file heartbeat for pipeline_featurize_busy, feeds the
        # decider, and a proposal becomes a DRAIN + RESPAWN at the new
        # plan (each worker exits resume-safe; shard names embed the
        # stripe count, so a revisit of an earlier count resumes its
        # own shards and the final merge's cleanup sweeps the rest)
        self.elastic = elastic
        self._scale_events = 0
        self._decider = None
        self._scraper = None
        self._featurize_procs = _forwarded_int(
            self._forward_args, "--featurize-procs"
        )
        if elastic is not None:
            from licensee_tpu_torch.parallel.autoscale import (
                AutoscaleDecider,
                ExpositionScraper,
            )

            if elastic_interval_s <= 0:
                raise ValueError(
                    "elastic_interval_s must be > 0, got "
                    f"{elastic_interval_s!r}"
                )
            self.elastic_interval_s = float(elastic_interval_s)
            # stripes beyond this become per-stripe featurize procs
            # (capacity_plan): a stripe needs CORES_PER_STRIPE_MIN
            # cores to be worth its serial section
            self._elastic_max_stripes = max(1, min(
                elastic.max_units, AUTO_STRIPE_CAP, self.n_entries
            ))
            self._decider = AutoscaleDecider(
                elastic, elastic.clamp(self.stripes)
            )
            self.stripes = min(self._decider.units,
                               self._elastic_max_stripes)
            self._scraper = ExpositionScraper(
                stale_after_s=elastic_stale_after_s
            )
            self._last_autoscale_t: float | None = None
            self._tp_last: tuple[float, int] | None = None
        self._initial_stripes = self.stripes
        self.handles: list[_StripeHandle] = self._build_handles(
            self.stripes, self._featurize_procs
        )
        # shard paths THIS RUN has already started: a --no-resume
        # elastic rescale clears a count's stale shards only on the
        # first visit (revisits resume this run's own work)
        self._counts_started = {h.shard for h in self.handles}

    def _forward_with_procs(self, procs: int | None) -> tuple[str, ...]:
        """The forward args with ``--featurize-procs`` swapped to
        ``procs`` (dropped when falsy) — the elastic rescale's second
        lever rides the respawn argv."""
        out: list[str] = []
        skip = False
        for arg in self._forward_args:
            if skip:
                skip = False
                continue
            if arg == "--featurize-procs":
                skip = True
                continue
            out.append(arg)
        if procs:
            out += ["--featurize-procs", str(procs)]
        return tuple(out)

    def _build_handles(
        self, stripes: int, featurize_procs: int | None = None
    ) -> list:
        forward = (
            self._forward_with_procs(featurize_procs)
            if self.elastic is not None
            else self._forward_args
        )
        handles = []
        for i in range(stripes):
            shard = shard_output_path(self.output, i, stripes)
            chips = (
                chips_for_worker(i, self._chips_per_stripe)
                if self._chips_per_stripe is not None
                else None
            )
            env = (
                self._env_for(i, chips)
                if self._env_for is not None
                else worker_env(self._base_env, chips)
            )
            if self._argv_for is not None:
                argv_first = self._argv_for(i, stripes, resume=self.resume)
                argv_resume = self._argv_for(i, stripes, resume=True)
            else:
                argv_first = stripe_argv(
                    self.manifest, self.output, i, stripes, forward,
                    resume=self.resume,
                )
                argv_resume = stripe_argv(
                    self.manifest, self.output, i, stripes, forward,
                    resume=True,
                )
            handles.append(
                _StripeHandle(i, shard, argv_first, argv_resume, env)
            )
        return handles

    # -- events --

    def _event(self, message: str) -> None:
        if self._on_event is not None:
            self._on_event(message)

    def _notify(self, kind: str, **info) -> None:
        """Machine-readable lifecycle for embedding parents: ``kind``
        is one of ``spawn`` / ``stripe_done`` / ``restart`` /
        ``progress`` / ``merged``; ``info`` carries the stripe index
        and whatever the event measured.  Runs on the supervising
        thread — a callback that blocks stalls the poll loop, so
        parents should only snapshot state here."""
        if self._on_progress is not None:
            self._on_progress(kind, info)

    # -- lifecycle primitives --

    def _spawn(self, handle: _StripeHandle, *, first: bool) -> None:
        argv = handle.argv_first if first else handle.argv_resume
        try:
            # an earlier incarnation's heartbeat (a revisited stripe
            # count, a crashed child) must never read as this child's
            # pressure before it has written its own
            os.remove(f"{handle.shard}.prom")
        except OSError:
            pass
        log = open(handle.log, "ab")
        try:
            handle.proc = subprocess.Popen(
                argv,
                env=handle.env,
                stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL,
                stderr=log,
            )
        finally:
            log.close()  # the child holds its own descriptor
        now = time.perf_counter()
        handle.spawned_at = now
        handle.last_growth_t = now
        handle.last_size = self._shard_size(handle)
        handle.size_at_spawn = handle.last_size
        handle.changed_since_spawn = False

    def _shard_size(self, handle: _StripeHandle) -> int:
        try:
            return os.path.getsize(handle.shard)
        except OSError:
            return -1

    def _schedule_restart(self, handle: _StripeHandle, why: str) -> None:
        delay = self.backoff.delay_s(handle.restarts)
        handle.restarts += 1
        handle.total_restarts += 1
        handle.next_spawn_at = time.perf_counter() + delay
        handle.proc = None
        self._event(
            f"stripe {handle.index}: {why}; restart "
            f"{handle.restarts}/{self.max_restarts} in {delay:.2f}s "
            "(resuming from its shard's completed prefix)"
        )
        self._notify(
            "restart", stripe=handle.index, why=why, delay_s=delay
        )

    def request_stop(self) -> None:
        """Ask the run loop to drain: forward SIGTERM to every live
        stripe, wait for exits, and return without merging.  Signal-
        handler safe (sets a flag only)."""
        self._stop_requested = True

    def _drain(self) -> None:
        for handle in self.handles:
            proc = handle.proc
            if proc is not None and proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.perf_counter() + self.sigterm_timeout_s
        for handle in self.handles:
            proc = handle.proc
            if proc is None:
                continue
            budget = deadline - time.perf_counter()
            try:
                proc.wait(timeout=max(0.05, budget))
            except subprocess.TimeoutExpired:
                pass
            terminate_process(proc, 0.5)

    def _abort(self, why: str) -> None:
        self._drain()
        raise StripeError(why)

    def _log_tail(self, handle: _StripeHandle, n: int = 800) -> str:
        try:
            with open(handle.log, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - n))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""

    # -- elastic autoscaling (--stripes elastic) --

    def _throughput(self, now: float) -> float | None:
        """Aggregate shard growth in bytes/s since the previous tick —
        the payoff signal the decider judges a grow step by.  Reset at
        every rescale (shard sets change; the first post-rescale tick
        re-baselines instead of comparing across shard generations)."""
        total = sum(max(0, self._shard_size(h)) for h in self.handles)
        last = self._tp_last
        self._tp_last = (now, total)
        if last is None or now - last[0] <= 0:
            return None
        return (total - last[1]) / (now - last[0])

    def _autoscale_tick(self, now: float) -> None:
        if (
            self._last_autoscale_t is not None
            and now - self._last_autoscale_t < self.elastic_interval_s
        ):
            return
        self._last_autoscale_t = now
        live = [
            h for h in self.handles if not h.done and h.proc is not None
        ]
        if not live:
            return
        pressures = []
        for handle in live:
            gauges = self._scraper.sample(
                handle.shard, f"{handle.shard}.prom", now
            )
            if gauges is None:
                continue  # stale/absent heartbeat: not a live signal
            busy = gauges.get("pipeline_featurize_busy")
            if busy is not None:
                pressures.append(busy)
        pressure = (
            sum(pressures) / len(pressures) if pressures else None
        )
        proposal = self._decider.observe(
            now, pressure, self._throughput(now)
        )
        if proposal is None:
            return
        from licensee_tpu_torch.parallel.autoscale import capacity_plan

        stripes, procs = capacity_plan(
            proposal, max_stripes=self._elastic_max_stripes,
            base_featurize_procs=self._featurize_procs or 0,
        )
        if stripes == self.stripes and (procs or None) == (
            self._current_procs()
        ):
            return
        self._rescale(stripes, procs or None, proposal)

    def _current_procs(self) -> int | None:
        return getattr(self, "_live_procs", self._featurize_procs)

    def _rescale(
        self, stripes: int, procs: int | None, units: int
    ) -> None:
        """One scale event: drain every worker (SIGTERM, resume-safe
        exit), rebuild the handle set at the new plan, respawn.  Shard
        names embed the stripe count, so workers at the new count never
        resume another count's rows; partial shards from the old count
        stay on disk — a later return to that count resumes them, and
        the final merge's cleanup glob sweeps whatever never merged."""
        self._event(
            f"autoscale: {self.stripes} -> {stripes} stripes"
            + (f" (+{procs} featurize-procs)" if procs else "")
            + f" [units {units}]; draining for resume-safe respawn"
        )
        self._notify(
            "rescale", from_stripes=self.stripes, to_stripes=stripes,
            featurize_procs=procs, units=units,
        )
        self._drain()
        for handle in self.handles:
            self._scraper.forget(handle.shard)
        self.stripes = int(stripes)
        self._live_procs = procs
        self._scale_events += 1
        self._tp_last = None
        self.handles = self._build_handles(stripes, procs)
        for handle in self.handles:
            if not self.resume:
                # a --no-resume run must not adopt a stale same-count
                # shard from an EARLIER run: the first visit to each
                # count starts it clean (revisits within this run
                # resume — that is this run's own work)
                if handle.shard not in self._counts_started:
                    try:
                        os.remove(handle.shard)
                    except OSError:
                        pass
            self._counts_started.add(handle.shard)
            if (
                self.resume
                and self._count_complete_rows(handle.shard)
                == self._stripe_span(handle.index, stripes)
            ):
                # this span finished on an earlier visit to this count:
                # nothing to respawn (a worker would exit 0 instantly,
                # but not spawning keeps the event log honest)
                handle.done = True
                continue
            try:
                self._spawn(handle, first=False)
            except OSError as exc:
                self._abort(
                    f"stripe {handle.index}: respawn after rescale "
                    f"failed: {exc}"
                )
            self._notify(
                "spawn", stripe=handle.index, pid=handle.pid,
                first=False,
            )

    def _stripe_span(self, index: int, stripes: int) -> int:
        lo, hi = manifest_stripe(self.n_entries, index, stripes)
        return hi - lo

    # -- the run loop --

    def run(self) -> dict:
        """Run every stripe to completion, then merge.  Returns the
        summary dict (rows written, merged stats, per-stripe detail).
        Raises StripeError on permanent failure or an operator stop."""
        t0 = time.perf_counter()
        if self.resume and self._already_complete():
            rows = self.n_entries
            self._event(
                f"{self.output}: already complete ({rows} rows); "
                "nothing to do"
            )
            # the merge persisted the run's stats/exposition beside the
            # output, so even a no-op rerun surfaces them (an operator's
            # --stats-file/--prom-file contract must not silently lapse)
            stats = None
            try:
                with open(
                    f"{self.output}.stats.json", encoding="utf-8"
                ) as f:
                    stats = json.load(f)
            except (OSError, json.JSONDecodeError):
                pass
            prom = f"{self.output}.prom"
            return {
                "stripes": self.stripes,
                "files": self.n_entries,
                "rows_written": rows,
                "already_complete": True,
                "elapsed_s": 0.0,
                "stats": stats,
                "prom": prom if os.path.exists(prom) else None,
                "per_stripe": [],
            }
        try:
            self._supervise(t0)
        except BaseException:
            # whatever the loop does not handle itself (an interrupt, a
            # caller's time limit) drains the live stripes on its way up:
            # no child outlives its runner
            self._drain()
            raise
        summary = self._merge()
        summary["elapsed_s"] = round(time.perf_counter() - t0, 3)
        files = summary["rows_written"]
        if summary["elapsed_s"] > 0:
            summary["files_per_sec"] = round(
                files / summary["elapsed_s"], 1
            )
        if self._decider is not None:
            summary["autoscale"] = {
                "initial_stripes": self._initial_stripes,
                "final_stripes": self.stripes,
                "featurize_procs": self._current_procs(),
                "units": self._decider.units,
                "scale_events": self._scale_events,
                "events": list(self._decider.events),
            }
        return summary

    def _supervise(self, t0: float) -> None:
        """Spawn every stripe and supervise it to completion: respawn
        with backoff, kill a wedged worker, autoscale."""
        for handle in self.handles:
            try:
                self._spawn(handle, first=True)
            except OSError as exc:
                # drain whatever already spawned: a supervisor that
                # dies mid-boot must not orphan half a fleet
                self._abort(
                    f"stripe {handle.index}: spawn failed: {exc}"
                )
            self._event(
                f"stripe {handle.index}/{self.stripes}: pid "
                f"{handle.pid} -> {os.path.basename(handle.shard)}"
            )
            self._notify(
                "spawn", stripe=handle.index, pid=handle.pid, first=True
            )
        t_progress = t0
        while not all(h.done for h in self.handles):
            if self._stop_requested:
                self._drain()
                raise StripeStopped(
                    "stopped by operator before completion; shards are "
                    "resume-safe — rerun the same command to continue"
                )
            now = time.perf_counter()
            for handle in self.handles:
                if handle.done:
                    continue
                proc = handle.proc
                if proc is None:
                    if now >= handle.next_spawn_at:
                        try:
                            self._spawn(handle, first=False)
                        except OSError as exc:
                            self._abort(
                                f"stripe {handle.index}: respawn "
                                f"failed: {exc}"
                            )
                        self._event(
                            f"stripe {handle.index}: respawned as pid "
                            f"{handle.pid}"
                        )
                        self._notify(
                            "spawn", stripe=handle.index,
                            pid=handle.pid, first=False,
                        )
                    continue
                rc = proc.poll()
                if rc is not None:
                    handle.exit_codes.append(rc)
                    if rc == 0:
                        handle.done = True
                        handle.proc = None
                        self._event(
                            f"stripe {handle.index}: complete"
                        )
                        self._notify("stripe_done", stripe=handle.index)
                        continue
                    changed = (
                        handle.changed_since_spawn
                        or self._shard_size(handle)
                        != handle.size_at_spawn
                    )
                    if changed:
                        handle.no_growth_failures = 0
                    elif rc >= 0:
                        # signal deaths (rc < 0: OOM kill, a stray
                        # SIGKILL) are environmental, not a config
                        # error — they use the backoff budget and never
                        # feed the deterministic-failure counter
                        handle.no_growth_failures += 1
                    if handle.no_growth_failures >= 2:
                        # two consecutive failures without a single row
                        # written: deterministic (bad corpus path, a
                        # resume-config mismatch, broken argv) — more
                        # backoff cycles only delay the real error
                        tail = self._log_tail(handle)
                        self._abort(
                            f"stripe {handle.index} is failing "
                            "deterministically (repeated exits with no "
                            f"shard progress, exit codes "
                            f"{handle.exit_codes[-5:]}); giving up. "
                            f"Last stderr:\n{tail}"
                        )
                    if handle.restarts >= self.max_restarts:
                        tail = self._log_tail(handle)
                        self._abort(
                            f"stripe {handle.index} failed "
                            f"{handle.restarts + 1} times (exit codes "
                            f"{handle.exit_codes[-5:]}); giving up. "
                            f"Last stderr:\n{tail}"
                        )
                    self._schedule_restart(handle, f"exit {rc}")
                    continue
                # progress probe: the offline twin of the fleet's stats
                # probe — a live worker whose shard has stopped growing
                # past the stall timeout is wedged (hung compile,
                # stopped process) and gets the SIGKILL + restart path
                size = self._shard_size(handle)
                if size != handle.last_size:
                    handle.last_size = size
                    handle.last_growth_t = now
                    handle.changed_since_spawn = True
                    if handle.restarts and (
                        now - (handle.spawned_at or now)
                        >= self.backoff.stable_after_s
                    ):
                        # sustained progress earns the backoff counter
                        # back (the fleet supervisor's stable_after_s
                        # rule): an isolated transient crash per hour
                        # must never exhaust a lifetime budget mid-run
                        handle.restarts = 0
                elif self.stall_timeout_s > 0 and (
                    now - (handle.spawned_at or now) > self.startup_grace_s
                ) and (
                    now - (handle.last_growth_t or now)
                    > self.stall_timeout_s
                ):
                    try:
                        proc.kill()
                        proc.wait(timeout=5.0)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
                    if proc.poll() is None:
                        # still not dead (e.g. wedged in uninterruptible
                        # sleep): do NOT respawn over a process that may
                        # wake and keep appending to the shard — retry
                        # the kill on the next poll instead
                        self._event(
                            f"stripe {handle.index}: wedged and "
                            "SIGKILL has not taken effect yet; "
                            "retrying before respawn"
                        )
                        continue
                    handle.exit_codes.append(proc.returncode)
                    if handle.restarts >= self.max_restarts:
                        self._abort(
                            f"stripe {handle.index} wedged (no shard "
                            f"growth for {self.stall_timeout_s:.0f}s) "
                            "and out of restarts"
                        )
                    self._schedule_restart(
                        handle,
                        f"wedged (no shard growth for "
                        f"{self.stall_timeout_s:.0f}s) — SIGKILLed",
                    )
            if (
                self.progress_every
                and now - t_progress >= self.progress_every
            ):
                t_progress = now
                shard_bytes = [
                    max(0, self._shard_size(h)) for h in self.handles
                ]
                done = sum(h.done for h in self.handles)
                sizes = " ".join(
                    f"{h.index}:{shard_bytes[h.index]}B"
                    + ("(done)" if h.done else "")
                    for h in self.handles
                )
                self._event(
                    f"progress: {done}/"
                    f"{self.stripes} stripes done; shards {sizes}"
                )
                self._notify(
                    "progress", done=done, stripes=self.stripes,
                    shard_bytes=shard_bytes,
                )
            if self._decider is not None:
                self._autoscale_tick(now)
            time.sleep(self.poll_interval_s)

    # -- completion + merge --

    def _count_complete_rows(self, path: str) -> int:
        """Newline-terminated line count (a torn tail does not count —
        the same definition as BatchProject._resume_point, without the
        truncation side effect)."""
        n = 0
        try:
            with open(path, "rb") as f:
                for line in f:
                    if line.endswith(b"\n"):
                        n += 1
        except OSError:
            return 0
        return n

    def _already_complete(self) -> bool:
        return (
            os.path.exists(self.output)
            and self._count_complete_rows(self.output) == self.n_entries
        )

    def _merge(self) -> dict:
        """Deterministic shard -> output merge: verify every shard's
        row count equals its stripe span, concatenate in stripe order
        (atomic replace), merge stats and Prometheus expositions, then
        remove the per-stripe files.  With one stripe the child already
        wrote ``output`` directly (shard_output_path keeps the plain
        path at count<=1) and only the bookkeeping merges."""
        per_stripe = {h.index: h.as_dict() for h in self.handles}
        total = 0
        for handle in self.handles:
            lo, hi = manifest_stripe(
                self.n_entries, handle.index, self.stripes
            )
            rows = self._count_complete_rows(handle.shard)
            if rows != hi - lo:
                raise StripeError(
                    f"shard {handle.shard} has {rows} complete rows, "
                    f"expected {hi - lo} (stripe [{lo}, {hi})); refusing "
                    "to merge a short shard"
                )
            total += rows
        if self.stripes > 1:
            tmp = f"{self.output}.merge.tmp"
            with open(tmp, "wb") as out:
                for handle in self.handles:
                    with open(handle.shard, "rb") as f:
                        while True:
                            block = f.read(1 << 20)
                            if not block:
                                break
                            out.write(block)
            os.replace(tmp, self.output)
            # the merged output is a complete single-file run: carry
            # shard 0's config sidecar so a later single-process resume
            # of this output file sees the config that produced it
            # (the expansion fingerprint inside it is span-independent,
            # so it matches what a single-process run would record)
            shard0_meta = f"{self.handles[0].shard}.meta.json"
            if os.path.exists(shard0_meta):
                os.replace(shard0_meta, f"{self.output}.meta.json")
        if self.container_layout is not None and (
            self.container_layout["spans"]
            or self.container_layout["subsets"]
        ):
            # the blob-level JOIN: striped workers wrote per-blob rows
            # only (a container may span shards), so the ONE container
            # sidecar derives here from the merged output over the
            # full-expansion groups — the license algebra re-runs over
            # each container's merged row set and every container
            # emits exactly one verdict row
            from licensee_tpu_torch.ingest.verdict import (
                write_container_verdicts,
            )

            write_container_verdicts(
                self.output,
                self.container_layout["spans"],
                self.container_layout["subsets"],
            )
        stats_rows = []
        expositions: dict[str, str] = {}
        for handle in self.handles:
            stats_path = f"{handle.shard}.stats.json"
            try:
                with open(stats_path, encoding="utf-8") as f:
                    row = json.load(f)
            except (OSError, json.JSONDecodeError):
                row = None
            if row is not None:
                stats_rows.append(row)
                # per-stripe detail rides the summary (the bench reads
                # each stripe's steady-state elapsed from here)
                per_stripe[handle.index]["stats"] = row
            prom_path = f"{handle.shard}.prom"
            try:
                with open(prom_path, encoding="utf-8") as f:
                    expositions[f"stripe{handle.index}"] = f.read()
            except OSError:
                pass
        merged_stats = merge_stats(stats_rows) if stats_rows else None
        if merged_stats is not None:
            # persist beside the output (atomic) so a rerun over the
            # complete output can still surface the run's stats
            tmp = f"{self.output}.stats.json.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(merged_stats, f)
                f.write("\n")
            os.replace(tmp, f"{self.output}.stats.json")
        prom_out = None
        if expositions:
            from licensee_tpu_torch.obs import merge_expositions

            prom_out = f"{self.output}.prom"
            with open(prom_out, "w", encoding="utf-8") as f:
                f.write(merge_expositions(expositions, label="stripe"))
        self._cleanup()
        self._event(
            f"merged {self.stripes} shard(s) -> {self.output} "
            f"({total} rows)"
        )
        self._notify("merged", rows=total, stripes=self.stripes)
        return {
            "stripes": self.stripes,
            "files": self.n_entries,
            "rows_written": total,
            "already_complete": False,
            "stats": merged_stats,
            "prom": prom_out,
            "per_stripe": [per_stripe[i] for i in sorted(per_stripe)],
        }

    def _cleanup(self) -> None:
        """Remove per-stripe intermediates after a successful merge (the
        work is complete and lives in ``output``; stale shards would
        otherwise confuse the next striped run's resume).  The shard
        sweep is a GLOB over ``<output>.shard-*`` — an earlier aborted
        run at a DIFFERENT stripe count left shards this run's handles
        don't name, and a future run at that count must never resume
        from months-stale rows.  Merge products themselves are kept —
        with one stripe the shard paths ARE the output paths."""
        import glob as globlib

        keep = {
            self.output,
            f"{self.output}.prom",
            f"{self.output}.meta.json",
            f"{self.output}.stats.json",
        }
        doomed = set(
            globlib.glob(f"{globlib.escape(self.output)}.shard-*")
        )
        for handle in self.handles:
            for suffix in ("", ".meta.json", ".stats.json", ".prom",
                           ".log"):
                doomed.add(f"{handle.shard}{suffix}")
        for path in doomed:
            if path in keep:
                continue
            try:
                os.remove(path)
            except OSError:
                pass


def selftest(stream=None, device: str = "cuda") -> int:
    """The 2-stripe smoke on ``device``: a small synthetic
    corpus runs once single-striped and once 2-striped through REAL
    batch-detect child processes; the merged 2-stripe output must be
    bit-identical to the 1-stripe run, stats must sum to the manifest
    length, and the merged exposition must parse.  Returns 0/1."""
    import tempfile

    stream = stream if stream is not None else sys.stderr

    def say(msg: str) -> None:
        stream.write(f"stripes-selftest: {msg}\n")
        stream.flush()

    import re

    from licensee_tpu_torch.corpus.license import License
    from licensee_tpu_torch.obs import check_exposition

    bodies = [
        re.sub(r"\[(\w+)\]", "example", License.find(k).content or "")
        for k in ("mit", "isc", "bsd-3-clause")
    ]
    with tempfile.TemporaryDirectory(prefix="licensee-stripes-") as tmpdir:
        paths = []
        for i in range(42):
            p = os.path.join(tmpdir, f"LICENSE_{i}")
            with open(p, "w", encoding="utf-8") as f:
                f.write(
                    f"Copyright (c) {2000 + i} Example Author {i}\n\n"
                    + bodies[i % len(bodies)]
                )
            paths.append(p)
        manifest = os.path.join(tmpdir, "manifest.txt")
        with open(manifest, "w", encoding="utf-8") as f:
            f.write("\n".join(paths) + "\n")
        base_env = dict(os.environ)
        forward = ("--batch-size", "16", "--mesh", "none",
                   "--device", device)
        outputs = {}
        for n in (1, 2):
            out = os.path.join(tmpdir, f"out-{n}.jsonl")
            runner = StripeRunner(
                manifest, out, n,
                forward_args=forward,
                base_env=base_env,
                on_event=say,
            )
            summary = runner.run()
            if summary["rows_written"] != len(paths):
                say(
                    f"FAIL: {n}-stripe run wrote "
                    f"{summary['rows_written']} rows, want {len(paths)}"
                )
                return 1
            if n > 1:
                stats = summary["stats"] or {}
                if stats.get("total") != len(paths):
                    say(f"FAIL: merged stats total {stats.get('total')}")
                    return 1
                prom = summary.get("prom")
                if prom:
                    with open(prom, encoding="utf-8") as f:
                        problems = check_exposition(f.read())
                    if problems:
                        say(f"FAIL: merged exposition: {problems[:3]}")
                        return 1
            with open(out, "rb") as f:
                outputs[n] = f.read()
        if outputs[1] != outputs[2]:
            say("FAIL: 2-stripe merged output != 1-stripe output")
            return 1
        rows = [
            json.loads(line)
            for line in outputs[2].decode().splitlines()
        ]
        seen_paths = [r["path"] for r in rows]
        if len(set(seen_paths)) != len(paths):
            say("FAIL: duplicate paths across shards")
            return 1
        matched = sum(1 for r in rows if r.get("key"))
        say(
            f"OK: 2-stripe merge bit-identical to 1-stripe "
            f"({len(rows)} rows, {matched} matched)"
        )
        # overlap smoke: the SAME manifest through the in-process
        # software pipeline at depth 1 (the synchronous dispatch ->
        # await -> write loop) and depth 3 — the async-submit /
        # FIFO-await contract must keep the JSONL bit-identical at
        # every pipeline depth, and both must match the striped runs
        from licensee_tpu_torch.projects.batch_project import BatchProject

        overlap_out = {}
        for depth in (1, 3):
            out = os.path.join(tmpdir, f"out-depth{depth}.jsonl")
            project = BatchProject(
                paths, batch_size=16, mesh=None, pipeline_depth=depth,
                device=device,
            )
            project.run(out, resume=False)
            with open(out, "rb") as f:
                overlap_out[depth] = f.read()
        if overlap_out[1] != overlap_out[3]:
            say("FAIL: depth-3 pipeline output != synchronous output")
            return 1
        if overlap_out[1] != outputs[1]:
            say("FAIL: pipelined output != striped-run output")
            return 1
        say("OK: overlap pipeline depth 1/3 bit-identical to sync")
        # tar-ingest smoke: the SAME blobs streamed out of a tarball
        # (members stored under the loose files' own absolute names,
        # manifest entry `archive.tar::*`) must produce bit-identical
        # per-blob JSONL to the loose-file manifest run, plus the
        # container-level verdict sidecar
        import io
        import tarfile

        tar_path = os.path.join(tmpdir, "archive.tar")
        with tarfile.open(tar_path, "w") as tf:
            for p in paths:
                with open(p, "rb") as f:
                    data = f.read()
                info = tarfile.TarInfo(name=p)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
        tar_out = os.path.join(tmpdir, "out-tar.jsonl")
        project = BatchProject(
            [f"{tar_path}::*"], batch_size=16, mesh=None, device=device
        )
        project.run(tar_out, resume=False)
        project.close()
        with open(tar_out, "rb") as f:
            tar_bytes = f.read()
        if tar_bytes != outputs[1]:
            say("FAIL: tar-ingest output != loose-file output")
            return 1
        with open(f"{tar_out}.containers.jsonl", encoding="utf-8") as f:
            containers = [json.loads(line) for line in f]
        if len(containers) != 1 or containers[0].get("files") != len(paths):
            say(f"FAIL: container verdict sidecar: {containers}")
            return 1
        say(
            "OK: tar-ingest bit-identical to loose files "
            f"(container license={containers[0].get('license')!r})"
        )
        # 2-stripe tar-ingest smoke: the SAME tarball striped by its
        # EXPANDED blob count across 2 real worker subprocesses — the
        # container's blobs span both stripes by construction — must
        # merge bit-identical to the 1-process tar run, and the merged
        # container sidecar must carry exactly one row per container
        tar_manifest = os.path.join(tmpdir, "tar_manifest.txt")
        with open(tar_manifest, "w", encoding="utf-8") as f:
            f.write(f"{tar_path}::*\n")
        tar2_out = os.path.join(tmpdir, "out-tar2.jsonl")
        runner = StripeRunner(
            tar_manifest, tar2_out, 2,
            forward_args=forward,
            base_env=base_env,
            on_event=say,
        )
        summary = runner.run()
        if runner.n_entries != len(paths):
            say(
                f"FAIL: expanded striping denominator "
                f"{runner.n_entries}, want {len(paths)}"
            )
            return 1
        if summary["rows_written"] != len(paths):
            say(
                f"FAIL: 2-stripe tar run wrote "
                f"{summary['rows_written']} rows, want {len(paths)}"
            )
            return 1
        with open(tar2_out, "rb") as f:
            if f.read() != tar_bytes:
                say("FAIL: 2-stripe tar merge != 1-process tar output")
                return 1
        with open(
            f"{tar2_out}.containers.jsonl", encoding="utf-8"
        ) as f:
            striped_containers = [json.loads(line) for line in f]
        if striped_containers != containers:
            say(
                "FAIL: striped container sidecar != 1-process sidecar: "
                f"{striped_containers}"
            )
            return 1
        say(
            "OK: 2-stripe tar-ingest bit-identical to 1-process "
            "(one container row, blobs spanned both stripes)"
        )
    return 0


def selftest_remote(stream=None, device: str = "cuda") -> int:
    """The ``--selftest-remote`` drill on ``device``: a loopback
    HTTP host (stdlib) serves a tar and a zip of a
    synthetic corpus, and the remote ingest tier (ingest/remote.py)
    must scan them bit-identical to the same tarball read off local
    disk — through one scripted 503-then-recover fault on the ranged
    path and one mid-stream body truncation on the zip path, and
    through a REAL 2-stripe StripeRunner merge whose children fetch
    their spans over 127.0.0.1.  Returns 0/1."""
    import io
    import tarfile
    import zipfile

    stream = stream if stream is not None else sys.stderr

    def say(msg: str) -> None:
        stream.write(f"remote-selftest: {msg}\n")
        stream.flush()

    import re

    from licensee_tpu_torch.corpus.license import License

    bodies = [
        re.sub(r"\[(\w+)\]", "example", License.find(k).content or "")
        for k in ("mit", "isc", "bsd-3-clause")
    ]
    members = {
        f"blob{i:03d}/LICENSE": (
            f"Copyright (c) {2000 + i} Example Author {i}\n\n"
            + bodies[i % len(bodies)]
        ).encode()
        for i in range(42)
    }
    tar_buf = io.BytesIO()
    with tarfile.open(fileobj=tar_buf, mode="w") as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    tar_bytes = tar_buf.getvalue()
    zip_buf = io.BytesIO()
    with zipfile.ZipFile(zip_buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, data in members.items():
            zf.writestr(name, data)
    zip_bytes = zip_buf.getvalue()

    # fast backoff for the scripted faults — in this process AND the
    # striped children (restored on exit: tests call this in-process)
    saved_backoff = os.environ.get("LICENSEE_TPU_REMOTE_BACKOFF_MS")
    os.environ["LICENSEE_TPU_REMOTE_BACKOFF_MS"] = "1"
    try:
        return _selftest_remote_body(stream, say, members,
                                     tar_bytes, zip_bytes, device)
    finally:
        if saved_backoff is None:
            os.environ.pop("LICENSEE_TPU_REMOTE_BACKOFF_MS", None)
        else:
            os.environ["LICENSEE_TPU_REMOTE_BACKOFF_MS"] = saved_backoff


def _selftest_remote_body(stream, say, members, tar_bytes,
                          zip_bytes, device) -> int:
    import tempfile

    from licensee_tpu_torch.ingest.loopback import LoopbackBlobHost
    from licensee_tpu_torch.projects.batch_project import BatchProject

    with tempfile.TemporaryDirectory(
        prefix="licensee-remote-"
    ) as tmpdir, LoopbackBlobHost(
        {"archive.tar": tar_bytes, "archive.zip": zip_bytes}
    ) as host:
        base_env = {
            **os.environ,
            "LICENSEE_TPU_REMOTE_BACKOFF_MS": "1",
        }

        # baseline: the tarball read off local disk
        tar_path = os.path.join(tmpdir, "archive.tar")
        with open(tar_path, "wb") as f:
            f.write(tar_bytes)
        base_out = os.path.join(tmpdir, "out-local.jsonl")
        project = BatchProject(
            [f"{tar_path}::*"], batch_size=16, mesh=None, device=device
        )
        project.run(base_out, resume=False)
        project.close()
        with open(base_out, "rb") as f:
            base = f.read()

        # remote tar THROUGH a 503-then-recover fault on the ranged
        # path: the retry budget must absorb it, bit-identically
        host.fail_next("archive.tar", 2, 503)
        rtar_out = os.path.join(tmpdir, "out-rtar.jsonl")
        project = BatchProject(
            [host.url("archive.tar") + "::*"], batch_size=16, mesh=None,
            device=device,
        )
        project.run(rtar_out, resume=False)
        project.close()
        with open(rtar_out, "rb") as f:
            if f.read() != base:
                say("FAIL: remote tar output != local tar output")
                return 1
        retries = host.hits.get("archive.tar", 0)
        say(
            "OK: remote tar bit-identical to local through a scripted "
            f"503x2 ({retries} requests served)"
        )

        # remote zip THROUGH one mid-stream truncation (full
        # Content-Length promised, body torn): retried, bit-identical
        host.truncate_next("archive.zip", 64)
        rzip_out = os.path.join(tmpdir, "out-rzip.jsonl")
        project = BatchProject(
            [host.url("archive.zip") + "::*"], batch_size=16, mesh=None,
            device=device,
        )
        project.run(rzip_out, resume=False)
        project.close()
        with open(rzip_out, "rb") as f:
            if f.read() != base:
                say("FAIL: remote zip output != local tar output")
                return 1
        say(
            "OK: remote zip bit-identical through one mid-stream "
            "truncation"
        )

        # the merge gate: the remote tarball striped by its EXPANDED
        # blob count across 2 real batch-detect children, each
        # fetching its own span over 127.0.0.1 — merged output must be
        # bit-identical to the local 1-process run, one container row
        manifest = os.path.join(tmpdir, "remote_manifest.txt")
        with open(manifest, "w", encoding="utf-8") as f:
            f.write(host.url("archive.tar") + "::*\n")
        striped_out = os.path.join(tmpdir, "out-striped.jsonl")
        runner = StripeRunner(
            manifest, striped_out, 2,
            forward_args=("--batch-size", "16", "--mesh", "none",
                          "--device", device),
            base_env=base_env,
            on_event=say,
        )
        summary = runner.run()
        if runner.n_entries != len(members):
            say(
                f"FAIL: expanded remote striping denominator "
                f"{runner.n_entries}, want {len(members)}"
            )
            return 1
        if summary["rows_written"] != len(members):
            say(
                f"FAIL: 2-stripe remote run wrote "
                f"{summary['rows_written']} rows, want {len(members)}"
            )
            return 1
        with open(striped_out, "rb") as f:
            if f.read() != base:
                say("FAIL: 2-stripe remote merge != local output")
                return 1
        with open(
            f"{striped_out}.containers.jsonl", encoding="utf-8"
        ) as f:
            containers = [json.loads(line) for line in f]
        if len(containers) != 1 or containers[0].get("files") != len(
            members
        ):
            say(f"FAIL: remote container sidecar: {containers}")
            return 1
        say(
            "OK: 2-stripe remote merge bit-identical to local "
            f"(container license={containers[0].get('license')!r})"
        )
    return 0


_AUTOSCALE_STUB = '''\
import json
import os
import sys
import time

from licensee_tpu_torch.parallel.distributed import (
    manifest_stripe,
    shard_output_path,
)

output, index, count, n_entries, pfile, delay = sys.argv[1:7]
index, count, n_entries = int(index), int(count), int(n_entries)
delay = float(delay)
resume = "--no-resume" not in sys.argv[7:]
shard = shard_output_path(output, index, count)
lo, hi = manifest_stripe(n_entries, index, count)
data = b""
if resume:
    try:
        with open(shard, "rb") as f:
            data = f.read()
    except OSError:
        data = b""
    data = data[: data.rfind(b"\\n") + 1]  # torn-tail truncation
done = data.count(b"\\n")
epoch = 0
with open(shard, "wb") as f:
    f.write(data)
    f.flush()
    for j in range(lo + done, hi):
        epoch += 1
        try:
            with open(pfile, encoding="utf-8") as pf:
                busy = pf.read().strip() or "0"
        except OSError:
            busy = "0"
        tmp = f"{shard}.prom.tmp"
        with open(tmp, "w", encoding="utf-8") as mf:
            mf.write("# TYPE stripe_scrape_epoch gauge\\n")
            mf.write(f"stripe_scrape_epoch {epoch}\\n")
            mf.write("# TYPE pipeline_featurize_busy gauge\\n")
            mf.write(f"pipeline_featurize_busy {busy}\\n")
        os.replace(tmp, f"{shard}.prom")
        row = json.dumps({"path": f"f{j:05d}", "row": j})
        f.write(row.encode() + b"\\n")
        f.flush()
        time.sleep(delay)
'''


def selftest_autoscale(stream=None) -> int:
    """The ``--selftest-autoscale`` drill: an
    elastic run over deterministic stub stripes whose ``--prom-file``
    heartbeat reports a featurize-lane pressure the drill controls.
    Pressure starts saturated (1.0) -> the runner must scale up; at the
    first up-rescale the drill flips pressure idle (0.05) -> the runner
    must scale back down; the merged output must be bit-identical to
    what a static single stripe writes, scale events must respect the
    cooldown, and the stripe count must respect the bounds.  Exercises
    the REAL drain/respawn/resume machinery — only the workers are
    stubs.  Returns 0/1."""
    import tempfile

    stream = stream if stream is not None else sys.stderr

    def say(msg: str) -> None:
        stream.write(f"autoscale-selftest: {msg}\n")
        stream.flush()

    from licensee_tpu_torch.parallel.autoscale import AutoscaleConfig

    n = 150
    delay = 0.05
    cooldown_s = 0.6
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    with tempfile.TemporaryDirectory(
        prefix="licensee-autoscale-"
    ) as tmpdir:
        stub = os.path.join(tmpdir, "stub_worker.py")
        with open(stub, "w", encoding="utf-8") as f:
            f.write(_AUTOSCALE_STUB)
        manifest = os.path.join(tmpdir, "manifest.txt")
        with open(manifest, "w", encoding="utf-8") as f:
            f.write("\n".join(f"f{j:05d}" for j in range(n)) + "\n")
        pfile = os.path.join(tmpdir, "pressure.txt")
        with open(pfile, "w", encoding="utf-8") as f:
            f.write("1.0\n")
        out = os.path.join(tmpdir, "out.jsonl")
        pythonpath = os.environ.get("PYTHONPATH", "")
        env = {
            **os.environ,
            "PYTHONPATH": (
                f"{repo_root}{os.pathsep}{pythonpath}"
                if pythonpath else repo_root
            ),
        }

        def argv_for(i, count, resume=True):
            argv = [
                sys.executable, stub, out, str(i), str(count), str(n),
                pfile, str(delay),
            ]
            if not resume:
                argv.append("--no-resume")
            return argv

        def on_progress(kind, info):
            if kind == "rescale" and (
                info["to_stripes"] > info["from_stripes"]
            ):
                # saturation answered: the drill goes idle so the
                # decider must walk capacity back down
                tmp = f"{pfile}.tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write("0.05\n")
                os.replace(tmp, pfile)

        runner = StripeRunner(
            manifest, out, 1,
            elastic=AutoscaleConfig(
                min_units=1, max_units=2,
                up_at=0.8, down_at=0.3,
                confirm_ticks=2, cooldown_s=cooldown_s,
                payoff_min=0.0,
            ),
            elastic_interval_s=0.25,
            elastic_stale_after_s=5.0,
            poll_interval_s=0.05,
            sigterm_timeout_s=5.0,
            argv_for=argv_for,
            env_for=lambda i, chips: env,
            on_event=say,
            on_progress=on_progress,
        )
        summary = runner.run()
        if summary["rows_written"] != n:
            say(f"FAIL: wrote {summary['rows_written']} rows, want {n}")
            return 1
        expected = b"".join(
            json.dumps({"path": f"f{j:05d}", "row": j}).encode() + b"\n"
            for j in range(n)
        )
        with open(out, "rb") as f:
            got = f.read()
        if got != expected:
            say("FAIL: elastic merged output != static 1-stripe bytes")
            return 1
        auto = summary.get("autoscale") or {}
        events = auto.get("events") or []
        ups = [e for e in events if e["to"] > e["from"]]
        downs = [e for e in events if e["to"] < e["from"]]
        if not ups:
            say(f"FAIL: saturated lane never scaled up: {events}")
            return 1
        if not downs:
            say(f"FAIL: idle lane never scaled down: {events}")
            return 1
        if any(e["to"] > 2 or e["to"] < 1 for e in events):
            say(f"FAIL: bounds violated: {events}")
            return 1
        for a, b in zip(events, events[1:]):
            if b["t"] - a["t"] < cooldown_s:
                say(f"FAIL: cooldown violated: {events}")
                return 1
        say(
            f"OK: scaled up then down ({len(ups)} up / {len(downs)} "
            f"down over {auto.get('scale_events')} rescales), merged "
            f"output bit-identical, cooldown {cooldown_s}s respected"
        )
    return 0
