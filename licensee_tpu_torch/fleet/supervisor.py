"""Worker supervision for the serving fleet: spawn N serve workers,
health-check them, restart crashes and wedges with exponential backoff,
and drain gracefully for rolling restarts.

The port's copy of `licensee_tpu/fleet/supervisor.py`.  Each worker is
ONE ``python -m licensee_tpu_torch.cli.main serve --socket`` process:
its own failure domain, its own CUDA context on the card (or the CPU,
with ``--device cpu`` in its serve arguments), and (with
``chips_per_worker``) its own card subset, exported through the same
env contract the offline stripes use: the supervisor sets
``LICENSEE_TPU_VISIBLE_CHIPS`` in the child environment and runs
``apply_visible_chips`` over that dict, which derives
``CUDA_VISIBLE_DEVICES`` (parallel/distributed.py).  Workers are
started with ``subprocess.Popen`` (fork and exec), never forked from a
process that holds a CUDA context.  A worker that cannot open the card
exits non-zero, which is a crash like any other.  The stripe runner
(parallel/stripes.py) shares the backoff, the graceful stop and the
child environment.

Failure handling, in escalation order:

* **crash** — ``proc.poll()`` shows an exit: respawn after the current
  backoff delay (``backoff_base_s * 2^restarts`` capped at
  ``backoff_max_s``; the restart counter resets once a worker stays
  healthy ``stable_after_s``, so a week-old worker's first crash
  restarts fast).
* **wedge** — the process is alive but ``{"op": "stats"}`` probes fail
  ``wedged_after`` consecutive times (a hung compile, a stopped
  process): SIGKILL, then the crash path above.  A freshly spawned
  worker gets ``startup_grace_s`` before probe failures count — the
  torch import, the CUDA context, the kernel library and the corpus
  load legitimately take seconds.
* **drain** — the rolling-restart verb: mark the worker draining (the
  router stops dispatching to it), wait until the worker reports zero
  queued/in-flight work AND the router reports zero outstanding routed
  requests, then SIGTERM (the serve loop shuts down cleanly and
  unlinks its socket), escalating to SIGKILL only on a stuck exit.

Upgrades ride :meth:`Supervisor.reload_fleet`: a rolling, health-gated
corpus reload (one worker mid-swap at a time, failure budget, automatic
rollback, respawn-argv patching) — zero-downtime corpus rollout with
``rolling_restart()`` as the fallback path.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

from licensee_tpu_torch.fleet.wire import ConnectionPool, WireError, oneshot
from licensee_tpu_torch.obs.flight import (
    HARVEST_TAIL,
    flight_path_for_socket,
    load_flight_dump,
)
from licensee_tpu_torch.parallel.distributed import (
    apply_visible_chips,
    chips_for_worker,
)

# worker lifecycle states (status()/metrics surface)
STARTING = "starting"
HEALTHY = "healthy"
UNHEALTHY = "unhealthy"
DOWN = "down"
DRAINING = "draining"
STOPPED = "stopped"


class BackoffPolicy:
    """Capped exponential restart backoff — the spawn/backoff core
    shared by this serving supervisor and the offline stripe runner
    (parallel/stripes.py): restart number ``r + 1`` waits
    ``base_s * 2^r`` seconds, capped at ``max_s``; a worker that stays
    healthy ``stable_after_s`` earns its restart counter back so a
    week-old process's first crash restarts fast."""

    def __init__(
        self,
        base_s: float = 0.25,
        max_s: float = 10.0,
        stable_after_s: float = 10.0,
    ):
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.stable_after_s = float(stable_after_s)

    def delay_s(self, restarts: int) -> float:
        """The delay before restart number ``restarts + 1``."""
        return min(self.base_s * (2 ** restarts), self.max_s)


def terminate_process(
    proc: subprocess.Popen | None, sigterm_timeout_s: float = 5.0
) -> None:
    """SIGTERM, escalate to SIGKILL after ``sigterm_timeout_s`` — the
    one graceful-stop primitive (shared with the stripe runner)."""
    if proc is None or proc.poll() is not None:
        return
    try:
        proc.terminate()
        proc.wait(timeout=sigterm_timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5.0)
    except OSError:
        pass


def default_worker_argv(
    socket_path: str, serve_args: tuple[str, ...] = ()
) -> list[str]:
    """The production worker command: the existing serve loop on its
    own Unix socket."""
    return [
        sys.executable, "-m", "licensee_tpu_torch.cli.main", "serve",
        "--socket", socket_path, *serve_args,
    ]


def worker_env(
    base_env: dict | None, chips: list[str] | None
) -> dict[str, str]:
    """The child environment for one worker.

    With ``chips``, exports ``LICENSEE_TPU_VISIBLE_CHIPS`` and derives
    the runtime visibility vars through ``apply_visible_chips`` on the
    CHILD's env dict — the same translation, validation, and CPU
    rehearsal the offline co-located launch gets, without touching this
    process's environment.  Also pins PYTHONPATH to the package root so
    ``-m licensee_tpu_torch...`` resolves regardless of the child's cwd."""
    env = dict(os.environ if base_env is None else base_env)
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    existing = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (
        pkg_root if not existing else pkg_root + os.pathsep + existing
    )
    if chips:
        env["LICENSEE_TPU_VISIBLE_CHIPS"] = ",".join(chips)
        apply_visible_chips(env)
    return env


class WorkerHandle:
    """One supervised worker: its spec, its live process, and the
    restart/health bookkeeping.  Mutated only by the supervisor (under
    its lock); the router reads ``state``/``draining`` lock-free —
    a stale read costs one failed dispatch attempt, which fails over."""

    def __init__(self, name: str, socket_path: str, argv, env):
        self.name = name
        self.socket_path = socket_path
        self.argv = list(argv)
        self.env = dict(env)
        self.proc: subprocess.Popen | None = None
        self.state = STARTING
        self.draining = False
        self.restarts = 0
        self.probe_failures = 0
        self.spawned_at: float | None = None
        self.healthy_since: float | None = None
        self.next_spawn_at: float = 0.0
        self.last_stats: dict = {}
        self.exit_codes: list[int] = []  # recent exits, newest last
        # one entry per scheduled restart: how the worker died (exit
        # code / signal), the backoff armed, and the harvested flight-
        # recorder black box (dump path + last events) — the post-
        # mortem record `fleet --selftest` gates on
        self.restart_log: list[dict] = []

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def as_dict(self) -> dict:
        sched = (self.last_stats.get("scheduler") or {})
        return {
            "socket": self.socket_path,
            "pid": self.pid,
            "state": self.state,
            "draining": self.draining,
            "restarts": self.restarts,
            "probe_failures": self.probe_failures,
            "queue_depth": sched.get("queue_depth"),
            "in_flight": sched.get("in_flight"),
            "completed": sched.get("completed"),
            "exit_codes": self.exit_codes[-5:],
            "restart_log": self.restart_log[-3:],
        }


class Supervisor:
    """Spawn + monitor + restart + drain a set of serve workers.

    ``workers`` maps name -> socket path; ``argv_for(name, socket)``
    builds each worker's command (defaults to the serve CLI), so tests
    and the fault harness supervise stub workers through the exact
    production restart machinery."""

    def __init__(
        self,
        workers: dict[str, str],
        *,
        argv_for=None,
        env_for=None,
        chips_per_worker: int | None = None,
        serve_args: tuple[str, ...] = (),
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 2.0,
        wedged_after: int = 3,
        startup_grace_s: float = 120.0,
        backoff_base_s: float = 0.25,
        backoff_max_s: float = 10.0,
        stable_after_s: float = 10.0,
        base_env: dict | None = None,
    ):
        if not workers:
            raise ValueError("need at least one worker")
        if chips_per_worker is not None and chips_per_worker < 1:
            raise ValueError(
                f"chips_per_worker must be >= 1, got {chips_per_worker!r}"
            )
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.wedged_after = int(wedged_after)
        self.startup_grace_s = float(startup_grace_s)
        # the shared spawn/backoff core (also driving the offline
        # stripe runner, parallel/stripes.py) — self.backoff is the
        # single source of truth; the read-only properties below keep
        # the long-standing attribute names without a second copy
        self.backoff = BackoffPolicy(
            base_s=backoff_base_s,
            max_s=backoff_max_s,
            stable_after_s=stable_after_s,
        )
        # the router attaches itself here (fleet CLI): drain then also
        # waits for the router's outstanding count to hit zero
        self.router = None
        # spawn ingredients, kept so add_worker can grow the fleet at
        # runtime from the same spec the seed workers got
        self._argv_for = argv_for
        self._env_for = env_for
        self._serve_args = tuple(serve_args)
        self._base_env = base_env
        self._chips_per_worker = chips_per_worker
        self._next_chip_index = len(workers)
        self.workers: dict[str, WorkerHandle] = {}
        for i, (name, sock) in enumerate(workers.items()):
            chips = None
            if chips_per_worker is not None:
                chips = chips_for_worker(i, chips_per_worker)
            env = (
                env_for(name, chips)
                if env_for is not None
                else worker_env(base_env, chips)
            )
            argv = (
                argv_for(name, sock)
                if argv_for is not None
                else default_worker_argv(sock, serve_args)
            )
            self.workers[name] = WorkerHandle(name, sock, argv, env)
        self._lock = threading.Lock()
        # fleet-level reload mutex: one rolling reload at a time.  Two
        # concurrent rolls would interleave worker swaps (the per-worker
        # reload_in_progress guard only catches same-instant overlap on
        # ONE worker), leaving the fleet on mixed fingerprints with
        # clobbered respawn argv — the second roll is refused
        # deterministically instead, mirroring the worker-level verb.
        self._reload_fleet_lock = threading.Lock()
        # one parked connection per worker for the recurring health
        # probe: N workers x a fast probe interval used to dial a fresh
        # socket every round.  The pool's stale-park retry absorbs
        # worker restarts; max_idle=1 because probes are serial per
        # worker (one monitor thread).
        # connect_timeout=probe_timeout_s: the pool's default 2 s dial
        # would outlast a fast probe budget and stall the serial
        # monitor thread on a worker wedged at accept
        self._probe_pools = {
            name: ConnectionPool(
                h.socket_path, max_idle=1,
                connect_timeout=self.probe_timeout_s,
            )
            for name, h in self.workers.items()
        }
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def backoff_base_s(self) -> float:
        return self.backoff.base_s

    @property
    def backoff_max_s(self) -> float:
        return self.backoff.max_s

    @property
    def stable_after_s(self) -> float:
        return self.backoff.stable_after_s

    # -- lifecycle --

    def start(self) -> None:
        with self._lock:
            for handle in self.workers.values():
                if handle.proc is None and handle.state != STOPPED:
                    self._spawn(handle)
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._monitor, name="fleet-supervisor", daemon=True
            )
            self._thread.start()

    def stop(self, *, sigterm_timeout_s: float = 5.0) -> None:
        """Stop monitoring and terminate every worker (SIGTERM, then
        SIGKILL after ``sigterm_timeout_s``)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._lock:
            handles = list(self.workers.values())
        for handle in handles:
            self._terminate(handle, sigterm_timeout_s)
            handle.state = STOPPED
        for pool in self._probe_pools.values():
            pool.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- elastic membership (the FleetAutoscaler's two levers) --

    def add_worker(self, name: str, socket_path: str) -> WorkerHandle:
        """Grow the fleet by one worker at runtime: build its spec from
        the same ingredients the seed fleet used (``argv_for`` /
        ``env_for`` / chip striping continue where the seed stopped),
        spawn it immediately, and register its probe pool.  The monitor
        thread picks it up on its next pass."""
        with self._lock:
            if name in self.workers:
                raise ValueError(f"worker {name!r} already exists")
            chips = None
            if self._chips_per_worker is not None:
                chips = chips_for_worker(
                    self._next_chip_index, self._chips_per_worker
                )
            self._next_chip_index += 1
            env = (
                self._env_for(name, chips)
                if self._env_for is not None
                else worker_env(self._base_env, chips)
            )
            argv = (
                self._argv_for(name, socket_path)
                if self._argv_for is not None
                else default_worker_argv(socket_path, self._serve_args)
            )
            handle = WorkerHandle(name, socket_path, argv, env)
            self.workers[name] = handle
            self._probe_pools[name] = ConnectionPool(
                socket_path, max_idle=1,
                connect_timeout=self.probe_timeout_s,
            )
            self._spawn(handle)
        return handle

    def remove_worker(
        self,
        name: str,
        *,
        timeout_s: float = 30.0,
        sigterm_timeout_s: float = 5.0,
    ) -> bool:
        """Retire one worker at runtime: drain it (stop dispatch, wait
        for in-flight work, SIGTERM — no respawn), then drop it from
        the fleet and close its probe pool.  Returns the drain's clean
        flag.  The drain marks the handle STOPPED before membership
        changes, so a monitor pass that already snapshotted the handle
        skips it instead of respawning a ghost."""
        if name not in self.workers:
            raise KeyError(f"no worker named {name!r}")
        clean = self.drain(
            name, timeout_s=timeout_s, restart=False,
            sigterm_timeout_s=sigterm_timeout_s,
        )
        with self._lock:
            self.workers.pop(name, None)
        pool = self._probe_pools.pop(name, None)
        if pool is not None:
            pool.close()
        return clean

    # -- spawn / kill primitives (lock held by callers where noted) --

    # every caller (start, poll_once, drain) already holds self._lock
    # across the call; the analyzer now PROVES that contract through
    # the call graph (caller-holds-the-lock), so no pragma is needed
    def _spawn(self, handle: WorkerHandle) -> None:
        """Start (or restart) one worker process.  Lock held.

        The predecessor's flight-recorder box is cleared first: a
        drained worker's clean-shutdown dump (or any leftover) must
        never be harvested as THIS incarnation's crash evidence if it
        dies before writing its own (crash-path harvests already
        consumed their box in _schedule_restart)."""
        try:
            os.unlink(flight_path_for_socket(handle.socket_path))
        except OSError:
            pass
        handle.proc = subprocess.Popen(
            handle.argv,
            env=handle.env,
            stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        handle.spawned_at = time.perf_counter()
        handle.healthy_since = None
        handle.probe_failures = 0
        handle.state = STARTING

    def _terminate(
        self, handle: WorkerHandle, sigterm_timeout_s: float
    ) -> None:
        terminate_process(handle.proc, sigterm_timeout_s)

    # called only from poll_once with self._lock held; the restart
    # bookkeeping rides the caller's critical section (proven by the
    # analyzer's caller-holds-the-lock contract)
    def _schedule_restart(
        self,
        handle: WorkerHandle,
        reason: str = "crash",
        returncode: int | None = None,
    ) -> None:
        """Record the death (exit code/signal + the harvested flight-
        recorder black box) and arm the backoff timer.  Lock held."""
        delay = self.backoff.delay_s(handle.restarts)
        handle.restarts += 1
        handle.next_spawn_at = time.perf_counter() + delay
        handle.state = DOWN
        handle.proc = None
        entry = {
            "reason": reason,
            "exit_code": (
                returncode if returncode is None or returncode >= 0
                else None
            ),
            # a negative Popen returncode IS the killing signal
            "signal": (
                -returncode
                if returncode is not None and returncode < 0
                else None
            ),
            "backoff_s": round(delay, 3),
            "restarts": handle.restarts,
        }
        # harvest the black box NOW, before the respawned incarnation
        # overwrites it: the dump on disk is at most one flush interval
        # older than the death (obs/flight.py's spill contract)
        entry.update(self._harvest_flight(handle))
        handle.restart_log.append(entry)
        del handle.restart_log[:-20]

    @staticmethod
    def _harvest_flight(handle: WorkerHandle) -> dict:
        """Read a dead worker's flight-recorder dump; the last events
        ride the restart-log entry so a SIGKILL post-mortem starts from
        recorded evidence.  The dump is CONSUMED (unlinked) once
        harvested: a crash-looping respawn that dies before its first
        flush must read as "no box" — honest — never replay the
        previous incarnation's events as fresh evidence."""
        path = flight_path_for_socket(handle.socket_path)
        box = load_flight_dump(path)
        if box is None:
            return {
                "flight_dump": path, "flight_harvested": False,
                "flight_events": [],
            }
        try:
            os.unlink(path)
        except OSError:
            pass  # harvested either way; the entry holds the evidence
        events = box.get("events") or []
        return {
            "flight_dump": path,
            "flight_harvested": True,
            "flight_proc": box.get("proc"),
            "flight_recorded": box.get("recorded"),
            "flight_events": events[-HARVEST_TAIL:],
        }

    def backoff_delay_s(self, restarts: int) -> float:
        """The delay before restart number ``restarts + 1`` — exposed
        so tests and the selftest can name the backoff budget."""
        return self.backoff.delay_s(restarts)

    # -- the monitor loop --

    def _monitor(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            self.poll_once()

    def poll_once(self) -> None:
        """One supervision pass over every worker (public so tests can
        drive supervision deterministically without the timer)."""
        with self._lock:
            handles = list(self.workers.values())
        now = time.perf_counter()
        for handle in handles:
            with self._lock:
                if handle.state == STOPPED or handle.draining:
                    continue
                proc = handle.proc
                if proc is not None and proc.poll() is not None:
                    handle.exit_codes.append(proc.returncode)
                    self._schedule_restart(
                        handle, "crash", proc.returncode
                    )
                    continue
                if proc is None:
                    if now >= handle.next_spawn_at:
                        self._spawn(handle)
                    continue
            # probe OUTSIDE the lock: a 2-second probe timeout must not
            # freeze supervision of every other worker
            stats = self.probe(handle.name)
            with self._lock:
                if stats is not None:
                    handle.last_stats = stats
                    handle.probe_failures = 0
                    if handle.healthy_since is None:
                        handle.healthy_since = time.perf_counter()
                    elif (
                        handle.restarts
                        and time.perf_counter() - handle.healthy_since
                        >= self.stable_after_s
                    ):
                        handle.restarts = 0  # earned a fresh backoff
                    handle.state = HEALTHY
                    continue
                handle.healthy_since = None
                in_grace = (
                    handle.spawned_at is not None
                    and time.perf_counter() - handle.spawned_at
                    < self.startup_grace_s
                )
                if handle.state == STARTING and in_grace:
                    continue  # still booting: not a failure yet
                handle.probe_failures += 1
                if handle.probe_failures >= self.wedged_after:
                    # alive but unresponsive: wedged.  SIGKILL — a
                    # stopped/hung process won't honor SIGTERM
                    proc = handle.proc
                    if proc is not None and proc.poll() is None:
                        try:
                            proc.kill()
                            proc.wait(timeout=5.0)
                        except (OSError, subprocess.TimeoutExpired):
                            pass
                    returncode = None
                    if proc is not None and proc.poll() is not None:
                        returncode = proc.returncode
                        handle.exit_codes.append(returncode)
                    self._schedule_restart(handle, "wedge", returncode)
                else:
                    handle.state = UNHEALTHY

    # -- probes --

    def probe(self, name: str) -> dict | None:
        """One ``{"op": "stats"}`` round trip to a worker; the stats
        dict, or None when the worker cannot answer."""
        with self._lock:
            pool = self._probe_pools.get(name)
            if pool is None:  # dynamically added worker (tests)
                handle = self.workers.get(name)
                if handle is None:
                    # removed concurrently (remove_worker): not an
                    # error — a monitor pass that raced the removal
                    # just moves on
                    return None
                pool = ConnectionPool(
                    handle.socket_path, max_idle=1,
                    connect_timeout=self.probe_timeout_s,
                )
                self._probe_pools[name] = pool
        try:
            row = pool.request({"op": "stats"}, self.probe_timeout_s)
        except WireError:
            return None
        stats = row.get("stats")
        return stats if isinstance(stats, dict) else None

    def wait_healthy(self, timeout_s: float = 120.0) -> bool:
        """Block until every non-stopped worker answers probes (fleet
        boot barrier); False on timeout."""
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            pending = [
                h.name
                for h in self.workers.values()
                if h.state != STOPPED and self.probe(h.name) is None
            ]
            if not pending:
                return True
            time.sleep(0.1)
        return False

    def dispatchable(self, name: str) -> bool:
        """May the router send NEW work to this worker?  (The router
        additionally applies its own probe-based health view.)"""
        handle = self.workers.get(name)
        return (
            handle is not None
            and not handle.draining
            and handle.state not in (STOPPED, DOWN)
        )

    # -- drain / rolling restart --

    def drain(
        self,
        name: str,
        *,
        timeout_s: float = 30.0,
        restart: bool = True,
        sigterm_timeout_s: float = 5.0,
    ) -> bool:
        """Gracefully take one worker out of service: stop dispatch,
        wait for in-flight work, SIGTERM, optionally respawn.

        Returns True when the worker drained clean (every in-flight
        request finished before the SIGTERM); False when the timeout
        forced termination with work possibly still in flight."""
        handle = self.workers[name]
        with self._lock:
            handle.draining = True
            handle.state = DRAINING
        clean = False
        try:
            deadline = time.perf_counter() + timeout_s
            while time.perf_counter() < deadline:
                stats = self.probe(name)
                sched = (stats or {}).get("scheduler") or {}
                worker_idle = (
                    stats is not None
                    and sched.get("queue_depth") == 0
                    and sched.get("in_flight") == 0
                )
                router = self.router
                router_idle = (
                    router is None or router.outstanding(name) == 0
                )
                if stats is None and handle.proc is not None and (
                    handle.proc.poll() is not None
                ):
                    # died mid-drain: in-flight work died with it (the
                    # router's retries own it now) — not a clean drain
                    break
                if worker_idle and router_idle:
                    clean = True
                    break
                time.sleep(0.05)
            self._terminate(handle, sigterm_timeout_s)
        finally:
            with self._lock:
                if handle.proc is not None and (
                    handle.proc.poll() is not None
                ):
                    handle.exit_codes.append(handle.proc.returncode)
                handle.proc = None
                if restart:
                    self._spawn(handle)
                else:
                    handle.state = STOPPED
                handle.draining = False
        return clean

    def rolling_restart(self, *, timeout_s: float = 30.0) -> dict:
        """Drain-and-respawn every worker IN SEQUENCE — at most one
        replica out of service at a time, the zero-downtime restart."""
        out = {}
        for name in list(self.workers):
            out[name] = self.drain(name, timeout_s=timeout_s, restart=True)
            # wait for the replacement before touching the next replica
            deadline = time.perf_counter() + max(timeout_s, 60.0)
            while time.perf_counter() < deadline:
                if self.probe(name) is not None:
                    break
                time.sleep(0.1)
        return out

    # -- fleet-wide rolling corpus reload --

    @staticmethod
    def patch_corpus_argv(argv: list[str], corpus: str) -> list[str]:
        """Rewrite a serve worker's argv so a LATER crash-restart boots
        the corpus it was rolled onto — without this, a restart would
        silently roll one replica back to its launch-time corpus.
        Replaces the value after ``--corpus`` (or appends the pair)."""
        out = list(argv)
        for i, arg in enumerate(out[:-1]):
            if arg == "--corpus":
                out[i + 1] = corpus
                return out
        return out + ["--corpus", corpus]

    def _await_fingerprint(
        self, name: str, fingerprint: str | None, timeout_s: float
    ) -> bool:
        """Health-gate one worker after its reload verb answered: it
        must come back on probes AND report the expected fingerprint."""
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            stats = self.probe(name)
            if stats is not None:
                got = (stats.get("corpus") or {}).get("fingerprint")
                if fingerprint is None or got == fingerprint:
                    return True
            time.sleep(0.1)
        return False

    def reload_fleet(
        self,
        corpus: str,
        *,
        timeout_s: float = 300.0,
        health_timeout_s: float = 30.0,
        failure_budget: int = 0,
        rollback: bool = True,
        argv_patch=None,
    ) -> dict:
        """Rolling corpus reload: one worker at a time, health-gated,
        with a capped failure budget and automatic rollback.

        Per worker, in sequence: send ``{"op": "reload"}``, wait for
        the validated swap to answer, then gate on a health probe
        reporting the NEW fingerprint before touching the next replica
        — at most one worker is ever mid-swap, so the fleet keeps
        serving throughout.  A worker that refuses the corpus (compile
        error, corrupt artifact, failed validation) or dies mid-swap
        counts against ``failure_budget``; when the budget is exceeded,
        every already-reloaded worker is rolled back to the corpus
        source it reported before the roll, and the fleet is left
        healthy on the OLD fingerprint.  ``rolling_restart()`` remains
        the fallback path when a corpus can only change via argv.

        ``argv_patch(argv, corpus) -> argv`` rewrites a successfully
        reloaded worker's respawn command (default:
        :meth:`patch_corpus_argv`) so later crash-restarts boot the new
        corpus instead of silently rolling back one replica.

        One roll at a time, fleet-wide: a reload_fleet that arrives
        while another is rolling is refused deterministically
        (``error: fleet_reload_in_progress``) — never queued, never
        interleaved — so "at most one worker is ever mid-swap" holds
        across concurrent callers, not just within one roll."""
        if not self._reload_fleet_lock.acquire(blocking=False):
            return {
                "ok": False,
                "corpus": corpus,
                "fingerprint": None,
                "rolled_back": False,
                "error": "fleet_reload_in_progress",
                "workers": {},
            }
        try:
            return self._reload_fleet_locked(
                corpus,
                timeout_s=timeout_s,
                health_timeout_s=health_timeout_s,
                failure_budget=failure_budget,
                rollback=rollback,
                argv_patch=argv_patch,
            )
        finally:
            self._reload_fleet_lock.release()

    def _reload_fleet_locked(
        self,
        corpus: str,
        *,
        timeout_s: float,
        health_timeout_s: float,
        failure_budget: int,
        rollback: bool,
        argv_patch,
    ) -> dict:
        if argv_patch is None:
            argv_patch = self.patch_corpus_argv
        results: dict[str, dict] = {}
        succeeded: list[tuple[str, str | None, list[str]]] = []
        failures = 0
        target_fp: str | None = None
        out = {
            "ok": True,
            "corpus": corpus,
            "fingerprint": None,
            "rolled_back": False,
            "workers": results,
        }
        for name in list(self.workers):
            handle = self.workers[name]
            if handle.state == STOPPED:
                results[name] = {"skipped": "stopped"}
                continue
            before = self.probe(name) or {}
            old_source = (before.get("corpus") or {}).get("source")
            row = None
            error = None
            try:
                row = oneshot(
                    handle.socket_path,
                    {"op": "reload", "corpus": corpus},
                    timeout_s,
                )
            except WireError as exc:
                error = f"reload transport failed: {exc}"
            if row is not None:
                reload_row = row.get("reload")
                if isinstance(reload_row, dict) and reload_row.get("ok"):
                    fp = reload_row.get("fingerprint")
                    target_fp = fp or target_fp
                    if self._await_fingerprint(name, fp, health_timeout_s):
                        results[name] = {"ok": True, "fingerprint": fp}
                        old_argv = list(handle.argv)
                        with self._lock:
                            handle.argv = argv_patch(handle.argv, corpus)
                        succeeded.append((name, old_source, old_argv))
                        continue
                    error = (
                        f"worker unhealthy (or on the wrong fingerprint) "
                        f"{health_timeout_s}s after reload"
                    )
                else:
                    error = str(
                        row.get("error") or f"unexpected response: {row}"
                    )
            failures += 1
            results[name] = {"ok": False, "error": error}
            if failures > failure_budget:
                out["ok"] = False
                if rollback and succeeded:
                    out["rolled_back"] = True
                    self._rollback(succeeded, results, timeout_s)
                break
        out["fingerprint"] = None if out["rolled_back"] else target_fp
        if out["ok"] and failures:
            out["ok"] = False  # within budget, but not a clean roll
        return out

    def _rollback(
        self,
        succeeded: list[tuple[str, str | None, list[str]]],
        results: dict,
        timeout_s: float,
    ) -> None:
        """Return every already-reloaded worker to its pre-roll corpus
        (newest first, mirroring the forward order) and restore its
        respawn argv."""
        for name, old_source, old_argv in reversed(succeeded):
            handle = self.workers.get(name)
            if handle is None:
                continue
            with self._lock:
                handle.argv = old_argv
            entry = results.get(name) or {}
            if not old_source:
                entry["rolled_back"] = False
                entry["rollback_error"] = (
                    "previous corpus source unknown; restart will "
                    "restore it from argv"
                )
                results[name] = entry
                continue
            try:
                row = oneshot(
                    handle.socket_path,
                    {"op": "reload", "corpus": old_source},
                    timeout_s,
                )
                ok = bool(
                    isinstance(row.get("reload"), dict)
                    and row["reload"].get("ok")
                )
                entry["rolled_back"] = ok
                if not ok:
                    entry["rollback_error"] = str(row.get("error") or row)
            except WireError as exc:
                entry["rolled_back"] = False
                entry["rollback_error"] = str(exc)
            results[name] = entry

    # -- introspection --

    def status(self) -> dict:
        with self._lock:
            return {
                name: handle.as_dict()
                for name, handle in self.workers.items()
            }

    def host_health(self) -> dict:
        """The host-level health verdict for the federation tier: this
        supervisor's whole worker domain, summarized the way a FRONT
        router (or an operator) wants it — how many replicas exist,
        how many are answering probes, and whether the domain can take
        new work at all.  Rides the router's ``stats`` verb, so a
        cross-host probe sees domain health in one round trip."""
        with self._lock:
            handles = list(self.workers.values())
            healthy = sum(1 for h in handles if h.state == HEALTHY)
            dispatchable = sum(
                1
                for h in handles
                if not h.draining and h.state not in (STOPPED, DOWN)
            )
            restarts = sum(h.restarts for h in handles)
        return {
            "workers": len(handles),
            "healthy": healthy,
            "dispatchable": dispatchable,
            "restarts": restarts,
            "serving": dispatchable > 0,
        }


def kill_worker(handle: WorkerHandle) -> None:
    """SIGKILL a supervised worker — the crash fault (faults.py rides
    this same path for real processes)."""
    proc = handle.proc
    if proc is not None and proc.poll() is None:
        proc.kill()


def hang_worker(handle: WorkerHandle) -> None:
    """SIGSTOP — the wedge fault: the process stays alive but stops
    answering probes, exercising the supervisor's wedged path."""
    if handle.pid is not None:
        os.kill(handle.pid, signal.SIGSTOP)


def resume_worker(handle: WorkerHandle) -> None:
    if handle.pid is not None:
        os.kill(handle.pid, signal.SIGCONT)
