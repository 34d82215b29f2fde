"""Dynamic micro-batching scheduler: the online front end of the device
scorer.

The port's copy of `licensee_tpu/serve/scheduler.py`.  Requests arrive
one at a time (JSONL transport, serve/server.py); the card wants them
gathered into batches, each one launch of K1 (`dice_cuda.
best_match_fused`), or with ``--method matmul`` K2 plus the score
algebra and the argmax, on the dispatch stream.  The MicroBatcher
bridges the two:

  admission (caller's thread)
    route -> content-hash cache probe -> host prefilter + featurize
    (serve/featurize.py — the SAME chain as the offline pipeline).
    Cache hits and host-finished rows (Copyright/Exact, package
    matchers, unrouted filenames) answer immediately; only Dice-bound
    rows ever occupy a queue slot.  A full queue rejects WITH
    ``retry_after`` instead of buffering unboundedly — explicit
    backpressure beats silent latency collapse.

  scheduling (one background thread)
    Dice-bound rows coalesce until either ``max_batch`` rows are
    waiting (flush reason "full") or the OLDEST row has waited
    ``max_delay_ms`` (flush reason "deadline" — bounded latency for a
    partial batch).  The gathered rows merge via the kernels/batch.py
    packers (merge_prepared) and SUBMIT asynchronously
    (``dispatch_chunks_async``) with the smallest fitting BUCKET as
    the chunk capacity, so the pinned staging slots and the dispatch
    stats' shapes are the fixed bucket list, never per-request; the
    kernel itself launches at the flush's real row count.  The submit
    path never blocks on the device: the scheduler thread goes
    straight back to gathering the next flush while the device scores
    this one.

  completion (one background thread)
    Submitted groups ride a handoff queue to the completion thread,
    bounded by an in-flight semaphore (``pipeline_depth`` permits,
    held from submit until the group is fully answered — the overlap
    pipeline's backpressure; depth 1 is the synchronous flush),
    which awaits each DeviceFuture, finishes scores, fills the cache,
    releases coalesced followers, and fires the requests' ``done``
    events.  In steady state the await is a no-op: the device finished
    while the scheduler was gathering flush N+1.

  degradation
    A request whose own deadline expired while queued answers
    ``deadline_exceeded`` instead of occupying a device slot.  A device
    submit (or its future) that raises is counted under ``fallbacks``.
    On the CPU its requests fall back to the host scoring of their
    admitted corpus epoch (serve/reload.py ``host_best``, reference
    semantics), as the reference does.  On the card each answers a
    ``device_error`` row instead: a failing kernel is never hidden
    behind host verdicts that equal its own.
"""

from __future__ import annotations

import math
import os
import queue as queue_mod
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

import licensee_tpu_torch
from licensee_tpu_torch.corpus.artifact import short_fingerprint
from licensee_tpu_torch.kernels.batch import BlobResult
from licensee_tpu_torch.obs import (
    NativeProfileSource,
    Observability,
    PipelineLanes,
    SLOEngine,
    serve_objectives,
)
from licensee_tpu_torch.serve.cache import ResultCache
from licensee_tpu_torch.serve.featurize import (
    UNROUTED,
    content_key,
    featurize_request,
)
from licensee_tpu_torch.serve.stats import StageStats

STAGES = ("cache_probe", "featurize", "queue_wait", "device", "total")


def _on_card(clf) -> bool:
    """Whether ``clf`` scores on a CUDA device (its tensors on the card)."""
    device = getattr(clf, "device", None)
    return device is not None and device.type == "cuda"


class BatcherClosedError(RuntimeError):
    """submit() after close(): with no scheduler left to flush, a
    queued request would hang its waiter forever — refuse instead."""


class QueueFullError(RuntimeError):
    """Admission refused: the bounded queue is full.  ``retry_after``
    (seconds) estimates when a slot should free up — the transport
    surfaces it so a well-behaved client backs off instead of
    hammering."""

    def __init__(self, retry_after: float, trace_id: str | None = None):
        self.retry_after = retry_after
        self.trace_id = trace_id  # echoed on the backpressure row
        super().__init__(
            f"queue full; retry after {retry_after:.3f}s"
        )


@dataclass
class ServeRequest:
    """One in-flight request.  ``result`` is a BlobResult once ``done``
    is set; ``cached`` marks a content-hash cache hit."""

    content: bytes
    filename: str | None
    route: str | None
    request_id: object = None
    deadline: float | None = None  # absolute perf_counter seconds
    created: float = 0.0
    enqueued_at: float = 0.0
    prepared: object = None  # size-1 PreparedBatch while Dice-bound
    cache_key: object = None
    # the classifier epoch this request was admitted under: featurized
    # with ITS vocab, scored against ITS matrix — a reload swapping the
    # active epoch mid-flight must never mix the two (the fence that
    # makes every response attributable to exactly one corpus)
    clf: object = None
    corpus_fp: str | None = None
    result: BlobResult | None = None
    cached: bool = False
    # concurrent duplicates of this request (same content key, admitted
    # while this one was still in flight): they ride this row's device
    # slot and inherit its result — the online twin of the offline
    # pipeline's in-batch dedupe
    followers: list = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    # the request's Trace (obs/tracing.py) — None when tracing is off
    trace: object = None

    @property
    def trace_id(self) -> str | None:
        return self.trace.trace_id if self.trace is not None else None

    def wait(self, timeout: float | None = None) -> BlobResult:
        if not self.done.wait(timeout):
            raise TimeoutError("request not finished")
        return self.result


class MicroBatcher:
    """Request queue + dynamic micro-batcher over a BatchClassifier.

    ``classifier`` defaults to a fresh BatchClassifier on ``device``
    (the card unless the caller asks for the CPU; with no card, building
    one raises); pass one to share a warmed-up scorer.  ``mesh`` (None,
    ``"auto"``, ``(n_data, n_model)`` or a `parallel.mesh.DeviceMesh`)
    splits each flush over several devices (K5); the buckets then round
    up to the data axis.  ``buckets`` is
    the ascending tuple of chunk capacities; by default a x4 geometric
    ladder up to ``max_batch`` (each bucket's staging is set up once,
    the ladder keeps the slot's spare rows under 4x for any batch
    size)."""

    def __init__(
        self,
        classifier=None,
        *,
        corpus=None,
        method: str = "auto",
        mode: str = "license",
        mesh=None,
        max_batch: int = 256,
        max_delay_ms: float = 5.0,
        queue_depth: int = 1024,
        cache_entries: int = 65536,
        cache_bytes: int | None = None,
        deadline_ms: float = 0.0,
        threshold: float | None = None,
        buckets: tuple[int, ...] | None = None,
        start: bool = True,
        pipeline_depth: int = 2,
        warm_start: bool = False,
        registry=None,
        tracing: bool = True,
        trace_sample: float = 0.01,
        trace_slow_ms: float = 250.0,
        trace_log: str | None = None,
        trace_proc: str = "local",
        flight=None,
        corpus_source: str | None = None,
        device="cuda",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch!r}")
        if not (max_delay_ms >= 0):  # rejects negatives AND NaN
            raise ValueError(
                f"max_delay_ms must be >= 0, got {max_delay_ms!r}"
            )
        if queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {queue_depth!r}"
            )
        if classifier is None:
            from licensee_tpu_torch.kernels.batch import BatchClassifier

            classifier = BatchClassifier(
                corpus=corpus,
                method=method,
                mode=mode,
                pad_batch_to=max_batch,
                device=device,
                mesh=mesh,
            )
        # the active corpus epoch: (classifier, fingerprint), swapped
        # ATOMICALLY (one attribute assignment under the lock) by
        # reload_corpus.  Every request snapshots the pair once at
        # admission; the scheduler scores each request with the epoch
        # it was featurized under, so a swap can never mix vocabularies
        # and matrices inside one verdict.
        # getattr: unit tests drive the scheduler with minimal fake
        # classifiers that carry no corpus at all
        fp = None
        if getattr(classifier, "corpus", None) is not None:
            from licensee_tpu_torch.corpus.artifact import corpus_fingerprint

            fp = corpus_fingerprint(classifier.corpus)
        self._active = (classifier, fp)
        self._seen_fps = {fp} if fp else set()
        self._corpus_source = corpus_source
        self._method_arg = method  # re-resolved per reload (e.g. "auto")
        self._reload_lock = threading.Lock()
        self.mode = classifier.mode
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1000.0
        self.queue_depth = int(queue_depth)
        self.deadline_ms = float(deadline_ms)
        self.threshold = (
            licensee_tpu_torch.confidence_threshold()
            if threshold is None
            else float(threshold)
        )
        self.cache = ResultCache(cache_entries, max_bytes=cache_bytes)
        self.buckets = self._resolve_buckets(buckets)
        # -- observability: one registry + tracer per batcher.  The
        # fresh default registry keeps repeated instances (tests,
        # notebooks) from shadowing each other's serve_* gauges; the
        # serve_* families assume ONE batcher per registry (the process
        # doctrine), so share a registry only across non-overlapping
        # sources --
        self.obs = Observability(
            registry,
            tracing=tracing,
            trace_sample=trace_sample,
            trace_slow_ms=trace_slow_ms,
            trace_log=trace_log,
            trace_proc=trace_proc,
        )
        # the worker flight recorder (obs/flight.py): event hooks below
        # append to its lock-free ring; None keeps every hook a single
        # attribute read + is-None branch
        self.flight = flight
        stage_hist = self.obs.registry.histogram(
            "serve_stage_seconds",
            "Serve-path per-stage latency (one fixed-bound histogram "
            "per stage, fed by the same clock reads as the reservoirs)",
            labels=("stage",),
        )
        self.stats_stages = StageStats(
            STAGES,
            observer=lambda s, dt, ex=None: stage_hist.labels(
                stage=s
            ).observe(dt, exemplar=ex),
        )
        self._queue: deque[ServeRequest] = deque()
        # content key -> the queued primary request: a duplicate
        # arriving while its twin is still queued attaches as a
        # follower instead of occupying a second device slot (the cache
        # only learns a result at flush time, so without this every
        # duplicate inside one flush window would re-score)
        self._inflight: dict = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._running = False
        self._paused = False
        self._closed = False
        self._batch_ewma: float | None = None  # seconds per device batch
        self._counters = {
            "submitted": 0,
            "completed": 0,
            "cache_hits": 0,
            "coalesced": 0,
            "prefiltered": 0,
            "unrouted": 0,
            "device_batches": 0,
            "device_rows": 0,
            "padded_rows": 0,
            "rejected": 0,
            "expired": 0,
            "fallbacks": 0,
            "completion_errors": 0,
            "reloads": 0,
            "reload_failed": 0,
            "reload_rejected": 0,
        }
        self._flush_reasons = {"full": 0, "deadline": 0, "drain": 0}
        self._bucket_counts: dict[int, int] = {}
        self._thread: threading.Thread | None = None
        # -- the overlap pipeline: submitted device groups ride this
        # queue to the completion thread.  The bound is the SEMAPHORE,
        # not the queue: a permit is acquired before each async submit
        # and released only after the completion lane fully finishes
        # the group, so at most ``pipeline_depth`` groups are ever
        # submitted-but-unfinished — depth 1 really is one flush in
        # flight (the synchronous behavior, finished on the completion
        # thread), and the scheduler blocks on the permit (never on
        # the device itself) --
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth!r}"
            )
        self.pipeline_depth = int(pipeline_depth)
        self._device_q: queue_mod.Queue = queue_mod.Queue()
        self._inflight_sem = threading.Semaphore(self.pipeline_depth)
        self._completion: threading.Thread | None = None
        # serve-side lane clocks: featurize (admission), device
        # (submit -> future resolved), writer (response finishing on
        # the completion thread) + the in-flight-chunks gauge
        self._lanes = PipelineLanes().register(self.obs.registry)
        self._warm_start = bool(warm_start)
        self._register_metrics()
        # the SLO engine rides the registry's collector pass; attached
        # AFTER _register_metrics so every evaluation sees counters the
        # scheduler collector just synced (obs/slo.py)
        self.slo = SLOEngine(
            self.obs.registry, serve_objectives()
        ).attach()
        if self._warm_start:
            # cold-start fix: set up every bucket shape NOW (the kernel
            # library's load, the first launch, each bucket's pinned
            # staging slot), not on the first live request that happens
            # to flush at it (the per-shape cost lands in
            # dispatch_stats()["per_shape"])
            self.warmup()
        if start:
            self.start()

    @property
    def classifier(self):
        """The ACTIVE classifier (current corpus epoch).  A bare tuple
        read: the epoch pair is replaced atomically, and every consumer
        that must stay consistent across several reads (submit, the
        flush loop) snapshots ``_active`` once instead of re-reading.
        """
        # epoch handoff, not shared mutable state: _active is replaced
        # wholesale under the lock and this single read is atomic — a
        # reader sees the old pair or the new pair, never a mix
        return self._active[0]

    @classifier.setter
    def classifier(self, clf) -> None:
        fp = None
        if getattr(clf, "corpus", None) is not None:
            from licensee_tpu_torch.corpus.artifact import corpus_fingerprint

            fp = corpus_fingerprint(clf.corpus)
        with self._lock:
            self._active = (clf, fp)
            if fp:
                self._seen_fps.add(fp)

    @property
    def corpus_fingerprint(self) -> str | None:
        """The active corpus fingerprint (None for corpus-free modes)."""
        # same single-atomic-read epoch handoff as `classifier` above
        return self._active[1]

    def _register_metrics(self) -> None:
        """Wire every serve-path stat into the obs registry: live
        gauges pull at scrape time, and one collector syncs the
        scheduler/cache/device/native counter dicts — the subsystems
        keep their cheap ad-hoc increments and the registry absorbs
        them per scrape."""
        reg = self.obs.registry
        reg.gauge(
            "serve_queue_depth", "Dice-bound requests waiting right now"
        ).set_fn(lambda: len(self._queue))
        reg.gauge(
            "serve_in_flight",
            "Queued primaries still owning a device slot (coalesce keys)",
        ).set_fn(lambda: len(self._inflight))
        reg.gauge(
            "serve_queue_capacity", "Bounded admission queue size"
        ).set(self.queue_depth)
        self.cache.register_metrics(reg)
        events = reg.counter(
            "serve_requests_total",
            "Scheduler lifecycle events by kind (submitted, completed, "
            "cache_hits, coalesced, prefiltered, unrouted, rejected, "
            "expired, fallbacks, ...)",
            labels=("event",),
        )
        flush = reg.counter(
            "serve_flush_total",
            "Micro-batch flushes by reason (full / deadline / drain)",
            labels=("reason",),
        )
        bucket = reg.counter(
            "serve_bucket_flush_total",
            "Device flushes by padded bucket shape",
            labels=("bucket",),
        )
        disp_n = reg.counter(
            "device_dispatch_total",
            "Device dispatches split compile (first dispatch of a "
            "shape: the kernel library's load, the first launch, the "
            "pinned staging) vs execute (steady state)",
            labels=("phase",),
        )
        disp_s = reg.counter(
            "device_dispatch_seconds_total",
            "Seconds in device dispatch by phase (compile vs execute)",
            labels=("phase",),
        )
        traces = reg.counter(
            "trace_events_total",
            "Tracer retention events (started / retained / slow)",
            labels=("event",),
        )
        corpus_info = reg.gauge(
            "serve_corpus_info",
            "Active corpus fingerprint (1 on the serving fingerprint "
            "label, 0 on fingerprints this worker served before)",
            labels=("fingerprint",),
        )
        NativeProfileSource(reg)

        def collect(_reg) -> None:
            with self._lock:
                counters = dict(self._counters)
                flush_now = dict(self._flush_reasons)
                buckets_now = dict(self._bucket_counts)
                active_fp = self._active[1]
                seen_fps = set(self._seen_fps)
            for fp in seen_fps:
                corpus_info.labels(
                    fingerprint=short_fingerprint(fp)
                ).set(1.0 if fp == active_fp else 0.0)
            for k, v in counters.items():
                events.labels(event=k).sync(v)
            for k, v in flush_now.items():
                flush.labels(reason=k).sync(v)
            for b, v in buckets_now.items():
                bucket.labels(bucket=b).sync(v)
            dstats = getattr(self.classifier, "dispatch_stats", None)
            if callable(dstats):
                d = dstats()
                disp_n.labels(phase="compile").sync(d["compiles"])
                disp_n.labels(phase="execute").sync(d["dispatches"])
                disp_s.labels(phase="compile").sync(d["compile_s"])
                disp_s.labels(phase="execute").sync(d["dispatch_s"])
            t = self.obs.tracer.stats()
            for k in ("started", "retained", "slow"):
                traces.labels(event=k).sync(t[k])

        reg.add_collector(collect)

    def _resolve_buckets(self, buckets) -> tuple[int, ...]:
        if buckets is None:
            ladder = []
            b = 8
            while b < self.max_batch:
                ladder.append(b)
                b *= 4
            ladder.append(self.max_batch)
            buckets = ladder
        out = sorted({int(b) for b in buckets})
        if not out or out[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        if out[-1] < self.max_batch:
            # a full flush must fit the largest bucket
            out.append(self.max_batch)
        mesh = getattr(self.classifier, "mesh", None)
        if mesh is not None:
            # a dispatch's chunk capacity must divide across the data
            # axis (max_batch included)
            n_data = mesh.shape["data"]
            out = sorted({-(-b // n_data) * n_data for b in out})
        return tuple(out)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits n rows (the largest bucket is
        >= max_batch, and a flush never gathers more than max_batch)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    # -- lifecycle --

    def start(self) -> None:
        with self._cond:
            if self._running:
                return
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name="micro-batcher", daemon=True
            )
            self._completion = threading.Thread(
                target=self._completion_loop,
                name="micro-batcher-completion",
                daemon=True,
            )
            self._thread.start()
            self._completion.start()

    def warmup(self, classifier=None) -> dict:
        """Set up every bucket shape on ``classifier`` (the active one
        by default) so no live request pays it: one one-row probe
        dispatch per bucket through the real device path, which loads
        (building it if stale) the kernel library, launches the scorer
        once and allocates the bucket's pinned staging slot.  Used at
        startup (``warm_start=True``) and on the candidate classifier of
        a corpus reload BEFORE the swap — the old corpus serves while
        the new one warms.  Returns the classifier's per-shape set-up
        attribution (also permanently visible in
        ``stats()["device"]["per_shape"]``).  No-op for host-only /
        corpus-free classifiers."""
        clf = classifier if classifier is not None else self.classifier
        if (
            getattr(clf, "_scorer", None) is None
            or getattr(clf, "corpus", None) is None
        ):
            return {}
        from licensee_tpu_torch.kernels.batch import PreparedBatch

        W = clf.corpus.n_lanes
        probe = PreparedBatch(
            results=[None],
            bits=np.zeros((1, W), dtype=np.uint32),
            n_words=np.zeros(1, dtype=np.int32),
            lengths=np.zeros(1, dtype=np.int32),
            cc_fp=np.zeros(1, dtype=bool),
            todo=[0],
            sections=None,
            compact=True,
        )
        for bucket in self.buckets:
            clf.dispatch_chunks_async(probe, pad_to=bucket).result()
        stats = clf.dispatch_stats()
        return {
            "shapes": stats["shapes"],
            "per_shape": stats["per_shape"],
        }

    def close(self) -> None:
        """Stop accepting, drain the queue (every queued request still
        answers), and join the scheduler + completion threads."""
        with self._cond:
            self._closed = True  # later submits raise instead of hanging
            if not self._running:
                # never started: drain synchronously
                leftovers = list(self._queue)
                self._queue.clear()
            else:
                leftovers = None
                self._running = False
                self._cond.notify_all()
        if leftovers is not None:
            while leftovers:
                self._flush(leftovers[: self.max_batch], "drain")
                leftovers = leftovers[self.max_batch :]
            return
        if self._thread is not None:
            # scheduler first (its final drain still submits groups),
            # then the sentinel lets the completion thread finish the
            # tail of the pipeline and exit
            self._thread.join()
            self._thread = None
        if self._completion is not None:
            self._device_q.put(None)
            self._completion.join()
            self._completion = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def pause(self) -> None:
        """Stop draining the queue (admission continues until it
        fills).  Operational valve — and the deterministic way for
        tests to exercise the backpressure path."""
        with self._cond:
            self._paused = True
            self._cond.notify_all()

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    # -- corpus lifecycle (blue/green reload) --

    def reload_corpus(self, source: str) -> dict:
        """Validated blue/green corpus swap: build a full replacement
        classifier for ``source`` (vendored / spdx / SPDX dir / corpus
        artifact), run the validation gate, and only then swap the
        active epoch — one atomic assignment between scheduler batches.

        On ANY failure (unloadable source, compile error, corrupt
        artifact, parity-probe mismatch) the old corpus keeps serving
        and the error is raised: ReloadInProgressError for a concurrent
        reload (rejected deterministically, never queued), otherwise
        ReloadRejectedError with the problem list.

        In-flight requests finish under the epoch they were admitted
        with; the result cache is fenced by fingerprint, so a pre-swap
        verdict can never answer a post-swap request."""
        from licensee_tpu_torch.serve import reload as reload_mod

        if getattr(self.classifier, "corpus", None) is None:
            raise reload_mod.ReloadRejectedError(
                [f"mode {self.mode!r} is host-only; there is no corpus "
                 "to reload"]
            )
        if not self._reload_lock.acquire(blocking=False):
            with self._lock:
                self._counters["reload_rejected"] += 1
            raise reload_mod.ReloadInProgressError(
                "a reload is already in progress"
            )
        try:
            t0 = time.perf_counter()
            try:
                new_clf = reload_mod.build_classifier_like(
                    self.classifier, source, method=self._method_arg
                )
                problems = reload_mod.validate_classifier(new_clf)
            except reload_mod.ReloadError:
                with self._lock:
                    self._counters["reload_failed"] += 1
                raise
            if problems:
                with self._lock:
                    self._counters["reload_failed"] += 1
                raise reload_mod.ReloadRejectedError(problems)
            if self._warm_start:
                # set up EVERY bucket shape on the candidate while the
                # old corpus is still serving: the first post-swap flush
                # of any bucket must be a steady-state enqueue, never a
                # set-up cliff (validate_classifier only warmed the
                # full-batch probe shape)
                self.warmup(new_clf)
            new_fp = reload_mod.corpus_fingerprint(new_clf.corpus)
            with self._cond:
                if self._closed:
                    raise BatcherClosedError(
                        "batcher closed during reload"
                    )
                old_fp = self._active[1]
                self._active = (new_clf, new_fp)
                self._seen_fps.add(new_fp)
                self._corpus_source = source
                self._counters["reloads"] += 1
            if self.flight is not None:
                self.flight.record(
                    "reload_swap", fingerprint=new_fp, previous=old_fp,
                )
            return {
                "ok": True,
                "fingerprint": new_fp,
                "previous": old_fp,
                "unchanged": new_fp == old_fp,
                "source": source,
                "templates": new_clf.corpus.n_templates,
                "elapsed_s": round(time.perf_counter() - t0, 3),
            }
        finally:
            self._reload_lock.release()

    # -- admission --

    def submit(
        self,
        content: bytes | str,
        filename: str | None = None,
        request_id=None,
        deadline_ms: float | None = None,
        trace_id: str | None = None,
    ) -> ServeRequest:
        """Admit one request.  Returns a ServeRequest whose ``done``
        event fires when ``result`` is set — immediately for cache hits
        and host-finished rows.  Raises QueueFullError when the bounded
        queue cannot take another Dice-bound row.  ``trace_id`` adopts
        an upstream hop's trace ID (the fleet router's) instead of
        minting one, joining the two processes' trace tails."""
        t0 = time.perf_counter()
        raw = (
            content
            if isinstance(content, bytes)
            else str(content).encode("utf-8", errors="ignore")
        )
        filename = os.path.basename(filename) if filename else None
        # ONE epoch snapshot per request: this classifier featurizes
        # AND scores it, and this fingerprint fences its cache key — a
        # reload swapping the active epoch mid-admission cannot split a
        # request across two corpora
        with self._lock:
            clf, corpus_fp = self._active
        route = (
            clf.route_for(filename)
            if self.mode == "auto"
            else self.mode
        )
        req = ServeRequest(
            content=raw,
            filename=filename,
            route=route,
            request_id=request_id,
            created=t0,
            clf=clf,
            corpus_fp=corpus_fp,
        )
        # trace minted (or adopted) at admission: its ID follows the
        # request through every span below and is echoed on the response
        trace = self.obs.tracer.start(request_id, trace_id=trace_id)
        if trace is not None:
            req.trace = trace
        ms = self.deadline_ms if deadline_ms is None else deadline_ms
        if ms and ms > 0:
            req.deadline = t0 + ms / 1000.0
        with self._lock:
            self._counters["submitted"] += 1
        flight = self.flight
        if flight is not None:
            flight.record(
                "admission", id=request_id, route=route,
                trace=req.trace_id,
            )
        if route is None:
            # auto mode, a filename no score table claims: answered
            # without reading a byte, same as the offline path
            with self._lock:
                self._counters["unrouted"] += 1
            return self._finish_local(req, UNROUTED, t0, "unrouted")
        # the cache key is FENCED by corpus fingerprint: a verdict
        # computed under one corpus can never answer a request admitted
        # under another, so a reload invalidates the whole pre-swap
        # cache by construction (stale entries age out via LRU)
        key = (corpus_fp, content_key(route, filename, raw))
        t_probe = time.perf_counter()
        cached = self.cache.get(key)
        dt_probe = time.perf_counter() - t_probe
        self.stats_stages.record("cache_probe", dt_probe)
        if trace is not None:
            trace.add_span("cache_probe", dt_probe, t0=t_probe)
        if cached is not None:
            with self._lock:
                self._counters["cache_hits"] += 1
            req.cached = True
            return self._finish_local(req, cached, t0, "cache_hit")
        req.cache_key = key
        # early coalesce: a duplicate of a QUEUED request skips even
        # featurization — it inherits the primary's verdict at flush
        with self._cond:
            primary = self._inflight.get(key)
            if primary is not None:
                primary.followers.append(req)
                self._counters["coalesced"] += 1
                return req
        t_feat = time.perf_counter()
        with self._lanes.lane("featurize"):
            prepared = featurize_request(
                clf, raw, filename,
                route if self.mode == "auto" else None,
            )
        dt_feat = time.perf_counter() - t_feat
        self.stats_stages.record("featurize", dt_feat)
        if trace is not None:
            trace.add_span("featurize", dt_feat, t0=t_feat)
        req.prepared = prepared
        host_result = prepared.results[0]
        if host_result is not None:
            # prefiltered (Copyright/Exact), package-matched, featurize
            # error, or a README with no license section: never occupies
            # a device slot
            if not host_result.error:
                self.cache.put(key, host_result)
            with self._lock:
                self._counters["prefiltered"] += 1
            return self._finish_local(req, host_result, t0, "prefiltered")
        late = None
        with self._cond:
            primary = self._inflight.get(key)
            if primary is not None:
                # a twin was enqueued while this thread featurized
                primary.followers.append(req)
                self._counters["coalesced"] += 1
                return req
            # the flush loop caches a result BEFORE unregistering its
            # request, so "not in _inflight" + this re-probe together
            # leave no window where a duplicate misses both
            late = self.cache.get(key, record_miss=False)
            if late is None:
                if self._closed:
                    self.obs.tracer.finish(trace, "closed")
                    raise BatcherClosedError("batcher is closed")
                if len(self._queue) >= self.queue_depth:
                    self._counters["rejected"] += 1
                    self.obs.tracer.finish(trace, "queue_full")
                    if self.flight is not None:
                        self.flight.record(
                            "error", what="queue_full", id=request_id
                        )
                    raise QueueFullError(
                        self._estimate_retry_after(), req.trace_id
                    )
                req.enqueued_at = time.perf_counter()
                self._queue.append(req)
                self._inflight[key] = req
                self._cond.notify_all()
        if late is not None:
            with self._lock:
                self._counters["cache_hits"] += 1
            req.cached = True
            return self._finish_local(req, late, t0, "cache_hit")
        return req

    def classify(
        self,
        content: bytes | str,
        filename: str | None = None,
        timeout: float | None = 60.0,
    ) -> BlobResult:
        """Blocking convenience: submit + wait."""
        return self.submit(content, filename).wait(timeout)

    def _finish_local(self, req, result, t0, status: str = "ok") -> ServeRequest:
        req.result = result
        with self._lock:
            self._counters["completed"] += 1
        self.stats_stages.record(
            "total", time.perf_counter() - t0, exemplar=req.trace_id
        )
        if req.trace is not None:
            self.obs.tracer.finish(req.trace, status)
        req.done.set()
        return req

    def _estimate_retry_after(self) -> float:
        """How long until a queue slot frees: batches ahead x the EWMA
        device-batch service time, plus one flush delay.  Called with
        the lock held."""
        per_batch = self._batch_ewma or self.max_delay or 0.005
        batches_ahead = max(
            1, math.ceil(len(self._queue) / self.max_batch)
        )
        return round(batches_ahead * per_batch + self.max_delay, 3)

    # -- the scheduler thread --

    def _loop(self) -> None:
        while True:
            batch: list[ServeRequest] = []
            reason = "drain"
            with self._cond:
                while self._running and (
                    self._paused or not self._queue
                ):
                    self._cond.wait()
                if not self._running and not self._queue:
                    return
                while self._running and not self._paused:
                    if len(self._queue) >= self.max_batch:
                        reason = "full"
                        break
                    wait = (
                        self._queue[0].enqueued_at
                        + self.max_delay
                        - time.perf_counter()
                    )
                    if wait <= 0:
                        reason = "deadline"
                        break
                    self._cond.wait(wait)
                if self._paused and self._running:
                    continue
                n = min(self.max_batch, len(self._queue))
                for _ in range(n):
                    batch.append(self._queue.popleft())
            if batch:
                self._flush(batch, reason)

    def _flush(self, batch: list[ServeRequest], reason: str) -> None:
        """One gathered micro-batch: record waits, SUBMIT the live rows
        per classifier epoch (non-blocking), answer the fully-expired
        rows, and hand the in-flight groups to the completion thread.
        The scheduler thread never waits on the device here — only,
        briefly, on an in-flight permit when ``pipeline_depth``
        flushes are already submitted and unfinished."""
        t0 = time.perf_counter()

        def unexpired(r: ServeRequest) -> bool:
            return r.deadline is None or t0 <= r.deadline

        # a row is scored if ANY of its members (primary or coalesced
        # followers) can still use the verdict — a follower with a
        # longer (or no) deadline must not inherit its twin's expiry
        live: list[ServeRequest] = []
        for req in batch:
            # ownership handoff, not a race: the scheduler thread
            # popped req from the queue under the SAME lock submit()
            # held when it wrote enqueued_at, and a dequeued request's
            # fields belong to the scheduler/completion pair alone
            # until done.set()
            # analysis: disable=lock-discipline
            enq = req.enqueued_at or req.created
            wait = t0 - enq
            self.stats_stages.record("queue_wait", wait)
            if req.trace is not None:
                req.trace.add_span("queue_wait", wait, t0=enq)
            with self._lock:
                alive = unexpired(req) or any(
                    unexpired(f) for f in req.followers
                )
            if alive:
                live.append(req)
        pends: list[dict] = []
        if live:
            # one device batch PER CLASSIFIER EPOCH: rows admitted
            # before a corpus reload were featurized under the old
            # vocab and must score against the old matrix; rows after,
            # the new.  In steady state there is exactly one group —
            # the partition costs a dict build, not a dispatch.
            by_clf: dict[int, list[ServeRequest]] = {}
            for req in live:
                by_clf.setdefault(id(req.clf), []).append(req)
            for grp in by_clf.values():
                # the pipeline bound, taken BEFORE the async submit:
                # at most pipeline_depth groups submitted-but-
                # unfinished, so depth 1 means the previous flush is
                # fully answered before this one touches the device
                self._inflight_sem.acquire()
                pends.append(self._submit_group(grp, t0))
            with self._lock:
                self._flush_reasons[reason] += 1
            if self.flight is not None:
                self.flight.record(
                    "flush", reason=reason, rows=len(live),
                    groups=len(pends),
                )
        # rows every member of which already expired: answered now,
        # without ever occupying a device slot
        live_ids = {id(r) for r in live}
        dead = [r for r in batch if id(r) not in live_ids]
        if dead:
            self._finish_requests(dead, t0, time.perf_counter())
        for pend in pends:
            # not a race: start() writes _completion BEFORE the
            # scheduler thread exists, and close() clears it only AFTER
            # joining that thread — the one lock-free read here sees
            # either the live thread or the unstarted-drain None
            # analysis: disable=lock-discipline
            if self._completion is None:
                # unstarted batcher draining in close(): complete inline
                try:
                    self._complete_group(pend)
                finally:
                    self._inflight_sem.release()
            else:
                # the pipeline handoff — never blocks (the semaphore
                # above already bounded the in-flight groups)
                self._device_q.put(pend)

    def _submit_group(self, live: list[ServeRequest], t0: float) -> dict:
        """Merge and ASYNC-submit one classifier-epoch group of a flush
        (every member shares ``req.clf``).  Returns the pending record
        the completion thread finishes; a submit-time failure rides it
        as ``err`` so the fallback runs on the completion lane, not
        here."""
        group = [r.prepared for r in live]
        n = sum(len(p.todo) for p in group)
        bucket = self.bucket_for(n)
        clf = live[0].clf
        merged = future = err = None
        t_sub = time.perf_counter()
        try:
            merged = clf.merge_prepared(group)
            future = clf.dispatch_chunks_async(merged, pad_to=bucket)
            self._lanes.enter("device")
            self._lanes.chunk_inflight(len(future))
        except Exception as exc:  # noqa: BLE001 — device failure containment
            err = exc
            future = None
        if self.flight is not None:
            self.flight.record(
                "device_dispatch", rows=n, bucket=bucket,
                error=str(err)[:200] if err is not None else None,
            )
        return {
            "live": live,
            "merged": merged,
            "future": future,
            "bucket": bucket,
            "n": n,
            "clf": clf,
            "t0": t0,
            # the submit half's cost: added to the completion half's
            # await+finish interval to form the device SERVICE time —
            # never the time the pend sat queued behind earlier flushes
            "submit_s": time.perf_counter() - t_sub,
            "err": err,
        }

    def _completion_loop(self) -> None:
        while True:
            pend = self._device_q.get()
            if pend is None:
                return
            try:
                self._complete_group(pend)
            except BaseException as exc:  # noqa: BLE001 — lane must survive
                # a completion failure must never end this thread: the
                # in-flight permits would never be released, the
                # scheduler would block forever acquiring one, and
                # close() would deadlock behind it.  Answer the group's
                # waiters with an error row and keep draining.
                with self._lock:
                    self._counters["completion_errors"] += 1
                for req in pend["live"]:
                    with self._lock:
                        if self._inflight.get(req.cache_key) is req:
                            del self._inflight[req.cache_key]
                        followers = list(req.followers)
                    for member in (req, *followers):
                        if member.result is None:
                            member.result = BlobResult(
                                None, None, 0.0,
                                error=f"completion_error: {exc}",
                            )
                        member.done.set()
            finally:
                self._inflight_sem.release()

    def _complete_group(self, pend: dict) -> None:
        """Await one submitted group, finish its scores (or run the
        per-request host fallback), fill the cache, and fire ``done``
        for every member — the completion half of the async flush."""
        live: list[ServeRequest] = pend["live"]
        clf = pend["clf"]
        merged = pend["merged"]
        future = pend["future"]
        bucket, n, t0 = pend["bucket"], pend["n"], pend["t0"]
        device_err = pend["err"]
        # service clock starts when THIS group is picked up — the time
        # it spent queued behind earlier flushes is pipeline wait, not
        # device time, and must not inflate the ewma that prices
        # retry_after
        t_begin = time.perf_counter()
        if future is not None:
            try:
                outs = future.result()  # the await — only this lane blocks
                clf.finish_chunks(merged, outs, self.threshold)
                clf.scatter_merged([r.prepared for r in live], merged)
                for req in live:
                    req.result = req.prepared.results[0]
            except Exception as exc:  # noqa: BLE001 — device failure containment
                device_err = exc
            self._lanes.exit_("device")
            self._lanes.chunk_inflight(-len(future))
        if device_err is not None:
            with self._lock:
                self._counters["fallbacks"] += len(live)
        dt_device = pend["submit_s"] + (time.perf_counter() - t_begin)
        if self.flight is not None:
            self.flight.record(
                "device_await", rows=n, bucket=bucket,
                dur_ms=round(dt_device * 1000.0, 3),
                error=(
                    str(device_err)[:200]
                    if device_err is not None else None
                ),
            )
        self.stats_stages.record("device", dt_device)
        with self._lock:
            self._batch_ewma = (
                dt_device
                if self._batch_ewma is None
                else 0.8 * self._batch_ewma + 0.2 * dt_device
            )
        for req in live:
            if req.trace is not None:
                # the batch's device attempt, shared by every rider
                req.trace.add_span(
                    "device", dt_device, t0=t0,
                    note=(
                        f"error: {device_err}" if device_err is not None
                        else f"bucket={bucket} rows={n}"
                    ),
                )
        if device_err is not None and _on_card(clf):
            # a kernel that fails on the card is answered as the error
            # it is: host scoring would give K1's exact verdicts and
            # hide the broken kernel behind correct-looking rows
            for req in live:
                req.result = BlobResult(
                    None, None, 0.0, error=f"device_error: {device_err}"
                )
        elif device_err is not None:
            for req in live:
                t_fb = time.perf_counter()
                req.result = self._scalar_fallback(req)
                if req.trace is not None:
                    req.trace.add_span(
                        "fallback",
                        time.perf_counter() - t_fb,
                        t0=t_fb,
                    )
        with self._lock:
            self._counters["device_batches"] += 1
            self._counters["device_rows"] += n
            self._counters["padded_rows"] += bucket - n
            self._bucket_counts[bucket] = (
                self._bucket_counts.get(bucket, 0) + 1
            )
        self._finish_requests(live, t0, time.perf_counter())

    def _finish_requests(
        self, reqs: list[ServeRequest], t0: float, done_t: float
    ) -> None:
        """Answer a set of flushed requests (scored, fallback-scored,
        or expired) and their coalesced followers.  ``t0`` is the flush
        time the expiry verdicts were frozen at — a member whose
        deadline lapsed DURING device scoring still gets the verdict,
        exactly like the synchronous path did."""

        def unexpired(r: ServeRequest) -> bool:
            return r.deadline is None or t0 <= r.deadline

        with self._lanes.lane("writer"):
            for req in reqs:
                # rows nobody could score kept result=None; scored rows
                # carry the device (or fallback) verdict
                scored = req.result
                if (
                    scored is not None
                    and not scored.error
                    and req.cache_key is not None
                ):
                    self.cache.put(req.cache_key, scored)
                # unregister BEFORE signalling: once the key leaves
                # _inflight no new follower can attach, so the snapshot
                # below is complete
                with self._lock:
                    if self._inflight.get(req.cache_key) is req:
                        del self._inflight[req.cache_key]
                    followers = list(req.followers)
                    self._counters["completed"] += 1 + len(followers)
                for member in (req, *followers):
                    if scored is not None and unexpired(member):
                        # followers inherit the verdict (identical
                        # content key => identical classification) and
                        # count as deduplicated answers, like cache hits
                        member.result = scored
                        member.cached = member is not req
                        status = "coalesced" if member is not req else "ok"
                    else:
                        member.result = BlobResult(
                            None, None, 0.0, error="deadline_exceeded"
                        )
                        status = "deadline_exceeded"
                        with self._lock:
                            self._counters["expired"] += 1
                    self.stats_stages.record(
                        "total", done_t - member.created,
                        exemplar=member.trace_id,
                    )
                    if member.trace is not None:
                        self.obs.tracer.finish(member.trace, status)
                    member.done.set()

    def _scalar_fallback(self, req: ServeRequest) -> BlobResult:
        """Host path for one Dice-bound request — the graceful-
        degradation answer when the device dispatch raised.
        Copyright/Exact already had their turn at admission, so only
        Dice (and the readme Reference fallback) run here.

        Scoring runs the host numpy re-derivation of the device
        algebra (serve/reload.py ``host_best``) over the request's own
        prepared feature row, against the corpus of the ADMITTED
        epoch (``req.clf``) — the verdict a reloaded worker hands out
        must come from the corpus its fingerprint names, never from
        the vendored pool the scalar text matcher iterates.  The
        scalar `licensee-tpu detect` chain remains only for the
        corpus-free case (no fingerprint is stamped there)."""
        section = None
        if req.prepared is not None and req.prepared.sections:
            section = req.prepared.sections[0]
        try:
            clf = req.clf or self.classifier
            corpus = getattr(clf, "corpus", None)
            prepared = req.prepared
            if corpus is not None and prepared is not None and len(
                getattr(prepared, "bits", ())
            ):
                from licensee_tpu_torch.serve.reload import host_best

                ((idx, num, den),) = host_best(
                    corpus,
                    prepared.bits[:1],
                    prepared.n_words[:1],
                    prepared.lengths[:1],
                    prepared.cc_fp[:1],
                )
                score = (num * 200.0) / den if den > 0 else 0.0
                if num >= 0 and score >= self.threshold:
                    return BlobResult(
                        corpus.keys[idx], "dice", float(score), num, den
                    )
            else:
                from licensee_tpu_torch.matchers import Dice
                from licensee_tpu_torch.project_files.license_file import (
                    LicenseFile,
                )

                text = section if section is not None else req.content
                ranked = Dice(
                    LicenseFile(text, req.filename or "LICENSE")
                ).matches_by_similarity
                if ranked and ranked[0][1] >= self.threshold:
                    lic, sim = ranked[0]
                    return BlobResult(lic.key, "dice", float(sim))
            if section is not None:
                lic = clf._reference_match(section)
                if lic is not None:
                    return BlobResult(lic.key, "reference", 90.0)
            return BlobResult(None, None, 0.0)
        except Exception as exc:  # noqa: BLE001 — per-request containment
            return BlobResult(
                None, None, 0.0, error=f"fallback_error: {exc}"
            )

    # -- observability --

    def stats(self) -> dict:
        """The JSON the `stats` control verb dumps: scheduler counters,
        flush reasons, bucket histogram, cache counters, and per-stage
        latency percentiles."""
        with self._lock:
            counters = dict(self._counters)
            counters["queue_depth_now"] = len(self._queue)
            counters["queue_depth"] = counters["queue_depth_now"]
            counters["in_flight"] = len(self._inflight)
            flush = dict(self._flush_reasons)
            bucket_counts = {
                str(k): v for k, v in sorted(self._bucket_counts.items())
            }
            active_clf, active_fp = self._active
            corpus_source = self._corpus_source
        dispatch = getattr(active_clf, "dispatch_stats", None)
        return {
            "uptime_s": self.obs.uptime_s(),
            "corpus": {
                "fingerprint": active_fp,
                "source": corpus_source,
                "templates": (
                    active_clf.corpus.n_templates
                    if getattr(active_clf, "corpus", None) is not None
                    else None
                ),
                "reloads": counters["reloads"],
            },
            "scheduler": {
                **counters,
                "flush": flush,
                "buckets": bucket_counts,
            },
            "cache": self.cache.stats(),
            "latency_ms": self.stats_stages.snapshot(),
            "device": dispatch() if callable(dispatch) else None,
            # the overlap pipeline's live occupancy (featurize lane =
            # admission featurize, device lane = submit -> resolved,
            # writer lane = response finishing) + in-flight chunks
            "pipeline": self._lanes.occupancy(),
            "tracing": self.obs.tracer.stats(),
            # the SLO verdict (multi-window burn rates over the counters
            # above) and the flight recorder's ring accounting — the
            # telemetry-plane stats surface (obs/slo.py, obs/flight.py)
            "slo": self.slo.snapshot(),
            "flight": (
                self.flight.stats() if self.flight is not None else None
            ),
            "config": {
                "mode": self.mode,
                "max_batch": self.max_batch,
                "max_delay_ms": self.max_delay * 1000.0,
                "queue_depth": self.queue_depth,
                "pipeline_depth": self.pipeline_depth,
                "warm_start": self._warm_start,
                "cache_entries": self.cache.capacity,
                "cache_bytes": self.cache.max_bytes,
                "deadline_ms": self.deadline_ms,
                "buckets": list(self.buckets),
                "threshold": self.threshold,
                "trace_sample": self.obs.tracer.sample_rate,
                "trace_slow_ms": (
                    self.obs.tracer.slow_ms
                    if self.obs.tracer.slow_ms != float("inf")
                    else None
                ),
            },
        }

    def prometheus(self) -> str:
        """The Prometheus text exposition for this batcher's registry
        (the `stats` verb's ``format: "prometheus"`` answer)."""
        return self.obs.prometheus()

    def trace_tail(self, n: int = 20) -> list[dict]:
        """The most recent retained traces (sampled heads + slow
        exemplars), oldest first — the `trace` verb's answer."""
        return self.obs.tracer.tail(n)
