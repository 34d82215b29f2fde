"""BatchProject: classify a manifest of blobs into JSONL rows.

The port's counterpart of `licensee_tpu/projects/batch_project.py`, every
mode (license, readme, package, auto), ``closest`` and ``attribution``:
manifest -> read + featurize worker threads (or spawned worker
processes, ``featurize_procs``) -> coalescing of the
device rows of consecutive batches into full device chunks -> up to
``pipeline_depth`` groups in flight on the card (`dispatch_chunks_async`,
`kernels/batch.py`) -> finish -> a writer thread that writes the rows in
manifest order.  The native featurizer drops the GIL for a whole batch,
so the threads featurize in parallel; the card scores group N while the
workers featurize the next ones and the writer drains the one before.
Groups are awaited strictly FIFO and the writer checks their sequence
numbers, so the output is byte-identical at every setting and the line
count is always the completed prefix of the manifest: a run cut at any
point resumes from there (``resume``, with the ``<output>.meta.json``
sidecar that refuses a resume under another configuration).  A
content-hash cache carries results across batches, so a verbatim repeat
of an earlier blob skips featurization and the device.  The rows and
the sidecar are byte-identical to the JAX package's, so either package
resumes the other's partial output.

Manifest entries may address tar, zip and git containers
(``archive.tar::LICENSE``, ``archive.tar::*``, ``repo.git::HEAD``,
`ingest/sources.py`): the manifest expands at construction into one row
per member blob, read straight out of its container by the produce
workers, and the expansion's fingerprint joins the sidecar, so a
rewritten archive refuses a resume.  After the run, the container-level
verdicts go to ``<output>.containers.jsonl`` (`ingest/verdict.py`).

Remote (http(s)) containers read through `ingest/remote.py`.  A project
may be one stripe of a manifest (``process_index``/``process_count``:
the stripe runner's workers, `parallel/stripes.py`, or a multi-process
world, `parallel/distributed.py`): it classifies its contiguous span,
in expanded rows for a container manifest, and writes its own shard,
whose container verdicts the runner derives after the merge.  Several
devices serve one project as a mesh (``mesh``, K5 in
`parallel/mesh.py`) or as device lanes (``device_lanes``, whole chunks
round-robin over the devices).  ``progress_every`` prints a JSON
progress line on stderr, and the run's lanes register on the process's
obs registry, which ``--prom-file`` renders.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace

import licensee_tpu_torch
from licensee_tpu_torch.kernels.batch import BatchClassifier
from licensee_tpu_torch.obs.pipeline import PipelineLanes
from licensee_tpu_torch.serve.featurize import (
    jsonl_row,
    produce_batch,
    read_capped,
)

__all__ = ["BatchProject", "BatchStats", "ResumeConfigError"]

# entries the cross-batch dedupe cache holds before it drops its oldest
DEDUPE_CAP = 1 << 20


class ResumeConfigError(ValueError):
    """A resume whose row-shaping configuration (mode, corpus, threshold,
    closest, attribution) differs from the run that wrote the output."""


# -- process-pool featurization (featurize_procs) --
#
# Worker PROCESSES featurize instead of threads where the GIL holds the
# threads back (the pure-Python pipeline).  Each builds a host-only
# classifier (device=None: no device tensors, no CUDA context, nothing
# to dispatch) from the parent's pickled corpus; batches come back as
# plain numpy and dataclasses.  The cross-batch dedupe cache stays in
# the parent and is applied on receipt.  The parent holds a live CUDA
# context, so the pool spawns its workers, never forks them.  With
# containers in the manifest, each worker reopens them from the
# expansion's picklable descriptor (fresh handles, never inherited
# descriptors) and reads by the chunk's offset, as the threads do.

_MP_STATE: dict = {}


def _mp_init(corpus, mode, batch_size, ingest_desc=None):
    _MP_STATE["clf"] = BatchClassifier(
        corpus=corpus, mode=mode, pad_batch_to=batch_size, device=None
    )
    if ingest_desc is not None:
        from licensee_tpu_torch.ingest.sources import ManifestExpansion

        _MP_STATE["ingest"] = ManifestExpansion.from_descriptor(ingest_desc)


def _mp_produce(chunk, mode, dedupe, attribution, start=None):
    exp = _MP_STATE.get("ingest")
    read = filenames = None
    if exp is not None:
        read = _read_from(exp, start)
        filenames = exp.filenames[start : start + len(chunk)]
    return (chunk, *produce_batch(
        _MP_STATE["clf"], chunk, mode, dedupe, attribution, read=read,
        filenames=filenames))


def _read_from(exp, start: int):
    """The produce stage's read hook for the chunk at ``start`` of an
    expanded manifest: reads by global index, since display names are
    not unique across containers."""
    read_at = exp.read_at
    return lambda _path, i: read_at(start + i)


def _stripe_rank(process_index, process_count) -> tuple[int, int]:
    """``(process_index, process_count)``: the arguments where given (both
    or neither), else the multi-process world of the environment
    (`parallel/distributed.maybe_initialize`, ``(0, 1)`` without one)."""
    if (process_index is None) != (process_count is None):
        raise ValueError(
            "process_index and process_count must be given together"
        )
    if process_count is None:
        from licensee_tpu_torch.parallel.distributed import maybe_initialize

        process_index, process_count = maybe_initialize()
    return int(process_index), int(process_count)


class _Progress:
    """``--progress SECS``: at most every ``every`` seconds of a run, one
    JSON line on stderr (rows written, of how many, files/sec, dedupe
    hits), from the writer thread after a batch is written."""

    def __init__(self, every: float, t_run: float, of: int, stats):
        self.every = every
        self.t_run = self.t_last = t_run
        self.of = of
        self.stats = stats

    def tick(self) -> None:
        if not self.every:
            return
        now = time.perf_counter()
        if now - self.t_last < self.every:
            return
        self.t_last = now
        stats = self.stats
        print(
            json.dumps({
                "progress": stats.total,
                "of": self.of,
                "files_per_sec": round(stats.total / (now - self.t_run), 1),
                "dedupe_hits": stats.dedupe_hits,
            }),
            file=sys.stderr,
            flush=True,
        )


@dataclass
class BatchStats:
    total: int = 0
    prefiltered_copyright: int = 0
    prefiltered_exact: int = 0
    dice_matched: int = 0
    reference_matched: int = 0
    package_matched: int = 0
    unmatched: int = 0
    read_errors: int = 0
    featurize_errors: int = 0
    dedupe_hits: int = 0
    # blobs past the MAX_LICENSE_SIZE 64 KiB cap: skipped, never
    # truncated-and-scored (their rows carry error="oversized")
    skipped_oversized: int = 0
    # --mode auto: rows per dispatched chain ("license", "readme",
    # "package", "none" for filenames no table scores)
    routed: dict = field(default_factory=dict)
    # rows scored on the device (the Dice-bound rows)
    device_rows: int = 0
    # per-stage wall-clock seconds: read and featurize add up over the
    # worker threads, so they can exceed elapsed
    stage_seconds: dict = field(default_factory=dict)
    # the run's lane occupancy (obs/pipeline.py PipelineLanes.occupancy)
    pipeline: dict = field(default_factory=dict)
    # the classifier's set-up against steady-state dispatch split
    # (BatchClassifier.dispatch_stats)
    dispatch: dict = field(default_factory=dict)

    def add_stage(self, stage: str, seconds: float) -> None:
        self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + seconds

    def add_route(self, route: str | None) -> None:
        route = route or "none"
        self.routed[route] = self.routed.get(route, 0) + 1

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        for key in ("routed", "pipeline", "dispatch"):
            if not d[key]:
                del d[key]
        d["stage_seconds"] = {
            k: round(v, 4) for k, v in self.stage_seconds.items()
        }
        return d


class BatchProject:
    """Classify every path in a manifest against the compiled corpus,
    streaming the results to ``<output>`` as JSON lines."""

    def __init__(
        self,
        manifest_paths: list[str],
        corpus=None,
        method: str = "auto",
        batch_size: int = 4096,
        threshold: float | None = None,
        workers: int | None = None,
        inflight: int = 3,
        mode: str = "license",
        dedupe: bool = True,
        featurize_procs: int = 0,
        coalesce_batches: int = 32,
        corpus_source: str | None = None,
        pipeline_depth: int = 2,
        closest: int = 0,
        attribution: bool = False,
        device="cuda",
        mesh="auto",
        process_index: int | None = None,
        process_count: int | None = None,
        already_striped: bool = False,
        progress_every: float = 0,
        device_lanes: int | str | None = None,
        classifier=None,
    ):
        from licensee_tpu_torch.ingest.sources import (
            expand_manifest,
            is_container_entry,
        )

        # one stripe of the manifest: explicit arguments win, else the
        # multi-process world, else the whole manifest
        self.process_index, self.process_count = _stripe_rank(
            process_index, process_count
        )
        paths = list(manifest_paths)
        # container entries expand into one work item per member blob
        # (metadata only: member tables, central directories, root
        # trees); a torn container raises here, before any row exists.
        # Stripes of a container manifest are spans of the expanded
        # rows: every stripe expands the full manifest and keeps its
        # span, so one large tarball splits across stripes.
        self.ingest = None
        has_containers = any(is_container_entry(p) for p in paths)
        if self.process_count > 1 and not already_striped and (
            not has_containers
        ):
            from licensee_tpu_torch.parallel.distributed import (
                manifest_stripe,
            )

            lo, hi = manifest_stripe(
                len(paths), self.process_index, self.process_count
            )
            paths = paths[lo:hi]
        if has_containers:
            if already_striped and self.process_count > 1:
                # the caller sliced the raw entries; expanded spans need
                # the full manifest on every stripe
                raise ValueError(
                    "container manifests stripe by expanded blob "
                    "count; pass the full manifest to every rank "
                    "(already_striped does not apply)"
                )
            self.ingest = expand_manifest(paths)
            if self.process_count > 1:
                from licensee_tpu_torch.parallel.distributed import (
                    manifest_stripe,
                )

                self.ingest.restrict(*manifest_stripe(
                    self.ingest.total,
                    self.process_index,
                    self.process_count,
                ))
            paths = self.ingest.paths
        self.paths = paths
        try:
            # a caller's classifier (its pad_batch_to must be batch_size)
            # shares its scorer across projects
            self.classifier = classifier or BatchClassifier(
                corpus=corpus,
                method=method,
                pad_batch_to=batch_size,
                mode=mode,
                closest=closest,
                device=device,
                mesh=mesh,
                # --device-lanes: whole chunks round-robin over this
                # stripe's devices; overrides mesh sharding when set
                lanes=device_lanes,
            )
            if self.classifier.pad_batch_to != batch_size:
                raise ValueError(
                    f"classifier pad_batch_to="
                    f"{self.classifier.pad_batch_to} != "
                    f"batch_size={batch_size}"
                )
        except BaseException:
            self.close()
            raise
        self.batch_size = batch_size
        # the default, never the facade's global (`detect` sets that)
        self.threshold = (
            licensee_tpu_torch.CONFIDENCE_THRESHOLD
            if threshold is None
            else threshold
        )
        self.workers = workers or min(32, (os.cpu_count() or 1))
        # produced batches in flight on the workers at once
        self.inflight = max(1, inflight)
        # cross-batch device coalescing: how many produced batches may
        # wait while their sparse device rows accumulate toward a full
        # device chunk; 1 disables it
        if coalesce_batches < 1:
            raise ValueError(
                f"coalesce_batches must be >= 1, got {coalesce_batches!r}"
            )
        self.coalesce_batches = int(coalesce_batches)
        # dispatched device groups in flight at once: 1 is the
        # synchronous dispatch/await/write loop, >= 2 the overlap
        # pipeline; the output is identical at every depth
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth!r}"
            )
        self.pipeline_depth = int(pipeline_depth)
        if not (featurize_procs is None or featurize_procs >= 0):
            raise ValueError(
                f"featurize_procs must be >= 0, got {featurize_procs!r}"
            )
        self.featurize_procs = int(featurize_procs or 0)
        self.mode = self.classifier.mode
        # Content dedupe: real license corpora are dominated by verbatim
        # copies of a few hundred texts, and a verdict is a function of
        # the content and the filename dispatch alone (the HTML gate, the
        # package matcher table, the copyright? gate with attribution),
        # so a hit is exact.  FIFO-bounded; the workers only read it
        # (GIL-atomic dict ops), the writer thread alone inserts.
        self.dedupe = dedupe
        self._dedupe_cache: dict = {}
        # the --corpus value, recorded in the resume sidecar so a corpus
        # refusal can name the corpus that wrote the output
        self.corpus_source = corpus_source
        # --attribution: the copyright line of each matched row, a host
        # regex after the match (with dedupe, once per unique content)
        self.attribution = attribution
        # --progress SECS: a JSON progress line on stderr at most every
        # SECS seconds of run(); 0 disables
        self.progress_every = float(progress_every or 0)
        if not (self.progress_every >= 0):  # rejects negatives AND NaN
            raise ValueError(
                f"progress_every must be >= 0, got {progress_every!r}"
            )
        self.stats = BatchStats()

    @classmethod
    def from_manifest_file(cls, manifest_file: str, **kwargs) -> "BatchProject":
        """Build a project from a one-path-per-line manifest.

        One stripe of several reads only its own span of a loose
        manifest (one pass counts the entries, the second keeps the
        span), so N stripes hold ~1/N of the paths each; a container
        manifest is read whole, since its spans are in expanded rows."""
        process_index, process_count = _stripe_rank(
            kwargs.get("process_index"), kwargs.get("process_count")
        )
        kwargs["process_index"] = process_index
        kwargs["process_count"] = process_count
        if process_count > 1:
            from licensee_tpu_torch.ingest.sources import is_container_entry
            from licensee_tpu_torch.parallel.distributed import (
                count_manifest_entries,
                manifest_stripe,
            )

            with open(manifest_file, encoding="utf-8") as f:
                has_containers = any(
                    is_container_entry(line.strip()) for line in f
                )
            if not has_containers:
                # the runner's own counter: the runner and the stripe
                # agree on what an entry is, or the merge's row count
                # check fails
                n = count_manifest_entries(manifest_file)
                lo, hi = manifest_stripe(n, process_index, process_count)
                paths = []
                k = 0
                with open(manifest_file, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        if k >= hi:
                            break
                        if k >= lo:
                            paths.append(line)
                        k += 1
                kwargs["already_striped"] = True
                return cls(paths, **kwargs)
        with open(manifest_file, encoding="utf-8") as f:
            paths = [line.strip() for line in f if line.strip()]
        return cls(paths, **kwargs)

    @staticmethod
    def _resume_point(output: str) -> int:
        """Count completed records, discarding a torn tail.

        A crash mid-write can leave a final line without its newline;
        only newline-terminated lines count as done, and the file is
        truncated back to the last complete record so the resumed run
        rewrites the torn row instead of leaving it corrupt."""
        done = 0
        good_end = 0
        with open(output, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break
                done += 1
                good_end += len(line)
        if good_end < os.path.getsize(output):
            with open(output, "r+b") as f:
                f.truncate(good_end)
        return done

    def _produce(self, start: int):
        """Worker-thread stage: read + dedupe + prefilter + featurize,
        with the live cross-batch dedupe cache."""
        chunk = self.paths[start : start + self.batch_size]
        read = filenames = None
        if self.ingest is not None:
            read = _read_from(self.ingest, start)
            filenames = self.ingest.filenames[start : start + len(chunk)]
        return (chunk, *produce_batch(
            self.classifier, chunk, self.mode, self.dedupe, self.attribution,
            cache=self._dedupe_cache if self.dedupe else None,
            read=read, filenames=filenames,
        ))

    def close(self) -> None:
        """Release the container handles (archive descriptors, git ODB
        handles) of an expanded manifest; a loose manifest holds none."""
        if self.ingest is not None:
            self.ingest.close()

    def _run_config(self) -> dict:
        """Everything that changes the CONTENT of an output row, in the
        JAX package's keys and order: written beside the output as
        ``<output>.meta.json`` so a resumed run can prove it appends rows
        of the same shape, whichever package wrote the earlier ones."""
        corpus = self.classifier.corpus
        corpus_id = None
        if corpus is not None:  # package mode is host-only, corpus-free
            corpus_id = {
                "templates": corpus.n_templates,
                "vocab": len(corpus.vocab),
                "keys_sha1": hashlib.sha1(
                    "\n".join(corpus.keys).encode(), usedforsecurity=False
                ).hexdigest(),
                # the templates' normalized-content hashes: an edited
                # template with unchanged keys and vocab size refuses to
                # resume
                "content_sha1": hashlib.sha1(
                    "\n".join(
                        sorted(
                            f"{key}:{h}"
                            for h, key in corpus.content_hashes.items()
                        )
                    ).encode(),
                    usedforsecurity=False,
                ).hexdigest(),
            }
        return {
            "mode": self.mode,
            "corpus": corpus_id,
            "threshold": self.threshold,
            "closest": self.classifier.closest,
            "attribution": self.attribution,
            # the container-expansion fingerprint (None for a loose
            # manifest): an archive rewritten between runs refuses the
            # resume instead of appending rows of other contents
            "ingest": (
                self.ingest.fingerprint() if self.ingest is not None else None
            ),
            # descriptive only (never compared): names the corpus in
            # refusal messages
            "corpus_source": self.corpus_source,
        }

    def _check_resume_config(self, output: str, resume: bool) -> dict:
        """Refuse a resume whose configuration would produce different
        rows.

        Returns the config; the caller writes it to the sidecar AFTER the
        output file is opened, so a crash never leaves a fresh sidecar
        beside stale rows (at worst an emptied output sits beside the
        previous sidecar, which then refuses in the safe direction)."""
        meta_path = f"{output}.meta.json"
        config = self._run_config()
        if resume and os.path.exists(output) and os.path.exists(meta_path):
            with open(meta_path, encoding="utf-8") as f:
                try:
                    prior = json.load(f)
                except json.JSONDecodeError:
                    prior = None  # torn sidecar: rewritten by this run
            if prior is not None:
                # key by key over this version's fields: a sidecar with
                # extra keys refuses nothing whose tracked settings match
                diffs = [
                    k
                    for k in config
                    if k != "corpus_source" and prior.get(k) != config[k]
                ]
                if diffs:
                    detail = ""
                    if "corpus" in diffs:
                        prior_c = prior.get("corpus") or {}
                        cur_c = config.get("corpus") or {}
                        prior_src = prior.get("corpus_source")
                        detail = (
                            "; corpus fingerprint mismatch: the output "
                            f"was written with corpus "
                            f"{prior_src or 'unknown source'} "
                            f"(content_sha1 "
                            f"{prior_c.get('content_sha1')}, "
                            f"{prior_c.get('templates')} templates), "
                            f"this run uses "
                            f"{self.corpus_source or 'unknown source'} "
                            f"(content_sha1 {cur_c.get('content_sha1')}, "
                            f"{cur_c.get('templates')} templates)"
                        )
                    raise ResumeConfigError(
                        f"cannot resume {output!r}: this run's "
                        "configuration differs from the one that wrote "
                        f"it ({', '.join(diffs)} changed — {meta_path})"
                        f"{detail}; rerun with matching settings, a "
                        "fresh --output, or --no-resume"
                    )
        return config

    def run(self, output: str, resume: bool = True) -> BatchStats:
        if self.process_count > 1:
            from licensee_tpu_torch.parallel.distributed import (
                shard_output_path,
            )

            output = shard_output_path(
                output, self.process_index, self.process_count
            )
        run_config = self._check_resume_config(output, resume)
        done = 0
        if resume and os.path.exists(output):
            done = self._resume_point(output)
        if done and self.ingest is not None:
            # the written prefix is never read again: sequential-window
            # containers skip it instead of caching it
            self.ingest.mark_done_prefix(done)
        mode = "a" if done else "w"

        starts = deque(range(done, len(self.paths), self.batch_size))
        t_run = time.perf_counter()
        # featurize (produce workers), device (submit -> await) and
        # writer occupancy, and the in-flight chunks, registered on the
        # process's registry so --prom-file carries this run's lanes
        from licensee_tpu_torch.obs import get_registry

        lanes = PipelineLanes().register(get_registry())
        progress = _Progress(
            self.progress_every, t_run, len(self.paths) - done, self.stats
        )
        use_procs = self.featurize_procs > 0
        if use_procs:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            pool = ProcessPoolExecutor(
                max_workers=self.featurize_procs,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_mp_init,
                initargs=(
                    self.classifier.corpus, self.mode, self.batch_size,
                    # a reopen recipe, never the parent's live handles
                    self.ingest.descriptor()
                    if self.ingest is not None else None,
                ),
            )
        else:
            pool = ThreadPoolExecutor(max_workers=self.workers)
        with pool, open(output, mode, encoding="utf-8") as out:
            # the sidecar AFTER the output's open/truncate: see
            # _check_resume_config
            with open(f"{output}.meta.json", "w", encoding="utf-8") as f:
                json.dump(run_config, f)
                f.write("\n")
            futures: deque = deque()

            def produce_timed(start: int):
                # the featurize lane is busy while >= 1 worker is inside
                with lanes.lane("featurize"):
                    return self._produce(start)

            def submit_next() -> None:
                if not starts:
                    return
                start = starts.popleft()
                if use_procs:
                    # the lane clock cannot reach into the children, so
                    # featurize occupancy reads 0 under featurize_procs
                    # (stage_seconds still carries their seconds)
                    futures.append(pool.submit(
                        _mp_produce,
                        self.paths[start : start + self.batch_size],
                        self.mode,
                        self.dedupe,
                        self.attribution,
                        start,
                    ))
                else:
                    futures.append(pool.submit(produce_timed, start))

            for _ in range(self.inflight):
                submit_next()

            # gather: produced batches whose (possibly sparse) device rows
            # coalesce into full device chunks.  pending: dispatched
            # groups in flight, at most pipeline_depth, awaited strictly
            # FIFO with their batches in arrival order, so the rows are
            # written in manifest order at every depth.
            pending: deque = deque()
            gather: list = []
            gather_todo = 0

            def dispatch_gathered() -> None:
                nonlocal gather_todo
                if not gather:
                    return
                batches = list(gather)
                gather.clear()
                gather_todo = 0
                t0 = time.perf_counter()
                prepareds = [b[6] for b in batches]
                merged = device_fut = None
                if any(p.todo for p in prepareds):
                    # non-blocking submit: the future resolves in the
                    # FIFO await below, never here
                    merged = self.classifier.merge_prepared(prepareds)
                    device_fut = self.classifier.dispatch_chunks_async(merged)
                    lanes.enter("device")
                    lanes.chunk_inflight(len(device_fut))
                    self.stats.device_rows += len(merged.todo)
                self.stats.add_stage("dispatch", time.perf_counter() - t0)
                pending.append((batches, merged, device_fut))

            # -- the writer thread --
            #
            # Dup resolution, stats, dedupe-cache fills, row rendering and
            # the JSONL write run here, off the main thread, behind a
            # bounded queue.  Batches arrive tagged with sequence numbers
            # that must be contiguous, so rows land in manifest order (the
            # resume invariant).  The writer is the only mutator of the
            # result counters and the only inserter into the dedupe cache;
            # a fill still in the queue merely costs a duplicate score with
            # an identical result.
            write_q: queue.Queue = queue.Queue(maxsize=8)
            writer_err: list[BaseException] = []
            next_seq = 0

            def write_loop() -> None:
                expect_seq = 0
                while True:
                    item = write_q.get()
                    if item is None:
                        return
                    if writer_err:
                        continue  # drain: the producer must never block
                    lanes.enter("writer")
                    try:
                        seq, batch = item
                        if seq != expect_seq:
                            raise RuntimeError(
                                f"writer sequence gap: got {seq}, "
                                f"expected {expect_seq} — manifest order "
                                "(the resume invariant) would break"
                            )
                        expect_seq += 1
                        t1 = time.perf_counter()
                        self._write_batch(batch, out)
                        self.stats.add_stage("write", time.perf_counter() - t1)
                        progress.tick()
                    except BaseException as exc:  # noqa: BLE001 — raised below
                        writer_err.append(exc)
                    finally:
                        lanes.exit_("writer")

            writer = threading.Thread(
                target=write_loop, name="batch-writer", daemon=True
            )
            writer.start()

            try:
                while futures or pending or gather:
                    if writer_err:
                        break  # the writer's failure is raised below
                    # pull produced batches into the coalescing buffer;
                    # keep up to pipeline_depth dispatched groups in
                    # flight before draining the oldest
                    while futures and len(pending) < self.pipeline_depth:
                        (chunk, read_errs, keys, preset, dup_of, routes,
                         prepared, contents, pre_rows, (t_read, t_feat)) = (
                            futures.popleft().result()
                        )
                        submit_next()
                        self.stats.add_stage("read", t_read)
                        self.stats.add_stage("featurize", t_feat)
                        if self.dedupe:
                            # re-probe the cross-batch cache: rows produced
                            # during the pipeline's lag (and, in process
                            # mode, every row) pick up results finished
                            # since their produce
                            cache = self._dedupe_cache
                            hit = False
                            for i, k in enumerate(keys):
                                if k is not None and preset[i] is None:
                                    cached = cache.get(k)
                                    if cached is not None:
                                        preset[i] = cached
                                        prepared.results[i] = cached
                                        hit = True
                            if hit:
                                prepared.todo = [
                                    i
                                    for i, r in enumerate(prepared.results)
                                    if r is None
                                ]
                        if len(prepared.todo) < len(prepared.results):
                            # free the dense feature arrays while the
                            # batch waits in the buffer
                            prepared.compact_features()
                        gather.append((chunk, read_errs, keys, preset,
                                       dup_of, routes, prepared, contents,
                                       pre_rows))
                        gather_todo += len(prepared.todo)
                        if (
                            gather_todo >= self.classifier.pad_batch_to
                            or len(gather) >= self.coalesce_batches
                            or gather_todo == 0
                        ):
                            # a group with no device rows finishes at
                            # once: holding it back only delays its writes
                            dispatch_gathered()

                    if not pending:
                        # the stream's tail, or an under-filled group with
                        # nothing else in flight
                        dispatch_gathered()
                    # await the OLDEST group: by now the card has had the
                    # featurize interval to finish it
                    batches, merged, device_fut = pending.popleft()
                    t0 = time.perf_counter()
                    if merged is not None:
                        outs = device_fut.result()
                        lanes.exit_("device")
                        lanes.chunk_inflight(-len(device_fut))
                        self.classifier.finish_chunks(
                            merged, outs, self.threshold
                        )
                        self.classifier.scatter_merged(
                            [b[6] for b in batches], merged
                        )
                    self.stats.add_stage("score", time.perf_counter() - t0)
                    for b in batches:
                        write_q.put((next_seq, b))
                        next_seq += 1
            finally:
                write_q.put(None)
                writer.join()
            if writer_err:
                raise writer_err[0]
        self.stats.pipeline = lanes.occupancy()
        self.stats.dispatch = self.classifier.dispatch_stats()
        if (
            self.ingest is not None
            and self.process_count == 1
            and (self.ingest.spans or self.ingest.subsets)
        ):
            # the container-level verdicts, derived from the finished
            # per-blob output alone and replaced atomically, so a resumed
            # run regenerates the same rows.  A stripe writes none: a
            # container may span shards, so the stripe runner derives
            # the one file from the merged output
            from licensee_tpu_torch.ingest.verdict import (
                write_container_verdicts,
            )

            t0 = time.perf_counter()
            write_container_verdicts(
                output, self.ingest.spans, self.ingest.subsets
            )
            self.stats.add_stage("containers", time.perf_counter() - t0)
        self.stats.add_stage("elapsed", time.perf_counter() - t_run)
        return self.stats

    def _write_batch(self, batch, out) -> None:
        """Resolve one finished batch's duplicates, attribute its matched
        rows, count it, fill the dedupe cache and write its rows (the
        writer thread's body)."""
        (chunk, read_errs, keys, preset, dup_of, routes, prepared, contents,
         pre_rows) = batch
        results = prepared.results
        for i, j in dup_of.items():
            results[i] = results[j]
        stats = self.stats
        cache = self._dedupe_cache
        attribution_for = self.classifier.attribution_for
        route_name = self._route_name
        read_errors = featurize_errors = dedupe_hits = skipped_oversized = 0
        lines = []
        for k, (path, read_err, result) in enumerate(
            zip(chunk, read_errs, results)
        ):
            error = None
            if read_err:
                error = read_err
                if read_err == "oversized":
                    skipped_oversized += 1
                else:
                    read_errors += 1
            elif result.error:
                error = result.error
                featurize_errors += 1
            else:
                if (
                    self.attribution
                    and preset[k] is None
                    and result.key is not None
                ):
                    result.attribution = attribution_for(
                        contents[k],
                        route_name(path),
                        result,
                        route=routes[k] if routes is not None else None,
                    )
                self._count(result)
                if routes is not None and routes[k] is None:
                    pass  # an unrouted name: nothing to cache
                elif preset[k] is not None:
                    dedupe_hits += 1
                elif self.dedupe and keys[k] is not None:
                    if len(cache) >= DEDUPE_CAP:
                        cache.pop(next(iter(cache)))  # FIFO bound
                    # a snapshot with a tuple candidate list, not the
                    # row itself: the cached result is handed out as a
                    # preset row many times and must never change
                    cache[keys[k]] = replace(
                        result,
                        closest=(
                            tuple(result.closest)
                            if result.closest is not None
                            else None
                        ),
                    )
            if routes is not None:
                stats.add_route(routes[k])
            if pre_rows is not None and pre_rows[k] is not None:
                lines.append(pre_rows[k])
            else:
                lines.append(jsonl_row(path, result, error))
        lines.append("")
        out.write("\n".join(lines))
        out.flush()
        stats.total += len(chunk)
        stats.read_errors += read_errors
        stats.featurize_errors += featurize_errors
        stats.dedupe_hits += dedupe_hits
        stats.skipped_oversized += skipped_oversized

    def classify_paths(self, paths: list[str]):
        """Route, read, classify and (with attribution) attribute
        ``paths`` in one pass without the pipeline: the CLI's path
        without --output.  Returns (contents, results); a row's content
        is None where the read failed, a SkippedBlob where the reader
        refused it (the 64 KiB cap), b"" where auto routing skipped the
        read.  The classifier runs its own chunks of ``batch_size``."""
        if self.ingest is not None and paths is self.paths:
            filenames = list(self.ingest.filenames)
        else:
            filenames = [os.path.basename(p) for p in paths]
        routes = None
        if self.mode == "auto":
            routes = [BatchClassifier.route_for(f) for f in filenames]
            for r in routes:
                self.stats.add_route(r)
        if self.ingest is not None and paths is self.paths:
            # container reads go by index (display names repeat across
            # containers); only the project's own path list has it
            def read(i, _p):
                return self.ingest.read_at(i)
        else:
            def read(_i, p):
                return read_capped(p)
        contents = [
            read(i, p) if routes is None or routes[i] is not None else b""
            for i, p in enumerate(paths)
        ]
        results = self.classifier.classify_blobs(
            [c if isinstance(c, (bytes, str)) else b"" for c in contents],
            threshold=self.threshold,
            filenames=filenames,
            routes=routes,
        )
        if self.attribution:
            for i, r in enumerate(results):
                if (
                    isinstance(contents[i], (bytes, str))
                    and not r.error
                    and r.key is not None
                ):
                    r.attribution = self.classifier.attribution_for(
                        contents[i],
                        filenames[i],
                        r,
                        route=routes[i] if routes is not None else None,
                    )
        return contents, results

    def _route_name(self, path: str) -> str:
        """The filename the attribution gate reads: the member's
        basename for a listed ``container::member`` entry (whose display
        stays as written), else the path's."""
        if self.ingest is not None:
            from licensee_tpu_torch.ingest.sources import split_entry

            parsed = split_entry(path)
            if parsed is not None:
                return os.path.basename(parsed[1])
        return os.path.basename(path)

    def _count(self, result) -> None:
        if result.matcher == "copyright":
            self.stats.prefiltered_copyright += 1
        elif result.matcher == "exact":
            self.stats.prefiltered_exact += 1
        elif result.matcher == "dice":
            self.stats.dice_matched += 1
        elif result.matcher == "reference":
            self.stats.reference_matched += 1
        elif result.matcher is not None:
            # package mode: the gemspec/npmbower/cabal/cargo/cran/
            # distzilla/nuget/spdx matchers
            self.stats.package_matched += 1
        else:
            self.stats.unmatched += 1
