"""BatchProject: classify a manifest of blobs into JSONL rows.

The port's counterpart of `licensee_tpu/projects/batch_project.py`, as
one synchronous loop: chunk the manifest, produce each chunk (read +
dedupe + prefilter + featurize, `serve/featurize.py`), coalesce the
device rows of consecutive chunks into full device batches, score them
(`kernels/batch.py`), finish, and write the rows in manifest order.  A
content-hash cache carries results across chunks, so a verbatim repeat
of an earlier blob skips featurization and the device.  The rows are
byte-identical to the JAX package's for the same manifest.

What waits for later slices (ROADMAP A): the worker-thread and
worker-process produce stages, the async device pipeline, resume and its
sidecar, stripes and multi-host runs, containers, closest, attribution
and the readme/package/auto modes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import licensee_tpu_torch
from licensee_tpu_torch.kernels.batch import BatchClassifier
from licensee_tpu_torch.serve.featurize import jsonl_row, produce_batch

__all__ = ["BatchProject", "BatchStats"]

# entries the cross-batch dedupe cache holds before it drops its oldest
DEDUPE_CAP = 1 << 20
# produced chunks coalesced into one device batch at most (fewer when
# their device rows fill a batch first)
COALESCE_BATCHES = 32


@dataclass
class BatchStats:
    total: int = 0
    prefiltered_copyright: int = 0
    prefiltered_exact: int = 0
    dice_matched: int = 0
    unmatched: int = 0
    read_errors: int = 0
    featurize_errors: int = 0
    dedupe_hits: int = 0
    # blobs past the MAX_LICENSE_SIZE 64 KiB cap: skipped, never
    # truncated-and-scored (their rows carry error="oversized")
    skipped_oversized: int = 0
    # rows scored on the device (the Dice-bound rows)
    device_rows: int = 0
    stage_seconds: dict = field(default_factory=dict)

    def add_stage(self, stage: str, seconds: float) -> None:
        self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + seconds

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
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
        mode: str = "license",
        dedupe: bool = True,
        device="cuda",
    ):
        self.paths = list(manifest_paths)
        self.classifier = BatchClassifier(
            corpus=corpus,
            method=method,
            pad_batch_to=batch_size,
            mode=mode,
            device=device,
        )
        self.batch_size = batch_size
        self.threshold = (
            licensee_tpu_torch.confidence_threshold()
            if threshold is None
            else threshold
        )
        self.mode = self.classifier.mode
        self.dedupe = dedupe
        self._dedupe_cache: dict = {}
        self.stats = BatchStats()

    @classmethod
    def from_manifest_file(cls, manifest_file: str, **kwargs) -> "BatchProject":
        """Build a project from a one-path-per-line manifest."""
        with open(manifest_file, encoding="utf-8") as f:
            paths = [line.strip() for line in f if line.strip()]
        return cls(paths, **kwargs)

    def run(self, output: str) -> BatchStats:
        t_run = time.perf_counter()
        gather: list = []
        gather_todo = 0
        with open(output, "w", encoding="utf-8") as out:
            for start in range(0, len(self.paths), self.batch_size):
                chunk = self.paths[start : start + self.batch_size]
                t0 = time.perf_counter()
                produced = produce_batch(
                    self.classifier, chunk, self.mode, self.dedupe,
                    cache=self._dedupe_cache if self.dedupe else None,
                )
                self.stats.add_stage("produce", time.perf_counter() - t0)
                prepared = produced[-1]
                if len(prepared.todo) < len(prepared.results):
                    # free the dense feature arrays while the batch
                    # waits in the coalescing buffer
                    prepared.compact_features()
                gather.append((chunk, *produced))
                gather_todo += len(prepared.todo)
                if (
                    gather_todo >= self.classifier.pad_batch_to
                    or len(gather) >= COALESCE_BATCHES
                ):
                    self._score_and_write(gather, out)
                    gather, gather_todo = [], 0
            self._score_and_write(gather, out)
        self.stats.add_stage("elapsed", time.perf_counter() - t_run)
        return self.stats

    def _score_and_write(self, gather: list, out) -> None:
        """Score a group of produced batches as one merged device batch,
        then write their rows in manifest order."""
        if not gather:
            return
        prepareds = [b[-1] for b in gather]
        t0 = time.perf_counter()
        merged = self.classifier.merge_prepared(prepareds)
        if merged.todo:
            outs = self.classifier.dispatch_chunks(merged)
            self.classifier.finish_chunks(merged, outs, self.threshold)
            self.classifier.scatter_merged(prepareds, merged)
        self.stats.device_rows += len(merged.todo)
        self.stats.add_stage("score", time.perf_counter() - t0)
        t0 = time.perf_counter()
        for batch in gather:
            self._write_batch(batch, out)
        out.flush()
        self.stats.add_stage("write", time.perf_counter() - t0)

    def _write_batch(self, batch, out) -> None:
        chunk, read_errs, keys, preset, dup_of, prepared = batch
        results = prepared.results
        for i, j in dup_of.items():
            results[i] = results[j]
        stats = self.stats
        cache = self._dedupe_cache
        lines = []
        for k, (path, read_err, result) in enumerate(
            zip(chunk, read_errs, results)
        ):
            error = None
            if read_err:
                error = read_err
                if read_err == "oversized":
                    stats.skipped_oversized += 1
                else:
                    stats.read_errors += 1
            elif result.error:
                error = result.error
                stats.featurize_errors += 1
            else:
                self._count(result)
                if preset[k] is not None:
                    stats.dedupe_hits += 1
                elif self.dedupe and keys[k] is not None:
                    if len(cache) >= DEDUPE_CAP:
                        cache.pop(next(iter(cache)))  # FIFO bound
                    cache[keys[k]] = result
            lines.append(jsonl_row(path, result, error))
        lines.append("")
        out.write("\n".join(lines))
        stats.total += len(chunk)

    def _count(self, result) -> None:
        if result.matcher == "copyright":
            self.stats.prefiltered_copyright += 1
        elif result.matcher == "exact":
            self.stats.prefiltered_exact += 1
        elif result.matcher == "dice":
            self.stats.dice_matched += 1
        else:
            self.stats.unmatched += 1
