"""Shared blob featurize + prefilter helpers of the batch pipeline.

The port's counterpart of `licensee_tpu/serve/featurize.py`, license
mode: the capped read policy, the dispatch/content cache key, the batch
produce core (read + dedupe + prefilter + featurize, with its read hook
and stage seconds) and the JSONL row renderer, so the port writes rows
byte-identical to the JAX package's.  The single-request twin the
online micro-batcher calls, container reads, attribution and auto
routing wait for later slices (ROADMAP A).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import time

from licensee_tpu_torch.ingest import OVERSIZED, SkippedBlob
from licensee_tpu_torch.kernels.batch import BatchClassifier, BlobResult

# placeholder for a row that duplicates an earlier row of the SAME batch:
# prepare_batch skips it like any preset row, and the pipeline replaces it
# with the original's finished result before anything reads it.  The error
# marker makes an accidental leak visible instead of silent.
IN_BATCH_DUP = BlobResult(None, None, 0.0, error="in_batch_dup_unresolved")


def read_capped(path: str):
    """The loose-file read policy: a blob past the MAX_LICENSE_SIZE
    64 KiB cap (git_project.rb:53) is SKIPPED — a :class:`SkippedBlob`
    marker, an ``"error": "oversized"`` row — never truncated-and-scored.
    None on any OS error (the caller reports a read_error row)."""
    try:
        with open(path, "rb") as f:
            data = f.read(64 * 1024 + 1)
    except OSError:
        return None
    if len(data) > 64 * 1024:
        return SkippedBlob(OVERSIZED)
    return data


@functools.lru_cache(maxsize=4096)
def json_str(s: str | None) -> str:
    """json.dumps memoized per distinct value: keys and matcher names
    come from a small fixed pool."""
    return "null" if s is None else json.dumps(s)


def jsonl_row(path: str, result, error: str | None) -> str:
    """One output row as JSON, in the JAX package's exact byte layout:
    the confidence is a float whose repr IS its JSON form.  (The
    ``closest`` and ``attribution`` members of the JAX rows wait with
    their features.)"""
    row = (
        f'{{"path": {json.dumps(path)}, "key": {json_str(result.key)}, '
        f'"matcher": {json_str(result.matcher)}, '
        f'"confidence": {result.confidence!r}'
    )
    if error is not None:
        row += f', "error": {json.dumps(error)}'
    return row + "}"


def dispatch_key(route: str, filename: str | None):
    """The filename-dependent part of a result-cache key: in license
    mode only the HTML gate reads the filename."""
    return (route, BatchClassifier._is_html(filename))


def content_key(route: str, filename: str | None, content: bytes):
    """The full result-cache key: (dispatch, content hash).

    usedforsecurity=False: a cache key, not crypto — and FIPS-mode
    OpenSSL would otherwise refuse sha1 entirely."""
    return (
        dispatch_key(route, filename),
        hashlib.sha1(content, usedforsecurity=False).digest(),
    )


def _read_loose(path: str, _i: int):
    return read_capped(path)


def produce_batch(classifier, chunk, mode, dedupe, cache=None, read=None):
    """The produce stage: read + dedupe + prefilter + featurize one chunk
    of manifest paths, shared by the thread path (live ``cache``) and the
    worker-process path (``cache=None``: the cross-batch cache lives in
    the parent, which applies it on receipt).

    ``read(path, i)`` loads one blob by display path and in-chunk index;
    the default reads loose files with :func:`read_capped`.  A read may
    answer bytes, None (a ``read_error`` row) or a :class:`SkippedBlob`
    (a row carrying its skip reason, e.g. ``oversized``).

    Returns ``(read_errs, keys, preset, dup_of, prepared, pre_rows,
    (read_s, featurize_s))``: the per-row read disposition (None,
    ``"read_error"`` or the skip reason), the dedupe keys, the rows
    answered from ``cache`` or marked as in-batch duplicates, the
    duplicate -> original row map, the prepared batch, the JSONL lines
    already final here (cache hits; None where there are none) and the
    stage's seconds."""
    if mode != "license":
        raise NotImplementedError(
            f"mode {mode!r} waits for a later slice of the port "
            "(ROADMAP A, readme/package/auto modes)"
        )
    if read is None:
        read = _read_loose
    filenames = [os.path.basename(p) for p in chunk]
    t0 = time.perf_counter()
    contents = [read(p, i) for i, p in enumerate(chunk)]
    read_errs: list = [None] * len(chunk)
    for i, c in enumerate(contents):
        if c is None:
            read_errs[i] = "read_error"
        elif isinstance(c, SkippedBlob):
            read_errs[i] = c.error
            contents[i] = None
    t1 = time.perf_counter()
    keys: list = [None] * len(chunk)
    preset: list = [None] * len(chunk)
    dup_of: dict[int, int] = {}
    if dedupe:
        first_seen: dict = {}
        for i, c in enumerate(contents):
            if c is None:
                continue
            keys[i] = content_key(mode, filenames[i], c)
            if cache is not None:
                preset[i] = cache.get(keys[i])
            if preset[i] is None:
                # in-batch dedupe: repeats of a key first seen in THIS
                # batch are featurized/scored once and copied after finish
                j = first_seen.setdefault(keys[i], i)
                if j != i:
                    dup_of[i] = j
                    preset[i] = IN_BATCH_DUP
    prepared = classifier.prepare_batch(
        [c if c is not None else b"" for c in contents],
        filenames=filenames,
        preset=preset,
    )
    # render the rows already final here (cache hits) on the parallel
    # produce worker instead of the writer's serial section: a preset
    # row is never a read error and never an error result (the cache
    # holds clean rows only), so the line is what the writer would emit
    pre_rows: list | None = None
    for i, p in enumerate(preset):
        if p is not None and p is not IN_BATCH_DUP:
            if pre_rows is None:
                pre_rows = [None] * len(chunk)
            pre_rows[i] = jsonl_row(chunk[i], p, None)
    t2 = time.perf_counter()
    return (
        read_errs, keys, preset, dup_of, prepared, pre_rows,
        (t1 - t0, t2 - t1),
    )
