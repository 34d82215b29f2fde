"""Shared blob featurize + prefilter helpers of the batch pipeline and
the serve path.

The port's counterpart of `licensee_tpu/serve/featurize.py`: the capped
read policy, the route-aware dispatch/content cache key, the batch
produce core (route + read + dedupe + prefilter + featurize, with its
read hook and stage seconds, and the contents kept for the attribution
pass) and the JSONL row renderer, so the port writes rows byte-identical
to the JAX package's.  Container members come in through the read hook
(`ingest/sources.py`).  ``featurize_request`` is the single-request twin
the online micro-batcher (`serve/scheduler.py`) calls at admission, on
the same `prepare_batch` chain, so the two paths cannot drift.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import time

from licensee_tpu_torch.ingest import OVERSIZED, SkippedBlob
from licensee_tpu_torch.kernels.batch import BatchClassifier, BlobResult
from licensee_tpu_torch.project_files.license_file import COPYRIGHT_NAME_REGEX

# placeholder for a row that duplicates an earlier row of the SAME batch:
# prepare_batch skips it like any preset row, and the pipeline replaces it
# with the original's finished result before anything reads it.  The error
# marker makes an accidental leak visible instead of silent.
IN_BATCH_DUP = BlobResult(None, None, 0.0, error="in_batch_dup_unresolved")

# the shared row for --mode auto entries no filename table scores: the
# file is never read, hashed or featurized (find_files drops score-0
# names before load_file, project.rb:111-124).  Finished results are
# never mutated, so one instance serves every such row.
UNROUTED = BlobResult(None, None, 0.0)


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
    the confidences are floats whose repr IS their JSON form."""
    row = (
        f'{{"path": {json.dumps(path)}, "key": {json_str(result.key)}, '
        f'"matcher": {json_str(result.matcher)}, '
        f'"confidence": {result.confidence!r}'
    )
    if result.closest is not None:
        inner = ", ".join(
            f"[{json_str(k)}, {c!r}]" for k, c in result.closest
        )
        row += f', "closest": [{inner}]'
    if result.attribution is not None:
        row += f', "attribution": {json.dumps(result.attribution)}'
    if error is not None:
        row += f', "error": {json.dumps(error)}'
    return row + "}"


def dispatch_key(
    route: str, filename: str | None, attribution: bool = False
):
    """The filename-dependent part of a result-cache key: in package
    mode the whole matcher table reads the filename, in license and
    readme mode only the HTML gate does.  With attribution on, the
    copyright? filename gate (project_file.rb:94) feeds the result too,
    so COPYRIGHT and LICENSE holding the same bytes get separate keys."""
    if route == "package":
        return (route, filename)
    key = (route, BatchClassifier._is_html(filename))
    if attribution:
        key += (
            bool(COPYRIGHT_NAME_REGEX.search(filename)) if filename else False,
        )
    return key


def content_key(
    route: str,
    filename: str | None,
    content: bytes,
    attribution: bool = False,
):
    """The full result-cache key: (dispatch, content hash).

    usedforsecurity=False: a cache key, not crypto — and FIPS-mode
    OpenSSL would otherwise refuse sha1 entirely."""
    return (
        dispatch_key(route, filename, attribution),
        hashlib.sha1(content, usedforsecurity=False).digest(),
    )


def _read_loose(path: str, _i: int):
    return read_capped(path)


def produce_batch(
    classifier, chunk, mode, dedupe, attribution=False, cache=None, read=None,
    filenames=None,
):
    """The produce stage: route + read + dedupe + prefilter + featurize
    one chunk of manifest paths, shared by the thread path (live
    ``cache``) and the worker-process path (``cache=None``: the
    cross-batch cache lives in the parent, which applies it on receipt).

    ``read(path, i)`` loads one blob by display path and in-chunk index;
    the default reads loose files with :func:`read_capped`, and an
    expanded container manifest reads by index, since two containers may
    hold the same member name.  A read may answer bytes, None (a
    ``read_error`` row) or a :class:`SkippedBlob` (a row carrying its
    skip reason, e.g. ``oversized``).  ``filenames`` overrides each
    row's routing and dispatch name (by default the path's basename): a
    container entry routes by its member's basename, not by its display
    string.  In auto mode the filename routes first: an entry no score
    table claims is never read, hashed or featurized.

    Returns ``(read_errs, keys, preset, dup_of, routes, prepared,
    contents, pre_rows, (read_s, featurize_s))``: the per-row read
    disposition (None, ``"read_error"`` or the skip reason), the dedupe
    keys, the rows answered from ``cache``, unrouted or marked as
    in-batch duplicates, the duplicate -> original row map, the auto
    routes (None in the fixed modes), the prepared batch, the raw
    contents the attribution pass may still need (None without
    ``attribution``), the JSONL lines already final here (None where
    there are none) and the stage's seconds."""
    if read is None:
        read = _read_loose
    if filenames is None:
        filenames = [os.path.basename(p) for p in chunk]
    routes: list | None = None
    if mode == "auto":
        routes = [BatchClassifier.route_for(f) for f in filenames]
    t0 = time.perf_counter()
    contents = [
        read(p, i) if routes is None or routes[i] is not None else b""
        for i, p in enumerate(chunk)
    ]
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
    if routes is not None:
        for i, route in enumerate(routes):
            if route is None:
                preset[i] = UNROUTED
    if dedupe:
        first_seen: dict = {}
        for i, c in enumerate(contents):
            if c is None or preset[i] is not None:
                continue
            route = routes[i] if routes is not None else mode
            keys[i] = content_key(route, filenames[i], c, attribution)
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
        routes=routes,
    )
    # render the rows already final here (cache hits, unrouted rows) on
    # the parallel produce worker instead of the writer's serial section:
    # a preset row is never a read error and never an error result (the
    # cache holds clean rows only), so the line is what the writer would
    # emit
    pre_rows: list | None = None
    for i, p in enumerate(preset):
        if p is not None and p is not IN_BATCH_DUP:
            if pre_rows is None:
                pre_rows = [None] * len(chunk)
            pre_rows[i] = jsonl_row(chunk[i], p, None)
    t2 = time.perf_counter()
    kept = None
    if attribution:
        # keep the raw contents only of rows that can still need the
        # attribution regex (license or readme route, not finished as
        # unmatched, not a preset or duplicate row): in process mode each
        # kept row is pickled to the parent
        kept = []
        for i, c in enumerate(contents):
            route = routes[i] if routes is not None else mode
            r = prepared.results[i]
            need = (
                route in ("license", "readme")
                and preset[i] is None
                and (r is None or (r.key is not None and not r.error))
            )
            kept.append(c if need else None)
    return (
        read_errs, keys, preset, dup_of, routes, prepared, kept, pre_rows,
        (t1 - t0, t2 - t1),
    )


def featurize_request(
    classifier,
    content: bytes | str,
    filename: str | None = None,
    route: str | None = None,
):
    """One online request through route -> prefilter -> featurize: the
    single-blob twin of ``produce_batch``.

    Returns a size-1 PreparedBatch: ``results[0]`` is a finished
    BlobResult when a host stage answered (Copyright/Exact prefilter, a
    package matcher, an unrouted filename, a README with no license
    section, a featurize error) and None when the row is Dice-bound: its
    feature arrays are device-ready and the scheduler coalesces it into
    the next micro-batch (`BatchClassifier.merge_prepared`)."""
    if route is None and classifier.mode == "auto":
        route = BatchClassifier.route_for(filename)
        if route is None:
            return classifier.prepare_batch(
                [b""], filenames=[filename], preset=[UNROUTED],
                routes=[None],
            )
    routes = [route] if classifier.mode == "auto" else None
    return classifier.prepare_batch(
        [content], filenames=[filename], routes=routes
    )
