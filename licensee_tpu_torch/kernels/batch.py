"""Batch classification: host pre-filters + the Dice kernels on the device.

The port's counterpart of `licensee_tpu/kernels/batch.py`, license mode
on one device.  It mirrors the first-match-wins matcher chain of the
reference (`project_files/license_file.rb:67-69`: Copyright -> Exact ->
Dice): the host sanitizes each blob, short-circuits it through the
Copyright and Exact pre-filters, and featurizes the rest into packed
bitsets; the device scores every (blob, template) pair with K1 or K2
(`kernels/dice_cuda.py`) and picks the exact int64 first-max; the host
finishes the score in float64 and applies the threshold.

The host featurizes a whole batch in one crossing into the native
pipeline (`native/pipeline.py`, the GIL dropped), and redoes on the
pure-Python pipeline each blob the native side cannot take (non-ASCII
text, a PCRE2 resource limit, HTML).  The device half is asynchronous:
`dispatch_chunks_async` stages each chunk in pinned host rows, enqueues
it on the device's one dispatch stream and returns a `DeviceFuture`
that a CUDA event resolves.

What waits for later slices (ROADMAP A) raises NotImplementedError: the
readme, package and auto modes, ``closest``, and several devices (lanes
and meshes).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

import licensee_tpu_torch
from licensee_tpu_torch.convert import corpus_tensors
from licensee_tpu_torch.corpus.compiler import (
    CompiledCorpus,
    default_corpus,
    pack_ids,
)
from licensee_tpu_torch.native import pipeline as native_pipeline
from licensee_tpu_torch.kernels import dice_cuda
from licensee_tpu_torch.normalize.pipeline import (
    COPYRIGHT_FULL_REGEX,
    NormalizedContent,
)
from licensee_tpu_torch.project_files.license_file import (
    CC_FALSE_POSITIVE_REGEX,
)
from licensee_tpu_torch.project_files.project_file import sanitize_content
from licensee_tpu_torch.rubytext import ruby_strip

METHODS = ("auto",) + dice_cuda.K1_METHODS + dice_cuda.K2_METHODS

# staging slots kept per chunk shape: the pipeline's depth of groups in
# flight plus the one being filled (`_StagingRing`)
STAGING_DEPTH = 3

# The kernel crossover on the card, as in the JAX package's table of the
# same name (`licensee_tpu/kernels/batch.py`), but from the port's own
# times: ascending (max_templates, method) rungs, None for everything
# above.  It compares the whole score step of a 4096-row batch as the
# batch path runs it, the argmax included (chip_smoke.py phase 3's
# "scorer" lines, PERF.md §6): K1 is one launch that fuses the score
# algebra and the exact first-max, while K2 leaves both to some hundred
# PyTorch launches, which cost more than K2 saves, eager and on device
# time, at T=47 and at T=608 alike.  So K1 takes every width until the
# algebra and the argmax are fused into K2's epilogue (ROADMAP, K4).
METHOD_CROSSOVER: tuple = ((None, "popcount"),)


def resolve_method(n_templates: int) -> str:
    """The measured-best scoring method for a corpus of this width."""
    for bound, method in METHOD_CROSSOVER:
        if bound is None or n_templates <= bound:
            return method
    raise AssertionError("METHOD_CROSSOVER must end with a None rung")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asked for
    the CPU.  A CUDA request without a usable card raises; nothing
    carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' (--device cpu) to run the plain PyTorch "
            "scorers on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (want cuda or cpu)")
    return dev


class DeviceFuture:
    """A handle to in-flight device scoring.

    Submission already happened (the copies to the card, the launches and
    the copy back are enqueued on the dispatch stream, each chunk behind
    a CUDA event), so holding a DeviceFuture costs nothing on the host;
    :meth:`result` blocks only until the events complete and returns the
    ``[(chunk, (idx, num, den)), ...]`` outs list that ``finish_chunks``
    consumes, copied out of the staging slots.  ``ready()`` polls
    without blocking.  Resolution releases the staging slots the
    dispatch borrowed, so a slot is never refilled while its copies may
    still be in flight; a future must be awaited (or dropped) for its
    slots to recycle.  On the CPU every event is None: the plain scorers
    ran at submit."""

    __slots__ = ("_parts", "_resolved", "_release")

    def __init__(self, parts, release):
        self._parts = parts  # [(chunk, HostRows slot, event or None)]
        self._resolved = None
        self._release = release

    def __len__(self) -> int:
        return len(self._parts)

    def ready(self) -> bool:
        """True when every chunk's (idx, num, den) has landed on the host."""
        return self._resolved is not None or all(
            done is None or done.query() for _c, _s, done in self._parts
        )

    def result(self):
        """Await: every chunk's outputs as host numpy (idempotent)."""
        if self._resolved is None:
            resolved = []
            for chunk, slot, done in self._parts:
                if done is not None:
                    done.synchronize()
                resolved.append((chunk, tuple(slot.result(len(chunk)).copy())))
            self._resolved = resolved
            for _chunk, slot, _done in self._parts:
                self._release(slot)
        return self._resolved


class _StagingRing:
    """Host staging slots (`dice_cuda.HostRows`) for dispatch chunks,
    pinned where the scorer runs on a card.

    One free-list per chunk capacity.  ``acquire`` never blocks: when the
    ring is dry it allocates a fresh slot (the pipeline depth, not the
    ring, bounds the chunks in flight; a blocking acquire could deadlock
    the one thread that both submits and awaits), and ``release`` keeps
    at most ``depth`` slots per capacity, so a burst allocates and the
    steady state recycles, with no page-locked allocation in it."""

    def __init__(self, alloc, depth: int):
        self._alloc = alloc  # capacity -> HostRows
        self.depth = depth
        self._free: dict[int, list] = {}
        self._lock = threading.Lock()

    def acquire(self, capacity: int):
        with self._lock:
            free = self._free.setdefault(capacity, [])
            if free:
                return free.pop()
        return self._alloc(capacity)

    def release(self, slot) -> None:
        with self._lock:
            free = self._free.setdefault(slot.capacity, [])
            if len(free) < self.depth:
                free.append(slot)


class NormalizedBlob(NormalizedContent):
    """A bare content blob run through the normalization engine."""

    def __init__(self, content: str | bytes | None, filename: str | None = None):
        self.content = (
            sanitize_content(content) if content is not None else None
        )
        self.filename = filename


@dataclass
class BlobResult:
    key: str | None
    matcher: str | None
    confidence: float
    score_num: int = 0
    score_den: int = 0
    error: str | None = None


@dataclass
class PreparedBatch:
    """One featurized batch between the host produce stage and the device.

    ``results`` carries a BlobResult for every blob short-circuited on the
    host (prefilters, featurize errors) and None for the ``todo`` rows,
    whose feature arrays are device-ready."""

    results: list
    bits: np.ndarray
    n_words: np.ndarray
    lengths: np.ndarray
    cc_fp: np.ndarray
    todo: list
    # feature arrays hold ONLY the todo rows (row j <-> todo[j]) after
    # compact_features(); results/todo keep full-batch indexing
    compact: bool = False

    def compact_features(self) -> None:
        """Slice the feature arrays down to the todo rows.  Idempotent."""
        if self.compact:
            return
        if len(self.todo) < len(self.results):
            idx = np.asarray(self.todo, dtype=np.int64)
            self.bits = self.bits[idx]
            self.n_words = self.n_words[idx]
            self.lengths = self.lengths[idx]
            self.cc_fp = self.cc_fp[idx]
        self.compact = True


class BatchClassifier:
    """Classify many blobs against a compiled corpus.

    Host side: sanitization, Copyright / Exact pre-filters, normalization +
    tokenization into packed bitsets.  Device side: K1 (``popcount``,
    ``pallas``) or K2 (``matmul``, ``pallas-mxu``; ``auto`` picks one by
    template count, `resolve_method`), then the exact argmax.  Scores
    come back to the host as exact (overlap, denominator) pairs and are
    finished in float64 — bit-identical to the scalar Ruby-semantics
    path.

    ``device=None`` builds a host-only classifier, the featurize worker
    processes' (``--featurize-procs``): `prepare_batch` works in full,
    but it holds no device tensors, never touches CUDA, and
    `dispatch_chunks_async` raises.
    """

    def __init__(
        self,
        corpus: CompiledCorpus | None = None,
        method: str = "auto",
        pad_batch_to: int = 1024,
        mode: str = "license",
        closest: int = 0,
        device="cuda",
    ):
        if mode != "license":
            raise NotImplementedError(
                f"mode {mode!r} waits for a later slice of the port "
                "(ROADMAP A, readme/package/auto modes)"
            )
        if closest:
            raise NotImplementedError(
                "closest waits for a later slice of the port (ROADMAP A, "
                "closest and attribution)"
            )
        if method not in METHODS:
            raise ValueError(f"unknown scoring method: {method!r}")
        if pad_batch_to < 1:
            raise ValueError(f"pad_batch_to must be >= 1, got {pad_batch_to}")
        self.mode = mode
        self.device = None if device is None else resolve_device(device)
        self.corpus = corpus or default_corpus()
        if method == "auto":
            method = resolve_method(self.corpus.n_templates)
        self.method = method
        self.pad_batch_to = pad_batch_to
        # device dispatch accounting (`dispatch_stats`): the first
        # dispatch of a chunk shape is set-up (the kernel library's load,
        # the first launch, the pinned staging allocation), every later
        # one steady-state enqueue
        self._dispatch_lock = threading.Lock()
        self._dispatch_prof = {
            "compiles": 0, "compile_s": 0.0,
            "dispatches": 0, "dispatch_s": 0.0,
        }
        self._dispatched_shapes: set = set()
        self._shape_prof: dict[int, dict] = {}
        self.tensors = self._scorer = self._staging = None
        if self.device is not None:
            self.tensors = corpus_tensors(self.corpus, self.device)
            self._scorer = dice_cuda.make_best_match_fn(
                self.tensors, self.method
            )
            self._staging = _StagingRing(self._scorer.host_rows, STAGING_DEPTH)
        # Exact matcher pre-filter (matchers/exact.rb:6-13) against the
        # corpus's own template renderings, not the vendored pool
        self._exact_map = self.corpus.exact_sets
        self._init_native()

    def _init_native(self) -> None:
        """Load the whole-pipeline native featurizer: sanitize ->
        featurize in one ctypes crossing per batch (native/pipeline.cpp);
        the Python pipeline stays where the toolchain or libpcre2 is
        missing or LICENSEE_TPU_NO_NATIVE is set."""
        self._nat = native_pipeline.load()
        self._nat_vocab = None
        self._exact_hashes: dict[bytes, str] = {}
        # per-hash equality-proof constants: the template's FULL-wordset
        # in-vocab bit projection + |wordset| (see _confirm_exact)
        self._exact_feats: dict[bytes, tuple[np.ndarray, int, str]] = {}
        if self._nat is None:
            return
        self._nat_vocab = self._nat.vocab(
            list(self.corpus.vocab.keys()), self.corpus.n_lanes
        )
        for wordset, key in self.corpus.exact_sets.items():
            h = self._nat.exact_hash(wordset)
            if h in self._exact_hashes:
                continue
            self._exact_hashes[h] = key
            ids = [
                self.corpus.vocab[w] for w in wordset if w in self.corpus.vocab
            ]
            self._exact_feats[h] = (
                pack_ids(ids, self.corpus.n_lanes), len(wordset), key
            )

    # -- batch preparation (prefilters + featurization in one pass) --

    def prepare_batch(
        self,
        contents: list[str | bytes],
        filenames: list[str | None] | None = None,
        preset: list | None = None,
    ) -> PreparedBatch:
        """Sanitize, prefilter and featurize a batch of raw blobs.

        ``results`` holds a BlobResult for prefiltered blobs and None for
        the ``todo`` indexes, whose feature rows are filled and ready for
        the device.  ``filenames`` (parallel to ``contents``) enables
        the HTML->markdown conversion for ``*.html`` files
        (content_helper.rb:293-299).  ``preset`` pre-assigns result rows
        (the dedupe cache's hits) so those blobs skip featurization and
        the device.  A blob whose featurization raises gets an ``error``
        row and the rest of the batch proceeds."""
        B = len(contents)
        W = self.corpus.n_lanes
        bits = np.zeros((B, W), dtype=np.uint32)
        n_words = np.zeros(B, dtype=np.int32)
        lengths = np.zeros(B, dtype=np.int32)
        cc_fp = np.zeros(B, dtype=bool)
        results: list[BlobResult | None] = (
            list(preset) if preset is not None else [None] * B
        )
        html = [
            self._is_html(filenames[i] if filenames else None)
            for i in range(B)
        ]
        # Whole-batch native fast path: every non-HTML blob goes through
        # ONE ctypes crossing (newline fix + strip + featurize in C++,
        # GIL dropped for the whole batch).  Rows the native side cannot
        # take (non-ASCII, PCRE2 resource limits) come back with a
        # non-zero status and fall through to the per-blob paths below.
        done = bytearray(B)
        if self._nat is not None:
            fast: list[int] = []
            fast_bytes: list[bytes] = []
            for i in range(B):
                if results[i] is not None or html[i]:
                    continue
                raw = contents[i]
                if isinstance(raw, str):
                    # errors="ignore" drops lone surrogates exactly like
                    # sanitize_content's round-trip
                    raw = raw.encode("utf-8", errors="ignore")
                elif not isinstance(raw, bytes):
                    continue
                fast.append(i)
                fast_bytes.append(raw)
            if fast:
                # token bits land zero-copy in the final batch rows: a
                # full batch writes row i directly, a sparse subset
                # (preset/dedupe rows interleaved) goes through the
                # native row map
                rows = None if len(fast) == B else np.asarray(fast, np.int64)
                meta = np.zeros((len(fast), 3), dtype=np.int32)
                hashes = np.zeros((len(fast), 16), dtype=np.uint8)
                try:
                    status = self._nat.featurize_batch(
                        self._nat_vocab, fast_bytes, bits, meta, hashes,
                        rows=rows,
                    )
                except Exception:  # noqa: BLE001 — whole-batch containment
                    # the per-blob loop below redoes every row with its
                    # own per-blob error containment
                    status = np.full(len(fast), 3, dtype=np.int8)
                    bits[fast] = 0
                for j, i in enumerate(fast):
                    if status[j] != 0:
                        bits[i] = 0  # failed-over row: wiped for Python
                        continue
                    done[i] = 1
                    flags = int(meta[j, 2])
                    if flags & 1:
                        results[i] = BlobResult("no-license", "copyright", 100.0)
                        continue
                    h = hashes[j].tobytes()
                    if h in self._exact_hashes:
                        key = self._confirm_exact(h, bits[i], int(meta[j, 0]))
                        if key is not None:
                            results[i] = BlobResult(key, "exact", 100.0)
                            continue
                    n_words[i] = meta[j, 0]
                    lengths[i] = meta[j, 1]
                    cc_fp[i] = bool(flags & 2)

        for i, raw in enumerate(contents):
            if results[i] is not None or done[i]:
                continue
            try:
                if self._nat is not None:
                    try:
                        self._prepare_one_native(
                            raw, results, bits, n_words, lengths, cc_fp, i,
                            html=html[i],
                        )
                    except native_pipeline.NativeResourceError:
                        # PCRE2 hit a match/depth limit on this blob;
                        # Python re has none, so redo just this blob on
                        # the pure-Python pipeline (same answer, slower)
                        self._prepare_one_python(
                            raw, results, bits, n_words, lengths, cc_fp, i,
                            html=html[i],
                        )
                else:
                    self._prepare_one_python(
                        raw, results, bits, n_words, lengths, cc_fp, i,
                        html=html[i],
                    )
            except Exception as exc:  # noqa: BLE001 — per-blob containment
                results[i] = BlobResult(
                    None, None, 0.0, error=f"featurize_error: {exc}"
                )
                bits[i] = 0
                n_words[i] = 0
                lengths[i] = 0
                cc_fp[i] = False
        todo = [i for i, r in enumerate(results) if r is None]
        return PreparedBatch(results, bits, n_words, lengths, cc_fp, todo)

    def _prepare_one_python(
        self, raw, results, bits, n_words, lengths, cc_fp, i, html=False,
    ) -> None:
        """The pure-Python twin of `_prepare_one_native`: the path where
        the native library is absent or failed this blob over.  ``html``
        is the per-row gate prepare_batch resolved; the sentinel name
        only re-arms NormalizedContent's own stage-ordered _strip_html."""
        blob = NormalizedBlob(raw, filename="x.html" if html else None)
        content = blob.content or ""
        if COPYRIGHT_FULL_REGEX.search(ruby_strip(content)):
            results[i] = BlobResult("no-license", "copyright", 100.0)
            return
        if blob.wordset is not None and blob.wordset in self._exact_map:
            results[i] = BlobResult(
                self._exact_map[blob.wordset], "exact", 100.0
            )
            return
        bits[i], n_words[i], lengths[i] = self.corpus.file_features(blob)
        cc_fp[i] = bool(CC_FALSE_POSITIVE_REGEX.search(ruby_strip(content)))

    def _prepare_one_native(
        self, raw, results, bits, n_words, lengths, cc_fp, i, html=False,
    ) -> None:
        """One blob the batch crossing could not take, on the per-blob
        native calls (raises NativeResourceError for the Python path)."""
        content = sanitize_content(raw) if raw is not None else ""
        if html:
            # the native PCRE2 pipeline has no HTML parser; convert here
            # so the stages see markdown, exactly like the scalar path
            from licensee_tpu_torch.normalize.html2md import html_to_markdown

            content = html_to_markdown(content)
        stripped = ruby_strip(content)
        feat = self._nat.featurize_raw(self._nat_vocab, stripped, bits[i])
        if feat is None:
            # non-ASCII: the downcase between the stages must be
            # full-Unicode, so it happens in Python (two crossings)
            s1, flags = self._nat.stage1(stripped)
            _, nw, ln, h = self._nat.featurize(
                self._nat_vocab, s1.lower(), bits[i]
            )
        else:
            _, nw, ln, flags, h = feat
        if flags & 1:
            results[i] = BlobResult("no-license", "copyright", 100.0)
            return
        if h in self._exact_hashes:
            # the 128-bit additive multiset hash only TRIGGERS the check;
            # the answer rests on a complete equality proof
            key = self._confirm_exact(h, bits[i], nw)
            if key is not None:
                results[i] = BlobResult(key, "exact", 100.0)
                return
        n_words[i] = nw
        lengths[i] = ln
        cc_fp[i] = bool(flags & 2)

    def _confirm_exact(self, h, blob_bits, nw) -> str | None:
        """Set-equality proof for an exact-hash hit, O(n_lanes) per blob.

        The compiler's vocab covers every template's FULL wordset
        (corpus/compiler.py), so for template T with word count c and
        in-vocab bit projection P: a blob with |wordset| == c and bit
        projection == P has exactly c in-vocab words forming T's set and
        c - c = 0 out-of-vocab words — i.e. wordset equality
        (matchers/exact.rb:6-13), whatever the hash.  The additive hash
        (collidable in principle) only picks the candidate template."""
        tpl_bits, tpl_count, key = self._exact_feats[h]
        if nw != tpl_count or not np.array_equal(blob_bits, tpl_bits):
            return None
        return key

    @staticmethod
    def _is_html(filename: str | None) -> bool:
        return bool(filename) and filename.lower().endswith((".html", ".htm"))

    # -- classification --

    def classify_blobs(
        self,
        contents: list[str | bytes],
        threshold: float | None = None,
        filenames: list[str | None] | None = None,
    ) -> list[BlobResult]:
        threshold = (
            licensee_tpu_torch.confidence_threshold()
            if threshold is None
            else threshold
        )
        prepared = self.prepare_batch(contents, filenames=filenames)
        outs = self.dispatch_chunks(prepared)
        self.finish_chunks(prepared, outs, threshold)
        return prepared.results  # type: ignore[return-value]

    def dispatch_chunks_async(self, prepared: PreparedBatch) -> DeviceFuture:
        """Submit device scoring for the ``todo`` rows in chunks of
        ``pad_batch_to``, without blocking.

        Each chunk is copied into a staging slot (pinned host rows on a
        card, recycled through `_StagingRing`) and enqueued on the
        device's one dispatch stream: the copies to the card, the
        scorer, the copy of (idx, num, den) back into the slot and a
        CUDA event.  The returned :class:`DeviceFuture` resolves to the
        ``[(chunk, (idx, num, den)), ...]`` list ``finish_chunks``
        consumes; until then the card computes while the host featurizes
        the next chunks.  A shape's first dispatch blocks: it loads the
        kernel library (building it if stale) and allocates pinned
        memory.  On the CPU the plain scorers run at submit."""
        if prepared.todo and self._scorer is None:
            raise RuntimeError(
                "a host-only classifier (device=None) cannot dispatch: "
                "featurize workers only prepare batches"
            )
        todo = prepared.todo
        B = self.pad_batch_to
        parts = []
        for start in range(0, len(todo), B):
            chunk = todo[start : start + B]
            # compacted batches store only the todo rows: row j <-> todo[j]
            rows = (
                slice(start, start + len(chunk)) if prepared.compact else chunk
            )
            t0 = time.perf_counter()
            slot = self._staging.acquire(B)
            n = slot.fill(
                prepared.bits[rows],
                prepared.n_words[rows],
                prepared.lengths[rows],
                prepared.cc_fp[rows],
            )
            done = self._scorer.submit(slot, n)
            self._note_dispatch(B, time.perf_counter() - t0)
            parts.append((chunk, slot, done))
        return DeviceFuture(parts, self._staging.release if parts else None)

    def dispatch_chunks(self, prepared: PreparedBatch):
        """Submit and await in one call: the resolved host-numpy outs.
        For the one-shot path (`classify_blobs`); the pipeline keeps the
        future."""
        return self.dispatch_chunks_async(prepared).result()

    def _note_dispatch(self, B: int, dt: float) -> None:
        """Account one submit: set-up (the first dispatch of this chunk
        shape) against steady-state enqueue, in total and per shape."""
        with self._dispatch_lock:
            shape = self._shape_prof.setdefault(
                B,
                {
                    "compiles": 0, "compile_s": 0.0,
                    "dispatches": 0, "dispatch_s": 0.0,
                },
            )
            count, secs = (
                ("dispatches", "dispatch_s")
                if B in self._dispatched_shapes
                else ("compiles", "compile_s")
            )
            self._dispatched_shapes.add(B)
            for prof in (self._dispatch_prof, shape):
                prof[count] += 1
                prof[secs] += dt

    def dispatch_stats(self) -> dict:
        """The set-up against steady-state split of the device dispatches,
        under the JAX package's names: ``compiles``/``compile_s`` count
        each chunk shape's first dispatch (here: the kernel library's
        load, the first launch, the pinned staging allocation),
        ``dispatches``/``dispatch_s`` every later one; ``shapes`` the
        shapes dispatched and ``per_shape`` the same split per shape."""
        with self._dispatch_lock:
            out = dict(self._dispatch_prof)
            out["shapes"] = sorted(self._dispatched_shapes)
            out["per_shape"] = {
                b: {
                    k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in prof.items()
                }
                for b, prof in sorted(self._shape_prof.items())
            }
        return out

    def merge_prepared(self, group: list[PreparedBatch]) -> PreparedBatch:
        """Coalesce the ``todo`` rows of several prepared batches into ONE
        device batch (compact, row j <-> merged todo j); `scatter_merged`
        writes the finished results back."""
        if len(group) == 1 and not group[0].compact:
            return group[0]
        parts = [p for p in group if p.todo]
        bits_parts, nw_parts, ln_parts, cc_parts = [], [], [], []
        for p in parts:
            n = len(p.todo)
            idx = slice(0, n) if p.compact else np.asarray(p.todo, np.int64)
            bits_parts.append(p.bits[idx])
            nw_parts.append(p.n_words[idx])
            ln_parts.append(p.lengths[idx])
            cc_parts.append(p.cc_fp[idx])
        total = sum(len(p.todo) for p in parts)
        W = self.corpus.n_lanes

        def cat(arrays, empty):
            return np.concatenate(arrays) if arrays else empty

        return PreparedBatch(
            results=[None] * total,
            bits=cat(bits_parts, np.zeros((0, W), np.uint32)),
            n_words=cat(nw_parts, np.zeros(0, np.int32)),
            lengths=cat(ln_parts, np.zeros(0, np.int32)),
            cc_fp=cat(cc_parts, np.zeros(0, bool)),
            todo=list(range(total)),
            compact=True,
        )

    @staticmethod
    def scatter_merged(group: list[PreparedBatch], merged: PreparedBatch):
        """Copy a merged batch's finished results back into the source
        batches' ``todo`` rows (inverse of merge_prepared's row order)."""
        if len(group) == 1 and merged is group[0]:
            return
        off = 0
        for p in group:
            for j, i in enumerate(p.todo):
                p.results[i] = merged.results[off + j]
            off += len(p.todo)

    def finish_chunks(self, prepared: PreparedBatch, outs, threshold) -> None:
        """Finish scores in float64 on the host — identical to Ruby's
        Float score (dice.rb:57-59) — and apply the threshold.  ``outs``
        may be the resolved list or a :class:`DeviceFuture`, whose await
        is then the synchronize."""
        if isinstance(outs, DeviceFuture):
            outs = outs.result()
        results = prepared.results
        for chunk, out in outs:
            best_idx, best_num, best_den = (
                np.asarray(a)[: len(chunk)] for a in out[:3]
            )
            scores = np.where(best_den > 0, (best_num * 200.0) / best_den, 0.0)
            for j, i in enumerate(chunk):
                if best_num[j] >= 0 and scores[j] >= threshold:
                    results[i] = BlobResult(
                        self.corpus.keys[int(best_idx[j])],
                        "dice",
                        float(scores[j]),
                        int(best_num[j]),
                        int(best_den[j]),
                    )
                else:
                    results[i] = BlobResult(None, None, 0.0)
