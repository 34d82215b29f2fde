"""Batch classification: host pre-filters + the Dice kernels on the device.

The port's counterpart of `licensee_tpu/kernels/batch.py`, license mode
on one device.  It mirrors the first-match-wins matcher chain of the
reference (`project_files/license_file.rb:67-69`: Copyright -> Exact ->
Dice): the host sanitizes each blob, short-circuits it through the
Copyright and Exact pre-filters, and featurizes the rest into packed
bitsets; the device scores every (blob, template) pair with K1 or K2
(`kernels/dice_cuda.py`) and picks the exact int64 first-max; the host
finishes the score in float64 and applies the threshold.

What waits for later slices (ROADMAP A) raises NotImplementedError: the
readme, package and auto modes, ``closest``, several devices, and the
native featurizer (this slice featurizes with the pure-Python twin,
which the JAX package's tests hold bit-identical to it).
"""

from __future__ import annotations

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

    Host side: sanitation, Copyright / Exact pre-filters, normalization +
    tokenization into packed bitsets.  Device side: K1 (``popcount``,
    ``pallas``) or K2 (``matmul``, ``pallas-mxu``; ``auto`` picks one by
    template count, `resolve_method`), then the exact argmax.  Scores
    come back to the host as exact (overlap, denominator) pairs and are
    finished in float64 — bit-identical to the scalar Ruby-semantics
    path.
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
        self.device = resolve_device(device)
        self.corpus = corpus or default_corpus()
        if method == "auto":
            method = resolve_method(self.corpus.n_templates)
        self.method = method
        self.pad_batch_to = pad_batch_to
        self.tensors = corpus_tensors(self.corpus, self.device)
        self._fn = dice_cuda.make_best_match_fn(self.tensors, self.method)
        # Exact matcher pre-filter (matchers/exact.rb:6-13) against the
        # corpus's own template renderings, proved by _confirm_exact:
        # |wordset| -> [(full-wordset in-vocab bits, key)], first key
        # wins as in CompiledCorpus.exact_sets
        self._exact_feats: dict[int, list[tuple[np.ndarray, str]]] = {}
        for wordset, key in self.corpus.exact_sets.items():
            ids = [self.corpus.vocab[w] for w in wordset if w in self.corpus.vocab]
            self._exact_feats.setdefault(len(wordset), []).append(
                (pack_ids(ids, self.corpus.n_lanes), key)
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
        for i, raw in enumerate(contents):
            if results[i] is not None:
                continue
            try:
                self._prepare_one_python(
                    raw, results, bits, n_words, lengths, cc_fp, i,
                    html=self._is_html(filenames[i] if filenames else None),
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
        """Prefilter and featurize one blob on the pure-Python pipeline
        (the JAX package's `_prepare_one_python`)."""
        blob = NormalizedBlob(raw, filename="x.html" if html else None)
        content = blob.content or ""
        if COPYRIGHT_FULL_REGEX.search(ruby_strip(content)):
            results[i] = BlobResult("no-license", "copyright", 100.0)
            return
        bits[i], n_words[i], lengths[i] = self.corpus.file_features(blob)
        if blob.wordset is not None:
            key = self._confirm_exact(bits[i], int(n_words[i]))
            if key is not None:
                results[i] = BlobResult(key, "exact", 100.0)
                return
        cc_fp[i] = bool(CC_FALSE_POSITIVE_REGEX.search(ruby_strip(content)))

    def _confirm_exact(self, blob_bits, nw: int) -> str | None:
        """The Exact matcher as a set-equality proof, O(n_lanes) per
        candidate.

        The compiler's vocab covers every template's FULL wordset
        (corpus/compiler.py), so for template T with word count c and
        in-vocab bit projection P: a blob with |wordset| == c and bit
        projection == P has exactly c in-vocab words forming T's set and
        c - c = 0 out-of-vocab words — i.e. wordset equality
        (matchers/exact.rb:6-13)."""
        for tpl_bits, key in self._exact_feats.get(nw, ()):
            if np.array_equal(blob_bits, tpl_bits):
                return key
        return None

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

    def dispatch_chunks(self, prepared: PreparedBatch):
        """Score the ``todo`` rows on the device in chunks of
        ``pad_batch_to``; returns ``[(chunk, (idx, num, den)), ...]`` as
        host numpy, the shape `finish_chunks` consumes.  Synchronous:
        the async device future over streams waits for a later slice."""
        outs = []
        todo = prepared.todo
        B = self.pad_batch_to
        for start in range(0, len(todo), B):
            chunk = todo[start : start + B]
            # compacted batches store only the todo rows: row j <-> todo[j]
            rows = (
                slice(start, start + len(chunk)) if prepared.compact else chunk
            )
            outs.append(
                (
                    chunk,
                    self._fn(
                        prepared.bits[rows],
                        prepared.n_words[rows],
                        prepared.lengths[rows],
                        prepared.cc_fp[rows],
                    ),
                )
            )
        return outs

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
        Float score (dice.rb:57-59) — and apply the threshold."""
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
