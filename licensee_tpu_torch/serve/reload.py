"""Blue/green corpus reload for a live serving worker: build, validate,
then (and only then) hand the scheduler a new classifier to swap in.

The contract the scheduler (serve/scheduler.py ``reload_corpus``) leans
on:

* :func:`build_classifier_like` compiles/loads the new corpus and builds
  a complete replacement :class:`BatchClassifier` — new vocab handle,
  new packed bit matrix on the card, new scorer — mirroring the live
  classifier's device/method/mode/closest/batch configuration.  All of
  this happens OFF the scheduler thread, against the new ("green")
  objects only; the serving ("blue") classifier is never touched.

* :func:`validate_classifier` is the gate between "it compiled" and "it
  may serve": shape/vocab sanity plus a golden-blob parity probe — a
  handful of feature rows (each template's own bit row is a known-answer
  blob) dispatched through the REAL device path (K1 on the card) and
  compared exactly against a host numpy re-derivation of the score
  algebra (kernels/dice_ref.py ``dice_algebra`` + the first-max
  ranking).  A
  corrupt matrix, a mispacked lane, a broken kernel, or a key table out
  of step with the bits all fail here, and the reload is refused while
  the old corpus keeps serving.

Failure taxonomy (the scheduler maps these onto wire errors):

* :class:`ReloadInProgressError` — a second reload while one is
  compiling; rejected deterministically, never queued or interleaved.
* :class:`ReloadRejectedError` — the new corpus could not be built or
  failed validation; carries ``problems`` for the error row.
"""

from __future__ import annotations

import numpy as np

from licensee_tpu_torch.corpus.artifact import (
    ArtifactError,
    corpus_fingerprint,
    resolve_corpus,
)


class ReloadError(RuntimeError):
    """Base class for reload failures (the worker keeps serving the old
    corpus in every case)."""


class ReloadInProgressError(ReloadError):
    """A reload is already compiling; the second request is refused —
    deterministic rejection beats queueing (the queued reload's source
    could be stale by the time it ran)."""


class ReloadRejectedError(ReloadError):
    """The candidate corpus failed to build or to validate; ``problems``
    lists why."""

    def __init__(self, problems: list[str]):
        self.problems = list(problems)
        super().__init__("; ".join(self.problems) or "reload rejected")


def build_classifier_like(template, source: str, method: str | None = None):
    """Build a replacement classifier for ``source``, shaped like the
    live one.

    ``method`` is the ORIGINAL method argument (usually "auto") so a
    corpus of different width re-resolves its best kernel instead of
    inheriting the old corpus's resolved choice; None falls back to the
    live classifier's resolved method.  Raises ReloadRejectedError on
    any build failure — a bad source must cost an error row, never the
    worker."""
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    try:
        corpus, _fp, _manifest = resolve_corpus(source)
    except (ArtifactError, OSError) as exc:
        raise ReloadRejectedError([f"cannot load corpus: {exc}"]) from exc
    try:
        return BatchClassifier(
            corpus=corpus,
            method=method or template.method,
            pad_batch_to=template.pad_batch_to,
            mode=template.mode,
            closest=template.closest,
            device=template.device,
            mesh=getattr(template, "mesh", None),
            lanes=getattr(template, "devices", None),
        )
    except Exception as exc:  # noqa: BLE001 — compile containment: refuse, keep serving
        raise ReloadRejectedError(
            [f"compile failed: {type(exc).__name__}: {exc}"]
        ) from exc


def _popcount_rows(inter: np.ndarray) -> np.ndarray:
    """Bit population count over the lane axis: uint32[..., W] -> int32."""
    as_bytes = inter.view(np.uint8).reshape(*inter.shape[:-1], -1)
    return np.unpackbits(as_bytes, axis=-1).sum(
        axis=-1, dtype=np.int64
    ).astype(np.int32)


def host_best(corpus, bits, n_words, lengths, cc_fp):
    """Host numpy re-derivation of the device scorer: exact (index,
    num, den) triples with the same score algebra and the same
    first-max / exact-fraction tie-break as the device scorers
    (kernels/dice_ref.py ``argmax_exact``, K1's fused first-max).

    Row counts are tiny here (a handful of probe rows, or one
    fallback-scored request, × T templates), so the exact int
    cross-multiplication runs as a plain Python scan.  Shared by the
    validation gate below and the scheduler's scalar fallback — the
    fallback must score against the request's ADMITTED corpus epoch,
    and this algebra is the host path that can."""
    overlap = _popcount_rows(bits[:, None, :] & corpus.bits[None, :, :])
    total = (
        corpus.n_wf[None, :].astype(np.int64)
        + n_words[:, None]
        - corpus.n_fieldset[None, :]
    )
    delta = np.abs(
        corpus.length[None, :].astype(np.int64) - lengths[:, None]
    )
    adj = np.maximum(
        delta
        - 5 * np.maximum(corpus.field_count, corpus.alt_count)[None, :],
        0,
    )
    denom = total + adj // 4
    excluded = corpus.cc_flag[None, :] & cc_fp[:, None]
    num = np.where(excluded, -1, overlap).astype(np.int64)
    den = np.where(excluded | (denom <= 0), 1, denom).astype(np.int64)
    out = []
    for b in range(bits.shape[0]):
        best = 0
        for t in range(1, num.shape[1]):
            # exact fraction comparison, strict: first max wins
            if num[b, t] * den[b, best] > num[b, best] * den[b, t]:
                best = t
        out.append((best, int(num[b, best]), int(den[b, best])))
    return out


def probe_features(corpus, n_probe: int = 4):
    """Known-answer probe rows: a spread of the corpus's OWN template
    bit rows (a blob whose in-vocab projection equals template t's
    fieldless wordset, at t's length), plus an all-zeros row.  Their
    exact device answers are fully predicted by the host algebra."""
    T = corpus.n_templates
    idxs = sorted({0, T // 2, T - 1, min(T - 1, n_probe)})[:n_probe]
    bits = np.concatenate(
        [
            corpus.bits[idxs],
            np.zeros((1, corpus.n_lanes), dtype=np.uint32),
        ]
    )
    n_words = np.concatenate(
        [corpus.n_wf[idxs], np.zeros(1, np.int32)]
    ).astype(np.int32)
    lengths = np.concatenate(
        [corpus.length[idxs], np.zeros(1, np.int32)]
    ).astype(np.int32)
    cc_fp = np.zeros(len(bits), dtype=bool)
    return bits, n_words, lengths, cc_fp


def validate_classifier(clf, n_probe: int = 4) -> list[str]:
    """The validation gate: [] means the classifier may serve.

    Sanity first (cheap, catches gross corruption), then the golden
    parity probe through the real ``dispatch_chunks`` device path (K1,
    or K2 and the argmax, launched on the card's dispatch stream from
    the calling thread) — which also sets up the full-batch staging
    shape, so the first post-swap flush pays no surprise set-up."""
    problems: list[str] = []
    corpus = clf.corpus
    if corpus is None:
        return ["classifier has no corpus (package mode is host-only)"]
    T = corpus.n_templates
    if T < 1:
        return ["corpus has no templates"]
    if len(corpus.keys) != T or corpus.bits.shape != (T, corpus.n_lanes):
        problems.append(
            f"shape mismatch: {len(corpus.keys)} keys, bits "
            f"{corpus.bits.shape}, lanes {corpus.n_lanes}"
        )
    if not corpus.vocab:
        problems.append("corpus has an empty vocabulary")
    elif len(corpus.vocab) > corpus.n_lanes * 32:
        problems.append(
            f"vocab {len(corpus.vocab)} overflows {corpus.n_lanes} lanes"
        )
    for name in ("n_wf", "n_fieldset", "field_count", "alt_count", "length"):
        arr = getattr(corpus, name)
        if arr.shape != (T,):
            problems.append(f"{name} shape {arr.shape} != ({T},)")
    if problems:
        return problems

    from licensee_tpu_torch.kernels.batch import PreparedBatch

    bits, n_words, lengths, cc_fp = probe_features(corpus, n_probe)
    k = len(bits)
    prepared = PreparedBatch(
        results=[None] * k,
        bits=bits,
        n_words=n_words,
        lengths=lengths,
        cc_fp=cc_fp,
        todo=list(range(k)),
        sections=None,
        compact=True,
    )
    expected = host_best(corpus, bits, n_words, lengths, cc_fp)
    try:
        outs = clf.dispatch_chunks(prepared)
        got: list[tuple[int, int, int]] = []
        for chunk, out in outs:
            idx, num, den = (np.asarray(a)[: len(chunk)] for a in out[:3])
            got.extend(
                (int(idx[j]), int(num[j]), int(den[j]))
                for j in range(len(chunk))
            )
        # finish through the real result path too: a keys table shorter
        # than the matrix would only explode here
        clf.finish_chunks(prepared, outs, threshold=0.0)
    except Exception as exc:  # noqa: BLE001 — validation containment: refuse, keep serving
        return [f"parity probe dispatch failed: {type(exc).__name__}: {exc}"]
    for b, (want, have) in enumerate(zip(expected, got)):
        if want != have:
            problems.append(
                f"parity probe row {b}: device {have} != host {want}"
            )
    # the self-probes (every row but the zeros sentinel) must overlap
    # SOMETHING — a zeroed-out matrix agrees with the host algebra
    # (both sides compute 0) yet must never serve.  The winner need not
    # be the probe's own template (a near-duplicate with more fields
    # can out-score it), but a positive overlap is non-negotiable.
    for b in range(k - 1):
        if int(n_words[b]) > 0 and got[b][1] <= 0:
            problems.append(
                f"self-probe row {b}: no overlap against its own "
                "template matrix"
            )
    return problems


__all__ = [
    "ReloadError",
    "ReloadInProgressError",
    "ReloadRejectedError",
    "build_classifier_like",
    "validate_classifier",
    "probe_features",
    "host_best",
    "corpus_fingerprint",
]
