"""Versioned corpus artifacts: compile once, fingerprint, load anywhere.

The port's copy of `licensee_tpu/corpus/artifact.py`, in the same file
format, so either package loads the other's artifact and both compute
the same fingerprint of the same corpus:

* :func:`corpus_fingerprint` — sha256 over a length-prefixed
  serialization of every field that shapes a verdict (template keys,
  vocab order, the packed bit matrix, the score constants, the
  per-template content hashes, the Exact wordsets).  Two corpora with
  the same fingerprint classify identically.
* :func:`write_artifact` / :func:`load_artifact` — a single-file bundle
  (numpy ``.npz``: a JSON manifest and the seven constant arrays) that
  loads without recompiling.  ``load_artifact`` recomputes the
  fingerprint from the loaded payload and refuses a bundle whose
  manifest disagrees.
* :func:`resolve_corpus` — the resolver behind ``--corpus``:
  ``"vendored"``, ``"spdx"``, an SPDX license-list-XML directory, or an
  artifact file path.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
import zlib

import numpy as np

from licensee_tpu_torch.corpus.compiler import CompiledCorpus

FORMAT = "licensee-tpu-corpus"
FORMAT_VERSION = 1

# the arrays serialized into (and hashed out of) every artifact, in
# canonical order, with their required dtypes
ARRAY_FIELDS = (
    ("bits", np.uint32),
    ("n_wf", np.int32),
    ("n_fieldset", np.int32),
    ("field_count", np.int32),
    ("alt_count", np.int32),
    ("length", np.int32),
    ("cc_flag", np.bool_),
)

# every way a torn, garbage or truncated bundle surfaces from the zip and
# npy readers
_READ_ERRORS = (
    OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile, zlib.error,
)


class ArtifactError(ValueError):
    """The artifact cannot be trusted: unreadable, wrong format, or its
    payload no longer hashes to the manifest fingerprint."""


def _vocab_words(corpus: CompiledCorpus) -> list:
    words = [None] * len(corpus.vocab)
    for word, i in corpus.vocab.items():
        words[i] = word
    return words


def _canonical_sections(corpus: CompiledCorpus):
    """Yield (name, bytes) sections of the corpus in canonical order."""
    yield "keys", "\n".join(corpus.keys).encode("utf-8")
    yield "vocab", "\n".join(_vocab_words(corpus)).encode("utf-8")
    for name, dtype in ARRAY_FIELDS:
        arr = np.ascontiguousarray(getattr(corpus, name), dtype=dtype)
        yield name, arr.tobytes()
    yield "content_hashes", "\n".join(
        sorted(f"{key}:{h}" for h, key in corpus.content_hashes.items())
    ).encode("utf-8")
    yield "exact_sets", "\n".join(
        sorted(
            " ".join(sorted(words)) + "\t" + key
            for words, key in corpus.exact_sets.items()
        )
    ).encode("utf-8")


def corpus_fingerprint(corpus: CompiledCorpus) -> str:
    """The 64-hex sha256 content fingerprint of a compiled corpus,
    memoized on the corpus object."""
    cached = getattr(corpus, "_fingerprint", None)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    h.update(f"{FORMAT}/v{FORMAT_VERSION}".encode())
    for name, payload in _canonical_sections(corpus):
        h.update(name.encode("utf-8"))
        h.update(len(payload).to_bytes(8, "little"))
        h.update(payload)
    fp = h.hexdigest()
    # the memo is not a dataclass field, so it never enters equality
    object.__setattr__(corpus, "_fingerprint", fp)
    return fp


def short_fingerprint(fp: str | None) -> str | None:
    """The 12-hex display form."""
    return fp[:12] if fp else fp


def build_manifest(corpus: CompiledCorpus, source: str = "") -> dict:
    """The self-description written into (and returned from) a bundle."""
    return {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "fingerprint": corpus_fingerprint(corpus),
        "source": source,
        "templates": corpus.n_templates,
        "vocab": corpus.vocab_size,
        "lanes": corpus.n_lanes,
    }


def write_artifact(
    path: str, corpus: CompiledCorpus, source: str = ""
) -> dict:
    """Serialize a compiled corpus to ``path`` (atomic replace); returns
    the manifest.  A plain ``np.savez_compressed`` zip, loadable with
    ``allow_pickle=False``."""
    manifest = build_manifest(corpus, source)
    meta = {
        "manifest": manifest,
        "keys": list(corpus.keys),
        "vocab": _vocab_words(corpus),
        "content_hashes": corpus.content_hashes,
        "exact_sets": [
            [sorted(words), key]
            for words, key in sorted(
                corpus.exact_sets.items(),
                key=lambda kv: (kv[1], sorted(kv[0])),
            )
        ],
    }
    meta_bytes = json.dumps(meta, ensure_ascii=False).encode("utf-8")
    arrays = {
        name: np.ascontiguousarray(getattr(corpus, name), dtype=dtype)
        for name, dtype in ARRAY_FIELDS
    }
    buf = io.BytesIO()
    np.savez_compressed(
        buf, meta=np.frombuffer(meta_bytes, dtype=np.uint8), **arrays
    )
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return manifest


def _check_manifest(path: str, manifest: dict) -> None:
    if manifest.get("format") != FORMAT:
        raise ArtifactError(
            f"{path!r}: format {manifest.get('format')!r} is not {FORMAT!r}"
        )
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ArtifactError(
            f"{path!r}: format_version {manifest.get('format_version')!r} "
            f"unsupported (this build reads v{FORMAT_VERSION})"
        )


def _parse_meta(path: str, meta_bytes: bytes) -> dict:
    try:
        return json.loads(meta_bytes.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise ArtifactError(f"{path!r}: bad manifest: {exc}") from exc


def load_artifact(path: str) -> tuple[CompiledCorpus, dict]:
    """Load a bundle back into a CompiledCorpus, verifying integrity.

    Raises :class:`ArtifactError` on any defect: unreadable file, wrong
    format/version, missing arrays, wrong shapes, or a payload whose
    recomputed fingerprint differs from the manifest's."""
    try:
        with np.load(path, allow_pickle=False) as npz:
            data = {name: npz[name] for name in npz.files}
    except _READ_ERRORS as exc:
        raise ArtifactError(f"cannot read artifact {path!r}: {exc}") from exc
    if "meta" not in data:
        raise ArtifactError(f"{path!r}: not a corpus artifact (no manifest)")
    meta = _parse_meta(path, bytes(data["meta"]))
    manifest = meta.get("manifest") or {}
    _check_manifest(path, manifest)
    missing = [name for name, _ in ARRAY_FIELDS if name not in data]
    if missing:
        raise ArtifactError(f"{path!r}: missing arrays: {missing}")
    keys = meta.get("keys")
    vocab_words = meta.get("vocab")
    if not isinstance(keys, list) or not isinstance(vocab_words, list):
        raise ArtifactError(f"{path!r}: bad keys/vocab metadata")
    arrays = {}
    for name, dtype in ARRAY_FIELDS:
        arr = np.ascontiguousarray(data[name], dtype=dtype)
        if name == "bits":
            if arr.ndim != 2 or arr.shape[0] != len(keys):
                raise ArtifactError(
                    f"{path!r}: bits shape {arr.shape} does not match "
                    f"{len(keys)} templates"
                )
        elif arr.shape != (len(keys),):
            raise ArtifactError(
                f"{path!r}: {name} shape {arr.shape} does not match "
                f"{len(keys)} templates"
            )
        arrays[name] = arr
    corpus = CompiledCorpus(
        keys=tuple(keys),
        vocab={w: i for i, w in enumerate(vocab_words)},
        content_hashes=dict(meta.get("content_hashes") or {}),
        exact_sets={
            frozenset(words): key
            for words, key in meta.get("exact_sets") or []
        },
        **arrays,
    )
    fp = corpus_fingerprint(corpus)
    if fp != manifest.get("fingerprint"):
        raise ArtifactError(
            f"{path!r}: payload fingerprint {short_fingerprint(fp)} does "
            f"not match manifest "
            f"{short_fingerprint(manifest.get('fingerprint'))} — the "
            "artifact is corrupt; rebuild it with `corpus-build`"
        )
    return corpus, manifest


def check_corpus_source(source: str) -> str | None:
    """Check that ``source`` names a loadable corpus without compiling
    or loading it.  Returns an artifact's fingerprint (from its
    manifest), None for the other sources; raises :class:`ArtifactError`
    for anything `resolve_corpus` would refuse."""
    if not isinstance(source, str) or not source:
        raise ArtifactError("corpus source must be a non-empty string")
    if source in ("vendored", "spdx") or os.path.isdir(source):
        return None
    if not os.path.isfile(source):
        raise ArtifactError(
            f"cannot load corpus {source!r}: not 'vendored', 'spdx', an "
            "SPDX src/ directory, or a corpus artifact file"
        )
    # peek only the manifest array: the bit matrix stays on disk
    try:
        with np.load(source, allow_pickle=False) as npz:
            if "meta" not in npz.files:
                raise ArtifactError(
                    f"{source!r}: not a corpus artifact (no manifest)"
                )
            meta_bytes = bytes(npz["meta"])
    except _READ_ERRORS as exc:
        raise ArtifactError(
            f"cannot read artifact {source!r}: {exc}"
        ) from exc
    manifest = _parse_meta(source, meta_bytes).get("manifest") or {}
    _check_manifest(source, manifest)
    fp = manifest.get("fingerprint")
    if not isinstance(fp, str) or not fp:
        raise ArtifactError(f"{source!r}: manifest has no fingerprint")
    return fp


def resolve_corpus(source: str) -> tuple[CompiledCorpus, str, dict | None]:
    """Resolve a corpus source string to (corpus, fingerprint, manifest):
    ``"vendored"`` (the compiled choosealicense pool), ``"spdx"`` (the
    vendored SPDX license-list-XML mirror), a directory (an SPDX
    license-list-XML ``src/`` checkout) or a file (an artifact written
    by :func:`write_artifact`).  ``manifest`` is None for sources
    compiled on the spot.  Raises :class:`ArtifactError` (bad artifact,
    unknown source) or OSError (unreadable directory)."""
    if source == "vendored":
        from licensee_tpu_torch.corpus.compiler import default_corpus

        corpus = default_corpus()
        return corpus, corpus_fingerprint(corpus), None
    if source == "spdx" or os.path.isdir(source):
        from licensee_tpu_torch.corpus.spdx import spdx_corpus

        corpus = spdx_corpus(None if source == "spdx" else source)
        if not corpus.n_templates:
            raise ArtifactError(f"no license templates found in {source!r}")
        return corpus, corpus_fingerprint(corpus), None
    if os.path.isfile(source):
        corpus, manifest = load_artifact(source)
        return corpus, manifest["fingerprint"], manifest
    raise ArtifactError(
        f"cannot load corpus {source!r}: not 'vendored', 'spdx', an SPDX "
        "src/ directory, or a corpus artifact file"
    )
