"""The port's native featurizer against the JAX package's and against the
port's own Python path.

`licensee_tpu_torch/native/` builds `native/pipeline.cpp` and
`native/textops.cpp` from the repo's sources into
`build/licensee_tpu_torch/native/` and feeds them the port's own copies
of the normalization patterns; a pattern that differs by a byte from the
JAX package's changes what PCRE2 matches.  Per blob, the batch crossing
must give the same bits, |wordset|, length, prefilter flags, hash and
status as the JAX package's library, and `prepare_batch` the same rows
through the native path, the per-blob failover and the pure-Python
path.  Inputs: the 78 fixture blobs, the 47 vendored templates rendered
with field values, seeded mutations of both, non-ASCII and HTML blobs."""

import os

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import chip_smoke
from licensee_tpu.kernels.batch import BatchClassifier as JaxBatchClassifier
from licensee_tpu.native import pipeline as jax_native
from licensee_tpu_torch.corpus.compiler import default_corpus
from licensee_tpu_torch.kernels.batch import BatchClassifier
from licensee_tpu_torch.native import build, pipeline, textops
from licensee_tpu_torch.normalize import pipeline as normalize
from licensee_tpu_torch.project_files.project_file import sanitize_content
from licensee_tpu_torch.rubytext import ruby_strip

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
NON_ASCII = [
    "Copyright © 2020 Jürgen Müller\n\nPermission is hereby granted, free "
    "of charge, to any person obtaining a copy — “as is”.",
    "MIT ライセンス\n\nCopyright (c) 2021 開発者",
    "Лицензия MIT\n\nРазрешается безвозмездно…",
    "Ｆｕｌｌｗｉｄｔｈ text, naïve café, Straße",
]


def make_blobs():
    """(contents, filenames): fixtures, rendered templates, seeded
    mutations of both, non-ASCII texts, and HTML blobs."""
    contents, names = [], []
    for d, _dirs, files in sorted(os.walk(FIXTURES)):
        if os.path.relpath(d, FIXTURES).split(os.sep)[0] == "analysis":
            continue
        for f in sorted(files):
            if f.endswith((".json", ".yml")):
                continue
            with open(os.path.join(d, f), "rb") as fh:
                contents.append(fh.read())
            names.append(f)
    from licensee_tpu_torch.corpus.fields import field_regex
    from licensee_tpu_torch.corpus.license import License

    for lic in License.all(hidden=True, pseudo=False):
        text = field_regex().sub(
            lambda m: chip_smoke.FIELD_VALUES[m.group(1)], lic.content or "")
        contents.append(text.encode())
        names.append(f"{lic.key}.LICENSE")
    rng = np.random.default_rng(7)
    n_base = len(contents)
    for k in range(60):
        j = int(rng.integers(n_base))
        text = contents[j].decode("utf-8", errors="ignore")
        contents.append(
            chip_smoke.mutate(text, rng, (0.01, 0.05, 0.2)[k % 3]).encode())
        names.append(names[j])
    for text in NON_ASCII:
        contents.append(text.encode())
        names.append("LICENSE")
    mit = contents[names.index("mit.LICENSE")].decode()
    contents.append(f"<html><body><h1>MIT</h1><p>{mit}</p></body></html>"
                    .encode())
    names.append("LICENSE.html")
    contents.append(b"<h2>License</h2><p>\xc2\xa9 2019 \xe2\x80\x94 Foo</p>")
    names.append("COPYING.htm")
    return contents, names


@pytest.fixture(scope="module")
def blobs():
    return make_blobs()


def test_input_set(blobs):
    contents, names = blobs
    assert len(contents) >= 78 + 47 + 60
    assert sum(n.lower().endswith((".html", ".htm")) for n in names) >= 3


def test_library_is_the_ports_own():
    """Built from the repo's native/ sources under build/licensee_tpu_torch/,
    never the library the JAX package builds inside its own directory."""
    nat = pipeline.load()
    assert nat is not None and textops.load() is not None
    for name in ("pipeline", "textops"):
        path = build.library_path(name)
        assert path.startswith(
            os.path.join(REPO, "build", "licensee_tpu_torch", "native"))
        assert os.path.exists(path)
    assert nat._lib._name == build.library_path("pipeline")
    assert build.NATIVE_SRC_DIR == os.path.join(REPO, "native")


def test_config_records_match_jax():
    """Every pattern the native side compiles, and the title gate and the
    spelling table, byte for byte."""
    assert pipeline._build_config() == jax_native._build_config()


def test_batch_crossing_matches_jax_per_blob(blobs):
    contents, _names = blobs
    corpus = default_corpus()
    words = list(corpus.vocab.keys())
    runs = []
    for nat in (pipeline.load(), jax_native.load()):
        vocab = nat.vocab(words, corpus.n_lanes)
        n = len(contents)
        bits = np.zeros((n, corpus.n_lanes), np.uint32)
        meta = np.zeros((n, 3), np.int32)
        hashes = np.zeros((n, 16), np.uint8)
        status = nat.featurize_batch(vocab, contents, bits, meta, hashes)
        # the rows the crossing cannot take (non-ASCII) through the
        # two-crossing path the classifier takes for them
        two = []
        for i in np.flatnonzero(status == 2):
            text = contents[i].decode("utf-8", errors="ignore").strip()
            s1, flags = nat.stage1(text)
            row, nw, ln, h = nat.featurize(vocab, s1.lower())
            two.append((row, nw, ln, flags, h))
        runs.append((bits, meta, hashes, status, two))
    got, want = runs
    bits, meta, hashes, status, two = got
    assert (status == 0).sum() > 120 and (status == 2).sum() >= len(NON_ASCII)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    for (rb, *rest), (wb, *wrest) in zip(two, want[4], strict=True):
        np.testing.assert_array_equal(rb, wb)
        assert rest == wrest
    # the per-blob raw crossing agrees with the batch crossing
    nat = pipeline.load()
    vocab = nat.vocab(list(corpus.vocab.keys()), corpus.n_lanes)
    for i in np.flatnonzero(status == 0)[:40]:
        text = ruby_strip(sanitize_content(contents[i]))
        row, nw, ln, flags, h = nat.featurize_raw(vocab, text)
        np.testing.assert_array_equal(row, bits[i])
        assert [nw, ln, flags] == list(meta[i]) and h == hashes[i].tobytes()


def prepared_rows(prepared):
    """The results, and the feature rows of the device-bound rows (a
    prefiltered row's features are never read, and only the native path
    computes them before its prefilters)."""
    live = np.array([r is None for r in prepared.results])
    return (
        [None if r is None else (r.key, r.matcher, r.confidence, r.error)
         for r in prepared.results],
        *(np.where(live.reshape((-1,) + (1,) * (a.ndim - 1)), a, 0)
          for a in (prepared.bits, prepared.n_words, prepared.lengths,
                    prepared.cc_fp)),
    )


def assert_same_rows(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def test_prepare_batch_native_python_and_jax_agree(blobs, monkeypatch):
    """The port's native path, its pure-Python path (with the textops
    scanners and with the regexes alone) and the JAX package's host-only
    classifier: the same rows, feature rows included."""
    contents, names = blobs
    native = BatchClassifier(device=None)
    assert native._nat is not None
    want = prepared_rows(native.prepare_batch(contents, filenames=names))
    matchers = {r and r[1] for r in want[0]}
    assert {"copyright", "exact", None} <= matchers
    ref = JaxBatchClassifier(mesh=None, device=False)
    assert_same_rows(
        prepared_rows(ref.prepare_batch(contents, filenames=names)), want)
    monkeypatch.setattr(pipeline, "load", lambda: None)
    python = BatchClassifier(device=None)
    assert python._nat is None
    assert_same_rows(
        prepared_rows(python.prepare_batch(contents, filenames=names)), want)
    monkeypatch.setattr(normalize, "_native", lambda: None)
    plain = BatchClassifier(device=None)
    subset = list(range(0, len(contents), 4))
    assert_same_rows(
        prepared_rows(plain.prepare_batch([contents[i] for i in subset],
                                          filenames=[names[i] for i in subset])),
        tuple([want[0][i] for i in subset] if k == 0 else want[k][subset]
              for k in range(5)),
    )


class _FailingOver:
    """The native pipeline, with one blob that hits PCRE2's resource
    limit in the batch crossing and in the per-blob call."""

    def __init__(self, nat, poisoned: bytes):
        self._nat = nat
        self._poisoned = poisoned
        self.failovers = 0

    def featurize_batch(self, vocab, contents, bits, meta, hashes, rows=None):
        status = self._nat.featurize_batch(
            vocab, contents, bits, meta, hashes, rows=rows)
        status[[c == self._poisoned for c in contents]] = 3
        return status

    def featurize_raw(self, vocab, stripped, bits_out=None):
        if stripped == self._poisoned.decode().strip():
            self.failovers += 1
            raise pipeline.NativeResourceError("pipe_featurize_raw: limit")
        return self._nat.featurize_raw(vocab, stripped, bits_out)

    def __getattr__(self, name):
        return getattr(self._nat, name)


def test_resource_limit_fails_over_to_python(blobs):
    """A blob the native side gives up on is redone on the Python path
    with the same answer, not turned into an error row."""
    contents, names = blobs
    clf = BatchClassifier(device=None)
    want = prepared_rows(clf.prepare_batch(contents, filenames=names))
    k = names.index("mit.LICENSE")
    clf._nat = _FailingOver(clf._nat, contents[k])
    got = prepared_rows(clf.prepare_batch(contents, filenames=names))
    assert clf._nat.failovers == 1
    assert_same_rows(got, want)
    assert want[0][k] is not None and want[0][k][1] == "exact"


def test_exact_hashes_match_jax():
    """The native route finds an Exact candidate by the 128-bit wordset
    hash (the Python route by the wordset itself): one hash per template
    wordset, the JAX package's."""
    clf = BatchClassifier(device=None)
    corpus = clf.corpus
    assert len(clf._exact_hashes) == len(corpus.exact_sets)
    for wordset, key in corpus.exact_sets.items():
        h = clf._nat.exact_hash(wordset)
        assert clf._exact_hashes[h] == key
        assert jax_native.load().exact_hash(wordset) == h
