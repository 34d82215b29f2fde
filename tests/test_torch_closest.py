"""`--closest` and `--attribution` in the port against the JAX package.

K4's top-k: `dice_ref.topk_candidates` (the plain version of
`dice_cuda.topk_exact`) against `dice_xla.topk_candidates` on random
planes, forced ties, all-excluded rows (the rounds that repeat template
0) and k from 1 to T; then `classify_blobs` rows with ``closest`` and
`attribution_for` on the vendored corpus (T=47) and on the 608-template
synthetic SPDX directory, the readme fallback's exclusion of a
late-matched key, and `batch-detect --closest 3 --attribution` JSONL
bytes.  Exact equality everywhere (integer triples; float64 scores from
the same integers by the same arithmetic).

Where k = T the reference's unrolled graph takes minutes to compile on
the CPU (T=608), so the reference there runs the same rounds with its
own `_argmax_exact` jitted once (`jax_rounds`), which the first test
holds to `dice_xla.topk_candidates` itself."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from licensee_tpu.cli.main import main as jax_main
from licensee_tpu.corpus import spdx as jax_spdx
from licensee_tpu.kernels import dice_xla
from licensee_tpu.kernels.batch import BatchClassifier as JaxBatchClassifier
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.corpus import spdx, spdx_synth
from licensee_tpu_torch.kernels import dice_cuda, dice_ref
from licensee_tpu_torch.kernels.batch import BatchClassifier

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
SPDX_T = 608

_argmax = jax.jit(dice_xla._argmax_exact)


def jax_rounds(num, den, k):
    """`dice_xla.topk_candidates`'s k masked rounds, each through the
    reference's `_argmax_exact` jitted once instead of one unrolled
    graph."""
    n, d = jnp.asarray(num), jnp.asarray(den)
    col = jnp.arange(n.shape[1], dtype=jnp.int32)[None, :]
    cols = []
    for _ in range(k):
        idx, nn, dd = _argmax(n, d)
        cols.append((idx, nn, dd))
        won = col == idx[:, None]
        n, d = jnp.where(won, -1, n), jnp.where(won, 1, d)
    return tuple(np.stack([np.asarray(c[i]) for c in cols], axis=1)
                 for i in range(3))


def planes(rng, B, T, case):
    num = rng.integers(0, 3000, (B, T)).astype(np.int32)
    den = rng.integers(1, 6000, (B, T)).astype(np.int32)
    if case == "ties":
        src = np.arange(T) % 3
        num, den = num[:, src], den[:, src]
        num[::2] = num[::2, :1]  # whole rows of one value
        den[::2] = den[::2, :1]
    out = rng.random((B, T)) < (1.0 if case == "excluded" else 0.1)
    out[1::2] &= case != "excluded"  # half the rows keep their entries
    num[out], den[out] = -1, 1
    return np.ascontiguousarray(num), np.ascontiguousarray(den)


_JITTED = {}


def jax_topk(num, den, k):
    """`dice_xla.topk_candidates`, jitted once per k (the planes of a
    test share one shape)."""
    fn = _JITTED.get(k)
    if fn is None:
        fn = _JITTED[k] = jax.jit(
            lambda n, d: dice_xla.topk_candidates(n, d, k))
    return [np.asarray(a) for a in fn(jnp.asarray(num), jnp.asarray(den))]


def mixed_planes(rng, B, T):
    """Rows of each case in one pair of planes: random, exact ties, and
    rows with every entry excluded (and half the rows of each with a
    tenth excluded)."""
    parts = [planes(rng, B, T, case) for case in ("random", "ties",
                                                  "excluded")]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def ours(num, den, k):
    return [t.numpy() for t in dice_ref.topk_candidates(
        torch.from_numpy(num), torch.from_numpy(den), k)]


@pytest.mark.parametrize("case", ["random", "ties", "excluded"])
@pytest.mark.parametrize("T, k", [(47, 1), (47, 4), (608, 4)])
def test_topk_candidates_match_jax(case, T, k):
    rng = np.random.default_rng(T * 10 + k)
    num, den = planes(rng, 21, T, case)
    want = jax_topk(num, den, k)
    got = ours(num, den, k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax_rounds(num, den, k), want):
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(dice_cuda.topk_exact(
        torch.from_numpy(num), torch.from_numpy(den), k)[0].numpy(), got[0])


@pytest.mark.parametrize("T", [47, 608])
def test_topk_candidates_at_k_equal_t_match_jax(T):
    """k = T: every template once, then (rows with excluded entries) the
    repeats of template 0 at (-1, 1) once the row is used up."""
    rng = np.random.default_rng(T)
    num, den = mixed_planes(rng, 4, T)
    got = ours(num, den, T)
    for a, b in zip(got, jax_rounds(num, den, T)):
        np.testing.assert_array_equal(a, b)
    excluded = got[0][8::2]  # the all-excluded rows of the third case
    assert (excluded == 0).all() and (got[1][8::2] == -1).all()


def fixture_blobs():
    contents, names = [], []
    for d, _dirs, files in sorted(os.walk(FIXTURES)):
        if os.path.relpath(d, FIXTURES).split(os.sep)[0] == "analysis":
            continue
        for f in sorted(files):
            if not f.endswith((".json", ".yml")):
                with open(os.path.join(d, f), "rb") as fh:
                    contents.append(fh.read())
                names.append(f)
    rng = np.random.default_rng(3)
    for i in range(0, len(contents), 3):  # mutations: closest lists of note
        text = contents[i].decode("utf-8", errors="ignore")
        contents.append(chip_smoke.mutate(text, rng, 0.05).encode())
        names.append(f"LICENSE-{i}")
    return contents, names


def rows(results):
    return [dataclasses.asdict(r) for r in results]


def rounds_fn(clf, k):
    """The JAX classifier's top-k scorer with `jax_rounds` for the
    unrolled top-k (the same first-max and masks)."""
    arrays = clf.arrays

    def fn(bits, n_words, lengths, cc_fp):
        num, den = dice_xla.score_pairs(arrays, bits, n_words, lengths,
                                        cc_fp, clf.method)
        return (*_argmax(num, den), *jax_rounds(num, den, k))

    return fn


@pytest.fixture(scope="module")
def spdx608(tmp_path_factory):
    src = spdx_synth.synth_spdx_dir(
        str(tmp_path_factory.mktemp("spdx") / "src"), SPDX_T, seed=4)
    return src, spdx.spdx_corpus(src), jax_spdx.spdx_corpus(src)


@pytest.mark.parametrize("corpus, closest", [
    ("vendored", 3), ("vendored", 47), ("spdx608", 3), ("spdx608", SPDX_T)])
def test_closest_rows_match_jax(spdx608, corpus, closest):
    contents, names = fixture_blobs()
    mine = ref_corpus = None
    if corpus == "spdx608":
        _src, mine, ref_corpus = spdx608
        contents = contents[::4]
        names = names[::4]
    ref = JaxBatchClassifier(corpus=ref_corpus, closest=closest, mesh=None,
                             pad_batch_to=64)
    T = ref.corpus.n_templates
    if closest >= T:
        ref._fn = rounds_fn(ref, T)
    port = BatchClassifier(corpus=mine, closest=closest, device="cpu",
                           pad_batch_to=64)
    want = rows(ref.classify_blobs(contents, filenames=names))
    got = rows(port.classify_blobs(contents, filenames=names))
    assert got == want
    lists = [r["closest"] for r in want if r["closest"] is not None]
    assert lists and max(len(c) for c in lists) == min(closest, T)


@pytest.mark.parametrize("corpus", ["vendored", "spdx608"])
def test_attribution_matches_jax(spdx608, corpus):
    """`attribution_for` on every matched row, under its own name, a
    COPYRIGHT name and a README route."""
    contents, names = fixture_blobs()
    mine = ref_corpus = None
    if corpus == "spdx608":
        _src, mine, ref_corpus = spdx608
    ref = JaxBatchClassifier(corpus=ref_corpus, mesh=None, pad_batch_to=64)
    port = BatchClassifier(corpus=mine, device="cpu", pad_batch_to=64)
    results = port.classify_blobs(contents, filenames=names)
    assert rows(results) == rows(ref.classify_blobs(contents,
                                                    filenames=names))
    seen = 0
    for raw, name, r in zip(contents, names, results):
        for fname, route in ((name, None), ("COPYRIGHT", None),
                             ("README.md", "readme")):
            got = port.attribution_for(raw, fname, r, route=route)
            assert got == ref.attribution_for(raw, fname, r, route=route)
            seen += got is not None
    assert seen > 5


def test_readme_fallback_excludes_late_matched_key():
    """A README whose section names the MIT License beside a text too
    mangled for Dice: the Reference fallback matches mit, and the
    candidate list, built while the row was unmatched, drops mit and
    still holds K entries."""
    from licensee_tpu_torch.corpus.license import License

    rng = np.random.default_rng(9)
    mangled = chip_smoke.mutate(License.find("mit").content, rng, 0.5)
    readme = (f"# Project\n\n## License\n\nThe MIT License.\n\n{mangled}\n"
              ).encode()
    ref = JaxBatchClassifier(mode="readme", closest=3, mesh=None)
    port = BatchClassifier(mode="readme", closest=3, device="cpu")
    want = rows(ref.classify_blobs([readme], filenames=["README.md"]))
    got = rows(port.classify_blobs([readme], filenames=["README.md"]))
    assert got == want
    assert (got[0]["key"], got[0]["matcher"]) == ("mit", "reference")
    assert len(got[0]["closest"]) == 3
    assert "mit" not in [k for k, _c in got[0]["closest"]]


def test_batch_detect_closest_attribution_jsonl_matches_jax(spdx608,
                                                           tmp_path):
    """At T=608; the vendored corpus's bytes are held in
    test_torch_modes.py (--mode auto --closest 3 --attribution)."""
    src = spdx608[0]
    flags = ["--closest", "3", "--attribution", "--batch-size", "64",
             "--corpus", src]
    manifest = chip_smoke.write_spdx_manifest(
        np, str(tmp_path / "rows"), src, seed=2, n_files=60)
    ref, out = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    assert jax_main(["batch-detect", manifest, "--output", str(ref),
                     *flags]) == 0
    assert port_main(["batch-detect", manifest, "--output", str(out),
                      "--device", "cpu", *flags]) == 0
    want = ref.read_bytes()
    assert b'"closest": [[' in want and b'"attribution": ' in want
    assert out.read_bytes() == want
    assert (tmp_path / "port.jsonl.meta.json").read_bytes() == (
        tmp_path / "jax.jsonl.meta.json").read_bytes()
