"""The port's readme, package and auto modes against the JAX package:
`BatchClassifier.classify_blobs` rows on the cases of the JAX package's
`test_batch_mode.py`, `test_mode_auto.py` and `test_package_matchers.py`,
the Reference fallback's native scan against its Python path, and
`batch-detect` JSONL and sidecar bytes over a mixed crawl manifest
(`chip_smoke.write_mixed_manifest`, built from `tests/fixtures`), with
resume across the two packages.  Exact equality everywhere: the rows
are host regexes and exact integer scores finished in float64 by the
same arithmetic."""

import dataclasses
import json
import os

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import chip_smoke
from licensee_tpu.cli.main import main as jax_main
from licensee_tpu.kernels.batch import BatchClassifier as JaxBatchClassifier
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.kernels import batch
from licensee_tpu_torch.kernels.batch import BatchClassifier

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def fixture_bytes(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def rows(results):
    return [dataclasses.asdict(r) for r in results]


README_FIXTURES = [
    "readme/README.md",
    "mit/README.md",
    "license-with-readme-reference/README",
    "apache-with-readme-notice/README.md",
    "readme-invalid-encoding/README.md",
    "license-folder/README.md",
]
HTML_README = (
    b"<html><body><h1>Project</h1><p>stuff</p><h2>License</h2>"
    b"<p>Licensed under the MIT License.</p></body></html>"
)

# (filename, content) of the JAX package's package-matcher cases, under
# the filename that dispatches each matcher
PACKAGE_CASES = [
    *(("package.json", c) for c in (
        '"license": "mit"', "'license': 'mit'", "'license' : 'mit'",
        "foo: bar", "'license': 'foo'", "'license': 'UNLICENSED'",
        "'license': '(MIT OR Apache-2.0 OR AGPL-3.0+)'")),
    *(("project.gemspec", c) for c in (
        "s.license = 'mit'", "spec.license = 'mit'", "s.license = 'MIT'",
        "s.licenses = ['mit']", "s.license = 'mit'.freeze",
        "s.foo = 'bar'", "s.license = 'foo'",
        "s.licenses = ['mit', 'bsd-3-clause']")),
    *(("DESCRIPTION", f"Package: test\nLicense: {d}") for d in (
        "MIT", "MIT + file LICENSE", "GPL (>=2)", "GPL( >= 2 )", "GPL-3",
        "Foo")),
    ("DESCRIPTION", "Package: test"),
    *(("Cargo.toml", c) for c in (
        'license = "MIT"', "'license' = 'mit'", 'license = "Foo"',
        'license = "Apache-2.0 OR MIT"', 'foo = "bar"')),
    *(("dist.ini", c) for c in (
        "license = MIT", "license = Mozilla_2_0", "license = Foo",
        "foo = bar")),
    *(("LICENSE.spdx", c) for c in (
        "PackageLicenseDeclared: MIT", "PackageLicenseDeclared: xyz",
        "foo: bar")),
    *(("foo.cabal", f"license: {d}") for d in (
        "mit", "GPL-3", "LGPL-2.1", "BSD3", "AGPL-3")),
    *(("foo.nuspec", c) for c in (
        '<license type="expression">mit</license>',
        '<license type="expression">foo</license>',
        "<licenseUrl>https://licenses.nuget.org/Apache-2.0</licenseUrl>",
        "<licenseUrl>https://spdx.org/licenses/Apache-2.0.html</licenseUrl>",
        "<licenseUrl>http://www.apache.org/licenses/LICENSE-2.0</licenseUrl>",
        "<file>wrongelement</file>")),
    ("bower.json", '"license": "mit"'),
    ("gem.gemspec", fixture_bytes("gemspec/project._gemspec")),
    ("DESCRIPTION", fixture_bytes("description-license/DESCRIPTION")),
]


@pytest.fixture(scope="module")
def mixed_blobs():
    """The auto cases of the JAX package's tests, every readme fixture
    under README names, the package cases and unrouted names."""
    contents, names = [], []
    for rel in README_FIXTURES:
        contents.append(fixture_bytes(rel))
        names.append(os.path.basename(rel))
    contents += [HTML_README, HTML_README]
    names += ["README.html", "README.md"]
    for name, text in [
        ("LICENSE.txt", fixture_bytes("mit/LICENSE.txt")),
        ("LICENSE.md", fixture_bytes("gpl-3.0_markdown/LICENSE.md")),
        ("COPYING", fixture_bytes("lgpl/COPYING.lesser")),
        ("license.html", fixture_bytes("html/license.html")),
        ("main.c", b"int main(void) { return 0; }\n"),
        ("notes.txt", fixture_bytes("mit/LICENSE.txt")),
        ("readme.html", HTML_README),
        ("", b"Copyright (c) 2020 Foo"),
        *PACKAGE_CASES,
    ]:
        contents.append(text if isinstance(text, bytes) else text.encode())
        names.append(name)
    return contents, names


@pytest.mark.parametrize("mode", ["readme", "package", "auto"])
def test_classify_blobs_modes_match_jax(mixed_blobs, mode):
    contents, names = mixed_blobs
    ref = JaxBatchClassifier(mode=mode, mesh=None, pad_batch_to=16)
    ours = BatchClassifier(mode=mode, device="cpu", pad_batch_to=16)
    want = rows(ref.classify_blobs(contents, filenames=names))
    assert rows(ours.classify_blobs(contents, filenames=names)) == want
    matchers = {r["matcher"] for r in want}
    if mode != "package":
        assert "reference" in matchers and "exact" in matchers
    if mode != "readme":
        assert {"npmbower", "gemspec", "cran", "cargo", "distzilla", "spdx",
                "cabal", "nuget"} <= matchers
    if mode == "package":
        assert ours.corpus is None and ours.tensors is None


@pytest.mark.parametrize("name", [
    "LICENSE", "COPYING.md", "LICENSE-MIT.json", "PATENTS", "LICENSE.html",
    "README", "README.rst", "package.json", "COPYING.cabal", "LICENSE.spdx",
    "foo.nuspec", "dist.ini", "main.c", "readme.html", "", None,
])
def test_route_for_matches_jax(name):
    assert BatchClassifier.route_for(name) == JaxBatchClassifier.route_for(name)


def test_reference_patterns_match_jax():
    """Every license's source and reference patterns, the strings the
    Reference matcher and the native scan compile."""
    from licensee_tpu.corpus.license import License as JaxLicense
    from licensee_tpu_torch.corpus.license import License

    lics = License.all(hidden=True)
    assert [lic.key for lic in lics] == [
        lic.key for lic in JaxLicense.all(hidden=True)]
    for lic in lics:
        ref = JaxLicense.find(lic.key)
        assert lic.source_regex_pattern == ref.source_regex_pattern
        assert (lic.source_regex is None) == (ref.source_regex is None)
        assert lic.reference_regex.pattern == ref.reference_regex.pattern
        assert lic.reference_regex.flags == ref.reference_regex.flags
    union, ref_union = batch._reference_union()[1], None
    from licensee_tpu.kernels.batch import _reference_union

    ref_union = _reference_union()[1]
    assert union.pattern == ref_union.pattern


def test_reference_scan_native_matches_python_and_jax(monkeypatch):
    """The Reference fallback's PCRE2 scan (`refscan_resolve`) against
    the Python union scan (the LICENSEE_TPU_NO_NATIVE path) and the JAX
    package's answer, on sections that name licenses by title, key,
    nickname and source URL, several at once, inside other words, and
    none."""
    from licensee_tpu.kernels.batch import BatchClassifier as Jax
    from licensee_tpu_torch.corpus.license import License

    lics = License.all(hidden=True, pseudo=False)
    rng = np.random.default_rng(5)
    sections = ["", "no license named here", "MITライセンス", "LicenseMIT"]
    for i in range(60):
        picks = rng.choice(len(lics), size=1 + i % 3, replace=False)
        words = []
        for j in picks:
            lic = lics[int(j)]
            form = i % 4
            words.append(lic.name if form == 0 else lic.key if form == 1
                         else lic.key.upper() if form == 2
                         else f"https://spdx.org/licenses/{lic.meta.spdx_id}")
        sections.append("Released under " + " and ".join(words) + ".")
    assert batch._refscan_native() is not None
    native = [batch.BatchClassifier._reference_match(s) for s in sections]
    monkeypatch.setattr(batch, "_refscan_native", lambda: None)
    python = [batch.BatchClassifier._reference_match(s) for s in sections]
    want = [Jax._reference_match(s) for s in sections]
    keys = [[r.key if r else None for r in got] for got in (native, python)]
    assert keys[0] == keys[1] == [r.key if r else None for r in want]
    assert sum(k is not None for k in keys[0]) > 40


@pytest.fixture(scope="module")
def mixed_manifest(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixed")
    manifest = chip_smoke.write_mixed_manifest(np, str(root), 11, n_repos=60)
    with open(manifest, encoding="utf-8") as f:
        n = sum(1 for line in f if line.strip())
    return manifest, n


FLAG_SETS = {
    "auto-closest3-attribution": ["--mode", "auto", "--closest", "3",
                                  "--attribution"],
    "readme": ["--mode", "readme"],
    "package": ["--mode", "package"],
    "auto": ["--mode", "auto"],
}


# the counters that the rows decide; dedupe_hits is left out: in both
# packages it depends on whether the writer thread has cached a batch's
# results before the next batch is re-probed (ROADMAP, test budget)
STAT_KEYS = ("total", "prefiltered_copyright", "prefiltered_exact",
             "dice_matched", "reference_matched", "package_matched",
             "unmatched", "read_errors", "featurize_errors", "routed")


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_batch_detect_modes_jsonl_and_sidecar_match_jax(
        mixed_manifest, tmp_path, capsys, flags):
    """The rows and the sidecar byte for byte, and `--stats`: the JAX
    package's counters and route split (the port adds its device rows
    and dispatch split)."""
    manifest, n = mixed_manifest
    argv = [*FLAG_SETS[flags], "--batch-size", "64", "--stats"]
    ref, ours = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    stats = []
    for main, out, extra in ((jax_main, ref, []),
                             (port_main, ours, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(["batch-detect", manifest, "--output", str(out), *argv,
                     *extra]) == 0
        stats.append(json.loads(capsys.readouterr().err.splitlines()[-1]))
    for key in STAT_KEYS:
        assert stats[1].get(key) == stats[0].get(key), key
    want = ref.read_bytes()
    assert want.count(b"\n") == n
    assert ours.read_bytes() == want
    assert (tmp_path / "port.jsonl.meta.json").read_bytes() == (
        tmp_path / "jax.jsonl.meta.json").read_bytes()
    if flags.startswith("auto-closest"):
        assert b'"closest": [' in want and b'"attribution": ' in want
        assert b'"matcher": "reference"' in want
    if flags == "package":
        assert b'"corpus": null' in (tmp_path / "port.jsonl.meta.json"
                                     ).read_bytes()
    if flags.startswith("auto"):
        assert set(stats[1]["routed"]) == {"license", "readme", "package",
                                           "none"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_modes_resume_across_packages(mixed_manifest, tmp_path, writer):
    """Each package resumes the other's partial `--mode auto --closest 3
    --attribution` output (cut mid-line) to the full run's bytes, and
    refuses to resume it under another mode."""
    manifest, _n = mixed_manifest
    argv = FLAG_SETS["auto-closest3-attribution"]
    first, then = (jax_main, port_main) if writer == "jax" else (
        port_main, jax_main)
    extra = {jax_main: [], port_main: ["--device", "cpu"]}
    out = tmp_path / "out.jsonl"
    assert first(["batch-detect", manifest, "--output", str(out),
                  *argv, *extra[first]]) == 0
    full = out.read_bytes()
    out.write_bytes(full[: len(full) * 2 // 3])
    assert then(["batch-detect", manifest, "--output", str(out),
                 "--mode", "readme", *extra[then]]) == 1
    assert then(["batch-detect", manifest, "--output", str(out),
                 *argv, *extra[then]]) == 0
    assert out.read_bytes() == full
