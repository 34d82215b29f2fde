"""The port's `detect` family against the JAX package: `detect` (text and
--json) over every fixture directory as a filesystem project and as a
git repository read by both of the port's git backends; `diff`,
`license-path`, `version`, `help` and the bare-path default; the
per-file matchers, `DiceXLA` on the CPU included; `License.rules`,
`fields` and `to_h`; `GitHubProject` over a stubbed contents API; and
`batch-detect` without --output.  The only difference allowed is the
package in `detect`'s ``Matcher:`` line and the program name in
`help`."""

import contextlib
import io
import json
import os
import shutil
import subprocess

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest
import torch

import licensee_tpu
import licensee_tpu_torch
from licensee_tpu.cli.main import main as jax_main
from licensee_tpu.corpus.vendoring import fixture_names
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.corpus import yamlite
from licensee_tpu_torch.matchers import dice_xla_matcher
from licensee_tpu_torch.projects import git_project

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)
# the tests ask for the CPU by name; nothing falls back to it
dice_xla_matcher.use_device("cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES_DIR = os.path.join(REPO, "tests", "fixtures")
FIXTURES = fixture_names()
GIT_ENV = {
    **os.environ,
    "GIT_CONFIG_GLOBAL": "/dev/null", "GIT_CONFIG_SYSTEM": "/dev/null",
    "GIT_AUTHOR_NAME": "n", "GIT_AUTHOR_EMAIL": "a@b",
    "GIT_COMMITTER_NAME": "n", "GIT_COMMITTER_EMAIL": "a@b",
    "GIT_AUTHOR_DATE": "1600000000 +0000",
    "GIT_COMMITTER_DATE": "1600000000 +0000",
}


def fixture(name: str) -> str:
    return os.path.join(FIXTURES_DIR, name)


@pytest.fixture(autouse=True)
def default_thresholds():
    """`detect --confidence` sets each package's global threshold, as the
    reference does; every test starts and ends at the default."""
    yield
    licensee_tpu.set_confidence_threshold(None)
    licensee_tpu_torch.set_confidence_threshold(None)


def run(main, argv, stdin=""):
    """(exit code, stdout, stderr) of one CLI call, ``stdin`` on stdin."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            _stdin(stdin):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


@contextlib.contextmanager
def _stdin(text):
    import sys

    saved, sys.stdin = sys.stdin, io.StringIO(text)
    try:
        yield
    finally:
        sys.stdin = saved


def both(argv, stdin=""):
    """The JAX CLI's and the port's results, the port's ``Matcher:``
    package named as the JAX package's."""
    want = run(jax_main, argv, stdin)
    rc, out, err = run(port_main, argv, stdin)
    out = out.replace("  licensee_tpu_torch.matchers.", "  licensee_tpu.matchers.")
    return want, (rc, out, err)


def make_git_repo(src: str, dst: str) -> str:
    """``src``'s tree committed at the root of a new repository."""
    shutil.copytree(src, dst)
    for args in (["init", "-q", "-b", "main"], ["add", "-A"],
                 ["commit", "-q", "--allow-empty", "-m", "x"]):
        subprocess.run(["git", "-C", dst, *args], check=True, env=GIT_ENV,
                       capture_output=True, timeout=60)
    return dst


@pytest.fixture(scope="module")
def git_repos(tmp_path_factory):
    root = tmp_path_factory.mktemp("repos")
    return {name: make_git_repo(fixture(name), str(root / name))
            for name in FIXTURES}


@pytest.fixture(params=["native", "subprocess"])
def git_backend(request, monkeypatch):
    """Each of the port's git backends in turn: the native object-store
    reader (which must be the one chosen), then git's plumbing."""
    opened = []
    pick = git_project.GitProject._open_backend

    def open_backend(repo, revision):
        if request.param == "subprocess":
            backend = git_project._SubprocessBackend(repo, revision)
        else:
            backend = pick(repo, revision)
        opened.append(backend)
        return backend

    monkeypatch.setattr(git_project.GitProject, "_open_backend",
                        staticmethod(open_backend))
    yield request.param
    kind = {"native": git_project._NativeBackend,
            "subprocess": git_project._SubprocessBackend}[request.param]
    assert opened and all(isinstance(b, kind) for b in opened)


@pytest.mark.parametrize("name", FIXTURES)
def test_detect_matches_jax(name):
    for extra in ([], ["--json"]):
        want, got = both(["detect", fixture(name), *extra])
        assert got == want, extra


@pytest.mark.parametrize("name", FIXTURES)
def test_detect_git_project_matches_jax(name, git_repos, git_backend):
    repo = git_repos[name]
    for extra in ([], ["--json"]):
        want, got = both(["detect", repo, *extra])
        assert got == want, extra


def test_detect_reads_the_repository_not_the_worktree(git_repos,
                                                      git_backend):
    """A git project reads the committed tree: a file removed from the
    work tree after the commit still counts."""
    repo = git_repos["mit"]
    moved = os.path.join(os.path.dirname(repo), "mit-LICENSE.txt")
    os.rename(os.path.join(repo, "LICENSE.txt"), moved)
    try:
        want, got = both(["detect", repo])
    finally:
        os.rename(moved, os.path.join(repo, "LICENSE.txt"))
    assert got == want
    assert "LICENSE.txt:" in got[1]


def test_fixtures_yml_golden():
    """Every fixture's key, matcher and content hash from the port's
    project, against fixtures.yml read by the port's own reader."""
    with open(fixture("fixtures.yml"), encoding="utf-8") as fh:
        golden = yamlite.load_document(fh.read())
    assert set(golden) == set(FIXTURES)
    for name in FIXTURES:
        project = licensee_tpu_torch.project(
            fixture(name), detect_packages=True, detect_readme=True)
        lf = project.license_file
        got = {
            "key": project.license.key if project.license else None,
            "matcher": lf.matcher.name if lf and lf.matcher else None,
            "hash": lf.content_hash if lf else None,
        }
        want = {k: golden[name].get(k) for k in got} if golden[name] else {
            k: None for k in got}
        assert got == want, name


def test_detect_json_golden(tmp_path):
    """`detect --json` against detect.json, the case built as
    tests/test_cli.py::test_detect_json_full_golden builds it."""
    with open(fixture("detect.json"), encoding="utf-8") as fh:
        golden = json.load(fh)
    (tmp_path / "LICENSE.md").write_text(
        golden["matched_files"][0]["content"], encoding="utf-8")
    (tmp_path / "licensee.gemspec").write_text(
        golden["matched_files"][1]["content"], encoding="utf-8")
    rc, out, _err = run(port_main, ["detect", "--json", str(tmp_path)])
    assert rc == 0
    got = json.loads(out)
    golden["matched_files"][1].pop("content")
    got["matched_files"][1].pop("content")
    assert got == golden


@pytest.mark.parametrize("argv", [
    ["detect", "--confidence", "90", "bsd-3-lists"],
    ["detect", "--confidence", "90", "--json", "bsd-3-lists"],
    ["detect", "--confidence", "90", "pixar-modified-apache"],
    ["detect", "--confidence", "85", "--json", "wrk-modified-apache"],
    ["detect", "--no-readme", "mit"],
    ["detect", "--no-packages", "gemspec"],
    ["detect", "--no-readme", "--no-packages", "--json", "readme"],
    ["detect", "lgpl"],
    ["detect", "--json", "lgpl"],
    ["detect", "multiple-license-files"],
    ["detect", "--json", "multiple-license-files"],
    ["detect", "license-in-parent-folder"],
    ["detect", "bsd-2-author", "--diff"],
    ["detect", "mit", "--license", "mit"],
    ["detect", "bsd-2-author", "--license", "no-such-license"],
    ["mit"],
    ["--json", "apache-2.0_markdown"],
    ["diff", "mit", "--license", "mit"],
    ["diff", "bsd-2-author", "--license", "bsd-2-clause"],
    ["diff", "mit", "--license", "not-a-license"],
    ["diff", "mit"],
    ["diff", "ipsum.txt", "--license", "mit"],
    ["license-path", "mit"],
    ["license-path", "readme"],
    ["license-path", "gpl-3.0_markdown"],
    ["version"],
], ids=lambda argv: "-".join(argv))
def test_verbs_match_jax(argv):
    """detect's flags, the bare-path default, `diff` (exact, word diff,
    invalid license, no --license), `license-path` present and missing,
    and `version`, each against the JAX CLI: exit code, stdout, stderr."""
    argv = [fixture(a) if os.path.exists(fixture(a)) else a for a in argv]
    want, got = both(argv)
    assert got == want


def test_diff_reads_stdin():
    with open(fixture(os.path.join("bsd-2-author", "LICENSE")),
              encoding="utf-8") as fh:
        text = fh.read()
    for license in ("bsd-2-clause", "mit"):
        want, got = both(["diff", "--license", license], stdin=text)
        assert got == want
        assert got[0] == 0 and "Comparing to" in got[1]
    with open(fixture(os.path.join("mit", "LICENSE.txt")),
              encoding="utf-8") as fh:
        want, got = both(["diff", "--license", "mit"], stdin=fh.read())
    assert got == want


def test_diff_socket_waits_for_serve():
    """`diff --socket` with no `serve` worker behind the socket fails as
    the JAX CLI's does (tests/test_torch_serve.py drives it against a
    live worker)."""
    argv = ["diff", fixture("mit"), "--socket", "/nonexistent.sock"]
    rc, out, err = run(port_main, argv)
    assert rc != 0 and not out
    assert "cannot reach worker" in err
    assert (rc, out, err) == run(jax_main, argv)


def test_help_matches_jax():
    """The listing names the port's program and the reference's verbs
    with the JAX package's texts; each shared verb's own help is the JAX
    package's, the program name (and the line wrapping it moves)
    aside."""
    _rc, jax_out, _ = run(jax_main, ["help"])
    rc, out, _ = run(port_main, ["help"])
    assert rc == 0 and out.startswith("Licensee commands:\n")
    jax_lines = {line.split()[1]: line for line in jax_out.splitlines()[1:]}
    port_lines = {line.split()[1]: line for line in out.splitlines()[1:]}
    assert {"detect", "diff", "license-path", "version", "help",
            "batch-detect", "corpus-build", "serve", "stats", "traces",
            "slo", "top", "alerts", "fleet", "jobs"} == set(port_lines)
    for verb in ("detect", "diff", "license-path", "version", "help",
                 "corpus-build", "serve", "stats", "traces", "slo", "top",
                 "alerts", "fleet", "jobs"):
        assert port_lines[verb].replace("licensee-tpu-torch",
                                        "licensee-tpu") == jax_lines[verb]
    for verb in ("detect", "diff", "license-path", "version", "help",
                 "stats", "traces", "slo", "top", "alerts"):
        want = run(jax_main, ["help", verb])
        got = run(port_main, ["help", verb])
        assert got[0] == want[0] == 0
        # argparse wraps the usage lines by the program name's length
        assert got[1].replace("licensee-tpu-torch", "licensee-tpu").split() \
            == want[1].split(), verb


def stub_contents_api(name):
    """A `GitHubProject._request` that serves the contents API from a
    fixture directory (the reference's WebMock pattern): nothing leaves
    the process."""
    def request(self, path, raw=False):
        root = fixture(name)
        if not path:
            return [{"name": n, "type": "file", "path": n}
                    for n in sorted(os.listdir(root))
                    if os.path.isfile(os.path.join(root, n))]
        full = os.path.join(root, path)
        if not os.path.exists(full):
            return None
        with open(full, "rb") as fh:
            return fh.read()
    return request


@pytest.mark.parametrize("argv", [
    ["detect", "--remote", "benbalter/licensee"],
    ["detect", "--json", "https://github.com/benbalter/licensee"],
    ["--remote", "benbalter/licensee", "--ref", "v1"],
    ["license-path", "--remote", "benbalter/licensee"],
], ids=["remote", "url-json", "bare-remote-ref", "license-path"])
def test_remote_verbs_match_jax(argv, monkeypatch):
    """The verbs over a GitHub project (`--remote OWNER/REPO` or a URL),
    the contents API stubbed in both packages."""
    from licensee_tpu.projects import GitHubProject as JaxGitHubProject
    from licensee_tpu_torch.projects import GitHubProject

    for cls in (JaxGitHubProject, GitHubProject):
        monkeypatch.setattr(cls, "_request", stub_contents_api("lgpl"))
    want, got = both(argv)
    assert got == want
    assert got[0] == 0 and got[1]


def test_github_project_through_a_stubbed_api():
    """GitHubProject over the contents API served from a fixture
    directory (the reference's WebMock pattern): the same license,
    files and hash as the JAX package's, and RepoNotFound for an empty
    listing."""
    from licensee_tpu.projects import GitHubProject as JaxGitHubProject
    from licensee_tpu_torch.projects import GitHubProject, RepoNotFound

    for name in ("mit", "lgpl", "readme", "multiple-license-files"):
        url = "https://github.com/benbalter/licensee.git"
        ours = type("Stub", (GitHubProject,), {
            "_request": stub_contents_api(name)})(
            url, detect_readme=True, detect_packages=True)
        ref = type("Stub", (JaxGitHubProject,), {
            "_request": stub_contents_api(name)})(
            url, detect_readme=True, detect_packages=True)
        assert ours.repo == ref.repo == "benbalter/licensee"
        assert ours.to_h() == ref.to_h(), name
        assert [f.path for f in ours.license_files] == [
            f.path for f in ref.license_files]
    empty = type("Stub", (GitHubProject,), {
        "_request": lambda self, path, raw=False: None if raw else []})(
        "https://github.com/o/r")
    with pytest.raises(RepoNotFound):
        empty.files()
    with pytest.raises(ValueError):
        GitHubProject("https://gitlab.com/o/r")


# -- the per-file matchers -------------------------------------------------

MATCHER_FIXTURES = sorted(
    name for name in os.listdir(FIXTURES_DIR)
    if os.path.isdir(fixture(name))
)


def license_files(name):
    from licensee_tpu.projects import FSProject as JaxFSProject
    from licensee_tpu_torch.projects import FSProject

    return [
        cls(fixture(name), detect_packages=False, detect_readme=False)
        .license_file
        for cls in (JaxFSProject, FSProject)
    ]


def ranked(matches):
    return [(lic.key, sim) for lic, sim in matches]


@pytest.mark.parametrize("name", MATCHER_FIXTURES)
def test_matchers_match_jax(name):
    """Copyright, Exact, Dice and DiceXLA on each fixture's license file:
    the same match, the same confidence (float64, compared with ==), and
    Dice's whole ranking in the reference's order (a stable sort, then
    reversed, so ties come out in reverse candidate order)."""
    from licensee_tpu import matchers as jm
    from licensee_tpu_torch import matchers as pm

    ref, ours = license_files(name)
    if ref is None:
        assert ours is None
        return
    assert ours.content == ref.content
    for cls in ("Copyright", "Exact", "Dice", "DiceXLA"):
        want, got = getattr(jm, cls)(ref), getattr(pm, cls)(ours)
        assert (got.match.key if got.match else None) == (
            want.match.key if want.match else None), cls
        assert got.confidence == want.confidence, cls
        assert type(got.confidence) is type(want.confidence), cls
    assert ranked(pm.Dice(ours).matches_by_similarity) == ranked(
        jm.Dice(ref).matches_by_similarity)
    assert [lic.key for lic in pm.Dice(ours).potential_matches] == [
        lic.key for lic in jm.Dice(ref).potential_matches]
    # DiceXLA is the scalar Dice's drop-in: same key, same confidence
    dice, xla = pm.Dice(ours), pm.DiceXLA(ours)
    assert (xla.match, xla.confidence) == (dice.match, dice.confidence)
    # and the chain's first match, with its matcher
    assert (ours.matcher.name if ours.matcher else None) == (
        ref.matcher.name if ref.matcher else None)
    assert ours.to_h() == ref.to_h()


def test_dice_xla_skips_the_prefilters():
    """Inside the chain, DiceXLA answers as Dice does on a copyright-only
    file (Copyright, ahead of it, owns that answer), at any threshold."""
    from licensee_tpu_torch.matchers import Dice, DiceXLA
    from licensee_tpu_torch.project_files import LicenseFile

    file = LicenseFile("Copyright (c) 2024 Ben Balter", "LICENSE")
    assert Dice(file).match is None
    assert DiceXLA(file).match is None and DiceXLA(file).confidence == 0
    _ref, ours = license_files("pixar-modified-apache")  # 97.89% apache-2.0
    assert Dice(ours).match is None
    licensee_tpu_torch.set_confidence_threshold(90)
    dice, xla = Dice(ours), DiceXLA(ours)
    assert dice.match is not None
    assert (xla.match, xla.confidence) == (dice.match, dice.confidence)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_classify_blobs_without_prefilters_matches_jax(native, monkeypatch):
    """``prefilter=False`` (the DiceXLA matcher's call) on a copyright-only
    blob, a verbatim template and a license with a preamble, on the
    native featurizer and on the Python one: the JAX package's rows."""
    from licensee_tpu.kernels.batch import BatchClassifier as JaxClassifier
    from licensee_tpu_torch.kernels.batch import BatchClassifier
    from licensee_tpu_torch.native import pipeline

    if not native:
        monkeypatch.setattr(pipeline, "load", lambda: None)
    ours = BatchClassifier(device="cpu", pad_batch_to=8)
    assert (ours._nat is not None) == native
    with open(fixture(os.path.join("mit", "LICENSE.txt")), "rb") as fh:
        mit = fh.read()
    blobs = [b"Copyright (c) 2024 Ben Balter\n", mit,
             b"Some preamble.\n\n" + mit, b""]
    ref = JaxClassifier(mesh=None, pad_batch_to=8)
    for prefilter in (True, False):
        want = ref.classify_blobs(blobs, prefilter=prefilter)
        got = ours.classify_blobs(blobs, prefilter=prefilter)
        assert [(r.key, r.matcher, r.confidence, r.error) for r in got] == [
            (r.key, r.matcher, r.confidence, r.error) for r in want]
    assert got[1].matcher == "dice" and got[0].key is None


def test_dice_xla_runs_on_the_card_by_default(monkeypatch):
    """Without `use_device`, the shared classifier is built on the CUDA
    device: here, without a card, the first match raises."""
    from licensee_tpu_torch.matchers import DiceXLA

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(dice_xla_matcher, "_device", "cuda")
    monkeypatch.setattr(dice_xla_matcher, "_classifier", None)
    _ref, ours = license_files("mit")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiceXLA(ours).match


def test_batch_threshold_ignores_the_global():
    """`batch-detect` and `BatchClassifier` take their threshold from the
    caller or the default, never from `set_confidence_threshold`."""
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    with open(fixture(os.path.join("pixar-modified-apache", "LICENSE.txt")),
              "rb") as fh:
        blob = fh.read()
    classifier = BatchClassifier(device="cpu", pad_batch_to=8)
    before = classifier.classify_blobs([blob])[0]
    licensee_tpu_torch.set_confidence_threshold(50)
    assert classifier.classify_blobs([blob])[0] == before
    assert before.key is None
    assert classifier.classify_blobs([blob], threshold=90)[0].key == \
        "apache-2.0"


# -- the License model ------------------------------------------------------

LICENSE_KEYS = [lic.key for lic in licensee_tpu.licenses(hidden=True)]


@pytest.mark.parametrize("key", LICENSE_KEYS)
def test_license_hash_matches_jax(key):
    """rules, fields and to_h (meta with its `using` map included), and
    the other accessors detect reads, against the JAX package's."""
    from licensee_tpu.corpus.license import License as JaxLicense
    from licensee_tpu_torch.corpus.license import License

    ref, ours = JaxLicense.find(key), License.find(key)
    assert ours.to_h() == ref.to_h()
    assert ours.rules.to_h() == ref.rules.to_h()
    assert [r.tag for r in ours.rules.flatten()] == [
        r.tag for r in ref.rules.flatten()]
    assert [(f.key, f.label, str(f), f.raw_text) for f in ours.fields] == [
        (f.key, f.label, str(f), f.raw_text) for f in ref.fields]
    assert (ours.url, ours.other_q, ours.cc_q, ours.name, str(ours)) == (
        ref.url, ref.other_q, ref.cc_q, ref.name, str(ref))
    if ours.content:
        assert ours.content_for_mustache == ref.content_for_mustache
    if ours.title:
        assert License.find_by_title(ours.title) == License.find(
            getattr(JaxLicense.find_by_title(ref.title), "key", ""))


def test_facade_matches_jax():
    assert licensee_tpu_torch.__version__ == licensee_tpu.__version__
    assert [lic.key for lic in licensee_tpu_torch.licenses()] == [
        lic.key for lic in licensee_tpu.licenses()]
    for options in ({"hidden": True}, {"featured": True},
                    {"pseudo": False}, {"psuedo": False, "hidden": True}):
        assert [lic.key for lic in licensee_tpu_torch.licenses(**options)] \
            == [lic.key for lic in licensee_tpu.licenses(**options)]
    for name in ("mit", "lgpl", "multiple-license-files", "ipsum.txt"):
        ours = licensee_tpu_torch.license(fixture(name))
        ref = licensee_tpu.license(fixture(name))
        assert (ours.key if ours else None) == (ref.key if ref else None)
    licensee_tpu.set_confidence_threshold(90)
    licensee_tpu_torch.set_confidence_threshold(90)
    assert licensee_tpu_torch.inverse_confidence_threshold() == \
        licensee_tpu.inverse_confidence_threshold() == 0.1


# -- batch-detect without --output ------------------------------------------


@pytest.fixture(scope="module")
def stdout_manifest(tmp_path_factory):
    """Every fixture's files, a verbatim copy, a repeated path, a path
    that cannot be read, a file past the 64 KiB cap, and a tar holding
    two fixture directories as a container entry."""
    import tarfile

    root = tmp_path_factory.mktemp("stdout")
    paths = sorted(
        os.path.join(d, f)
        for d, _dirs, files in os.walk(FIXTURES_DIR)
        if os.path.relpath(d, FIXTURES_DIR).split(os.sep)[0] != "analysis"
        for f in files if not f.endswith((".json", ".yml"))
    )
    big = root / "big" / "LICENSE"
    big.parent.mkdir()
    big.write_bytes(b"Permission is hereby granted. " * 4000)
    arch = root / "repos.tar"
    with tarfile.open(arch, "w") as tf:
        for name in ("mit", "lgpl"):
            tf.add(fixture(name), arcname=name)
    paths += [paths[3], str(root / "missing" / "LICENSE"), str(big),
              f"{arch}::*", f"{arch}::mit/LICENSE.txt"]
    manifest = root / "manifest.txt"
    manifest.write_text("\n".join(paths) + "\n", encoding="utf-8")
    return str(manifest), root


@pytest.mark.parametrize("flags", [
    [],
    ["--mode", "auto", "--closest", "3", "--attribution"],
], ids=["license", "auto-closest3-attribution"])
def test_batch_detect_stdout_matches_jax(stdout_manifest, flags):
    """The rows on stdout equal the JAX CLI's and the port's own --output
    bytes (and the container verdicts follow them as the verdict file
    holds them); read errors and the oversized file are counted as the
    pipeline counts them."""
    manifest, root = stdout_manifest
    argv = ["batch-detect", manifest, *flags, "--stats"]
    jax_rc, jax_out, jax_err = run(jax_main, [*argv, "--mesh", "none"])
    rc, out, err = run(port_main, [*argv, "--device", "cpu",
                                   "--batch-size", "64"])
    assert rc == jax_rc == 0
    assert out == jax_out
    with open(manifest, encoding="utf-8") as fh:
        n_entries = len(fh.read().split())
    rows = out.splitlines()
    assert '"error": "read_error"' in out and '"error": "oversized"' in out
    tag = "-".join(flags) or "license"
    output = str(root / f"{tag}.jsonl")
    rc2, _out, err2 = run(port_main, [*argv, "--device", "cpu",
                                      "--output", output])
    assert rc2 == 0
    with open(output, encoding="utf-8") as fh:
        written = fh.read()
    with open(output + ".containers.jsonl", encoding="utf-8") as fh:
        verdicts = fh.read()
    n_rows = written.count("\n")
    assert n_entries < n_rows < len(rows)
    assert "\n".join(rows[:n_rows]) + "\n" == written
    assert "\n".join(rows[n_rows:]) + "\n" == verdicts
    stats, piped = json.loads(err.splitlines()[-1]), json.loads(
        err2.splitlines()[-1])
    want = json.loads(jax_err.splitlines()[-1])
    for key in ("total", "read_errors", "skipped_oversized", "dice_matched",
                "prefiltered_exact", "prefiltered_copyright", "unmatched",
                "featurize_errors", "reference_matched", "package_matched"):
        assert stats[key] == want[key] == (
            piped[key] if key != "unmatched" else stats[key]), key
    assert stats["read_errors"] == 1 and stats["skipped_oversized"] == 1


def test_batch_detect_needs_a_manifest():
    rc, out, err = run(port_main, ["batch-detect"])
    assert rc == 1 and not out and "manifest" in err


def test_chip_smoke_phase8_on_cpu(tmp_path):
    """chip_smoke.py's phase 8 on the CPU: `detect` against fixtures.yml
    and detect.json (and the Python-written git repositories through the
    native backend), the other verbs, DiceXLA against Dice, and
    `batch-detect` on stdout against its --output rows."""
    import numpy as np

    import chip_smoke

    assert len(chip_smoke.detect_fixtures(str(tmp_path))) == len(FIXTURES)
    chip_smoke.other_verbs()
    n_files, _launches, per_file_ms, graph_ms = chip_smoke.dice_xla_on_card(
        torch, "cpu")
    assert n_files > 40 and per_file_ms > 0 and graph_ms is None
    manifest = chip_smoke.write_manifest(np, str(tmp_path / "m"), 0,
                                         n_files=120)
    out, _launches, stats = chip_smoke.stdout_rows(torch, str(tmp_path),
                                                   manifest, "cpu")
    assert out.count("\n") == stats["total"] == 120
    assert stats["read_errors"] == 1 and stats["dice_matched"] > 0
