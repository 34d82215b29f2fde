"""Containers in the port's `batch-detect` manifests, against the JAX
package, on the CPU.

Tar, ``.tar.gz`` and zip archives (as ``::*`` and as ``::LICENSE``), git
checkouts (``repo::HEAD``) and bare repositories (``repo.git::<sha>``),
a member past the 64 KiB cap, a zip member whose CRC fails, an
unrecognised URL shape (a loose path) and loose files, in one manifest:
the JSONL rows, ``OUT.containers.jsonl`` and the ``.meta.json`` sidecar
byte-identical to the JAX package's CLI, in the license mode and in
``--mode auto --closest 3 --attribution`` (members route by their own
basename), with worker processes, and with each package resuming the
other's partial output.  A torn archive and a remote git repository
refuse the manifest in both packages; a remote archive over the
loopback host gives the same bytes in both.  Exact equality
everywhere."""

import io
import json
import os
import subprocess
import tarfile
import zipfile

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest
import torch

from licensee_tpu.cli.main import main as jax_main
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.ingest import sources
from licensee_tpu_torch.ingest.sources import IngestError, expand_manifest

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")

GIT_ENV = {
    **os.environ,
    "GIT_CONFIG_GLOBAL": "/dev/null",
    "GIT_CONFIG_SYSTEM": "/dev/null",
}


def fixture(rel: str) -> bytes:
    with open(os.path.join(FIXTURES, rel), "rb") as f:
        return f.read()


def make_tar(path, files: dict, mode: str = "w") -> str:
    with tarfile.open(path, mode) as tf:
        for name, data in files.items():
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            info.mtime = 1_600_000_000
            tf.addfile(info, io.BytesIO(data))
    return str(path)


def make_zip(path, files: dict) -> str:
    with zipfile.ZipFile(path, "w") as zf:
        for name, data in files.items():
            zf.writestr(name, data)
    return str(path)


def git(repo: str, *args: str) -> str:
    return subprocess.run(["git", "-C", repo, *args], check=True,
                          capture_output=True, env=GIT_ENV,
                          text=True).stdout.strip()


def make_repo(path: str, files: dict) -> str:
    os.makedirs(path)
    git(path, "init", "-q")
    for name, data in files.items():
        os.makedirs(os.path.dirname(os.path.join(path, name)), exist_ok=True)
        with open(os.path.join(path, name), "wb") as f:
            f.write(data)
    git(path, "add", ".")
    git(path, "-c", "user.email=a@b", "-c", "user.name=n", "commit", "-qm",
        "x")
    return path


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Every container shape, listed with loose files, in one manifest."""
    root = tmp_path_factory.mktemp("containers")
    mit = fixture("mit/LICENSE.txt")
    lgpl = fixture("lgpl/COPYING.lesser")
    gpl = fixture("lgpl/LICENSE")
    readme = fixture("readme/README.md")
    pkg = b'{\n  "name": "x",\n  "license": "MIT"\n}\n'
    big = mit + b"\n" + b"x" * (70 * 1024)  # past the 64 KiB cap
    d = root / "d"
    d.mkdir()
    tar = make_tar(d / "a.tar", {
        "proj-1.0/LICENSE": mit, "proj-1.0/README.md": readme,
        "proj-1.0/package.json": pkg, "proj-1.0/src/main.c": b"int x;\n",
        "proj-1.0/LICENSE-BIG": big})
    tgz = make_tar(d / "b.tar.gz", {
        "COPYING": gpl, "COPYING.lesser": lgpl, "README": readme,
        "LICENSE-MIT": mit}, mode="w:gz")
    zf = make_zip(d / "c.zip", {
        "LICENSE": fixture("apache-2.0_markdown/LICENSE.md"),
        "COPYRIGHT": b"Copyright (c) 2020 Example Authors\n",
        "package.json": pkg, "docs/LICENSE": mit})
    # a zip whose member fails its CRC: a read_error in its row
    bad = make_zip(d / "crc.zip", {"LICENSE": mit})
    blob = bytearray(open(bad, "rb").read())
    at = blob.index(mit[:40])
    blob[at] ^= 0xFF
    with open(bad, "wb") as f:
        f.write(bytes(blob))
    repo = make_repo(str(root / "repo"), {
        "LICENSE": fixture("gpl-3.0_markdown/LICENSE.md"),
        "README.md": readme, "LICENSE-BIG": big, "sub/LICENSE": mit})
    bare = str(root / "bare.git")
    subprocess.run(["git", "clone", "-q", "--bare", repo, bare], check=True,
                   capture_output=True, env=GIT_ENV)
    sha = git(bare, "rev-parse", "HEAD")
    loose = root / "loose"
    loose.mkdir()
    (loose / "LICENSE").write_bytes(mit)
    (loose / "COPYING").write_bytes(gpl)
    entries = [
        str(loose / "LICENSE"),
        f"{tar}::*",
        f"{tar}::proj-1.0/LICENSE",
        f"{tgz}::*",
        f"{tgz}::COPYING",
        str(loose / "COPYING"),
        f"{zf}::*",
        f"{zf}::LICENSE",
        f"{bad}::LICENSE",
        f"{repo}::HEAD",
        f"{bare}::{sha}",
        f"{tar}::proj-1.0/package.json",
        "https://example.invalid/not-an-archive::LICENSE",
        str(root / "missing" / "LICENSE"),
    ]
    path = root / "manifest.txt"
    path.write_text("\n".join(entries) + "\n")
    return str(path), root


def run(main, manifest_path, out, *flags) -> int:
    extra = ["--device", "cpu"] if main is port_main else []
    return main(["batch-detect", manifest_path, "--output", str(out),
                 "--batch-size", "8", *flags, *extra])


def outputs(out) -> tuple:
    return tuple(open(f"{out}{suffix}", "rb").read()
                 for suffix in ("", ".containers.jsonl", ".meta.json"))


FLAGS = {
    "license": [],
    "auto-closest3-attribution": ["--mode", "auto", "--closest", "3",
                                  "--attribution"],
}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_rows_containers_and_sidecar_match_jax(manifest, tmp_path, flags):
    path, _root = manifest
    ref, ours = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    assert run(jax_main, path, ref, *FLAGS[flags]) == 0
    assert run(port_main, path, ours, *FLAGS[flags]) == 0
    want = outputs(ref)
    assert outputs(ours) == want
    rows = [json.loads(line) for line in want[0].splitlines()]
    by_path = {}
    for r in rows:
        by_path.setdefault(r["path"], r)
    # the shapes the gate covers really occur
    assert by_path["proj-1.0/LICENSE-BIG"]["error"] == "oversized"
    assert any(r["path"].endswith("crc.zip::LICENSE")
               and r.get("error") == "read_error" for r in rows)
    if not flags.startswith("auto"):  # auto reads no unrouted name
        assert by_path["https://example.invalid/not-an-archive::LICENSE"][
            "error"] == "read_error"
    assert by_path["proj-1.0/LICENSE"]["key"] == "mit"
    containers = [json.loads(line) for line in want[1].splitlines()]
    assert len(containers) == 9  # 6 spans, 3 listed-member subsets
    assert {c["license"] for c in containers} >= {"mit", "gpl-3.0", "other"}
    assert json.loads(want[2])["ingest"] is not None
    if flags.startswith("auto"):
        # members route by their own basename: the package manifest
        # through the package matchers, the README through the readme
        # chain, the source file unread
        assert by_path["proj-1.0/package.json"]["matcher"] == "npmbower"
        assert by_path["proj-1.0/src/main.c"]["key"] is None
        assert any("attribution" in r for r in rows)
        assert any("closest" in r for r in rows)


def test_featurize_procs_match_jax(manifest, tmp_path):
    """Worker processes reopen the containers from the expansion's
    descriptor and read by index: the same bytes."""
    path, _root = manifest
    ref, ours = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    assert run(jax_main, path, ref) == 0
    assert run(port_main, path, ours, "--featurize-procs", "2") == 0
    assert outputs(ours) == outputs(ref)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(manifest, tmp_path, writer):
    """Each package resumes the other's output cut mid-container to the
    full run's rows, container verdicts and sidecar."""
    path, _root = manifest
    first, then = (jax_main, port_main) if writer == "jax" else (
        port_main, jax_main)
    out = tmp_path / "out.jsonl"
    assert run(first, path, out) == 0
    full = outputs(out)
    cut = full[0][: len(full[0]) // 2]
    out.write_bytes(cut)
    os.remove(f"{out}.containers.jsonl")
    assert run(then, path, out) == 0
    assert outputs(out) == full


def test_rewritten_archive_refuses_resume(tmp_path):
    """The sidecar's expansion fingerprint: a tar repacked with the same
    member names under another mtime refuses the resume."""
    mit = fixture("mit/LICENSE.txt")
    tar = make_tar(tmp_path / "a.tar", {"LICENSE": mit, "COPYING": mit})
    path = tmp_path / "m.txt"
    path.write_text(f"{tar}::*\n")
    out = tmp_path / "out.jsonl"
    assert run(port_main, str(path), out) == 0
    out.write_bytes(out.read_bytes().splitlines(keepends=True)[0])
    with tarfile.open(tar, "w") as tf:
        for name in ("LICENSE", "COPYING"):
            info = tarfile.TarInfo(name=name)
            info.size = len(mit)
            info.mtime = 1_700_000_000
            tf.addfile(info, io.BytesIO(mit))
    assert run(port_main, str(path), out) == 1
    assert run(jax_main, str(path), out) == 1


@pytest.mark.parametrize("shape", ["tar", "tar.gz", "zip"])
def test_torn_archive_refuses_the_manifest(tmp_path, capsys, shape):
    """A torn archive fails closed in both packages: a non-zero exit
    before any row is written."""
    mit = fixture("mit/LICENSE.txt")
    if shape == "zip":
        arch = make_zip(tmp_path / "t.zip", {"LICENSE": mit * 4})
    else:
        mode = "w:gz" if shape == "tar.gz" else "w"
        arch = make_tar(tmp_path / f"t.{shape}", {"LICENSE": mit * 4}, mode)
    with open(arch, "r+b") as f:
        f.truncate(min(1000, os.path.getsize(arch) // 2))  # mid-member
    path = tmp_path / "m.txt"
    path.write_text(f"{tmp_path / 'LICENSE'}\n{arch}::*\n")
    errs = []
    for main, name in ((jax_main, "jax"), (port_main, "port")):
        out = tmp_path / f"{name}.jsonl"
        capsys.readouterr()
        assert run(main, str(path), out) == 1
        assert not out.exists()
        errs.append(capsys.readouterr().err)
    assert errs[1] == errs[0] and arch in errs[0]


@pytest.mark.parametrize("url", [
    "pkg-1.0.tar.gz",
    "pkg.tar",
    "pkg.whl.zip?x=1",
    "repo.git",
])
def test_remote_container_refuses_the_manifest(tmp_path, capsys, url):
    """A remote container, served from the loopback host: an archive
    (tar, compressed tar, zip; a query string is the URL's own) gives
    the JAX CLI's JSONL, container verdicts and sidecar byte for byte;
    a remote git repository refuses the manifest in both packages with
    the same message, before a row is written."""
    from licensee_tpu_torch.ingest.loopback import LoopbackBlobHost

    files = {"LICENSE": fixture("mit/LICENSE.txt"),
             "COPYING": fixture("bsd-2-author/LICENSE")}
    name = url.split("?", 1)[0]
    if name.endswith(".tar.gz"):
        blob = open(make_tar(tmp_path / "a.tgz", files, "w:gz"), "rb").read()
    elif name.endswith(".tar"):
        blob = open(make_tar(tmp_path / "a.tar", files), "rb").read()
    elif name.endswith(".zip"):
        blob = open(make_zip(tmp_path / "a.zip", files), "rb").read()
    else:
        blob = b"not a repository"
    loose = tmp_path / "LICENSE"
    loose.write_bytes(fixture("mit/LICENSE.txt"))
    with LoopbackBlobHost({name: blob}) as host:
        full = host.url(url)
        entry = full + "::*"
        assert sources.is_container_entry(entry)
        path = tmp_path / "m.txt"
        path.write_text(f"{loose}\n{entry}\n")
        got = {}
        for main, who in ((jax_main, "jax"), (port_main, "port")):
            out = tmp_path / f"{who}.jsonl"
            capsys.readouterr()
            rc = run(main, str(path), out)
            got[who] = (rc, capsys.readouterr().err,
                        outputs(out) if out.exists() else None)
    assert got["port"] == got["jax"]
    if name.endswith(".git"):
        rc, err, out = got["port"]
        assert rc == 1 and out is None
        assert "git-over-HTTP container" in err and full in err
    else:
        assert got["port"][0] == 0
        assert len(got["port"][2][1].splitlines()) == 1  # one container row


def test_entry_grammar_matches_jax(tmp_path):
    from licensee_tpu.ingest import sources as jax_sources

    repo = make_repo(str(tmp_path / "checkout"), {"LICENSE": b"x"})
    plain = tmp_path / "plain"
    plain.mkdir()
    for entry in ["LICENSE", "a.tar::LICENSE", "a.TGZ::*", "b.zip::x::y",
                  "r.git::HEAD", f"{repo}::HEAD", f"{plain}::LICENSE",
                  "::LICENSE", "a.txt::LICENSE", "https://h/a.tar.xz::*",
                  "https://h/a?b.zip::*", "https://h/x::LICENSE"]:
        assert sources.split_entry(entry) == jax_sources.split_entry(entry)


def test_expansion_reads_by_index_and_never_pickles(manifest):
    """Two containers holding one member name read their own bytes, and
    an expansion's live handles never cross a process boundary."""
    import pickle

    path, _root = manifest
    with open(path, encoding="utf-8") as f:
        entries = f.read().split()
    ex = expand_manifest(entries)
    try:
        firsts = [i for i, p in enumerate(ex.paths) if p == "LICENSE"]
        assert len({bytes(ex.read_at(i) or b"") for i in firsts}) > 1
        with pytest.raises(TypeError, match="never pickles"):
            pickle.dumps(ex)
        twin = sources.ManifestExpansion.from_descriptor(ex.descriptor())
        assert twin.paths == ex.paths and twin.fingerprint() == (
            ex.fingerprint())
        twin.close()
    finally:
        ex.close()


def test_empty_selector_refused(tmp_path):
    tar = make_tar(tmp_path / "a.tar", {"LICENSE": b"x"})
    with pytest.raises(IngestError, match="empty selector"):
        expand_manifest([f"{tar}::"])


def test_git_backends_agree(manifest):
    """The native object-database reader and git's plumbing list the
    same root blobs and read the same bytes (the cap included)."""
    from licensee_tpu_torch.projects import git_project

    _path, root = manifest
    repo = str(root / "repo")
    native = git_project._NativeBackend(repo, "HEAD")
    plumbing = git_project._SubprocessBackend(repo, "HEAD")
    try:
        files = native.files()
        assert files == plumbing.files()
        assert sorted(f["name"] for f in files) == [
            "LICENSE", "LICENSE-BIG", "README.md"]
        for f in files:
            assert native.load_file(f) == plumbing.load_file(f)
        big = next(f for f in files if f["name"] == "LICENSE-BIG")
        assert native.load_file(big) is None  # past the cap: skipped
    finally:
        native.close()


def test_python_written_git_objects(tmp_path):
    """chip_smoke.py's git writer for hosts without git: git itself and
    both of the port's backends read the repository it writes."""
    import chip_smoke
    from licensee_tpu_torch.projects import git_project

    files = [("LICENSE", fixture("mit/LICENSE.txt")), ("README.md", b"# x\n"),
             ("package.json", b'{"license": "MIT"}\n')]
    repo = str(tmp_path / "repo")
    os.makedirs(repo)
    chip_smoke.write_git_objects(repo, files)
    assert git(repo, "cat-file", "-p", "HEAD:LICENSE").encode() == (
        files[0][1].rstrip(b"\n"))
    native = git_project._NativeBackend(repo, "HEAD")
    plumbing = git_project._SubprocessBackend(repo, "HEAD")
    try:
        listed = native.files()
        assert listed == plumbing.files()
        assert [f["name"] for f in listed] == [n for n, _ in files]
        assert [native.load_file(f) for f in listed] == [d for _, d in files]
    finally:
        native.close()
    ex = expand_manifest([f"{repo}::HEAD"])
    try:
        assert ex.paths == [n for n, _ in files]
    finally:
        ex.close()
