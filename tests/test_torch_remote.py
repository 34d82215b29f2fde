"""Remote (http(s)) containers in the port's `batch-detect`, against the
JAX package, on the CPU.

A loopback HTTP host (`licensee_tpu_torch/ingest/loopback.py`, on
127.0.0.1, no network) serves a tar, a compressed tar and a zip of
fixture licenses (one member past the 64 KiB cap).  For each, as
``::*`` and as ``::member``, the port's JSONL, ``OUT.containers.jsonl``
and ``.meta.json`` equal the JAX CLI's byte for byte, also with worker
processes; either package resumes the other's cut output; a republish
between the cut and the resume refuses it in both; a 503-then-recover
and a torn body are retried to the same bytes; a remote git repository
is refused by both.  The reader's own failure model (retry budgets,
mid-job republish fences, the window's counted rescan, the probe) runs
on the port's module.  Exact equality everywhere."""

from __future__ import annotations

import glob
import gzip
import io
import os
import tarfile
import zipfile

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest
import torch

from licensee_tpu.cli.main import main as jax_main
from licensee_tpu.ingest.sources import expanded_layout as jax_layout
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.ingest import SkippedBlob
from licensee_tpu_torch.ingest.loopback import LoopbackBlobHost
from licensee_tpu_torch.ingest.remote import (
    RemoteChangedError,
    RemoteError,
    RemoteProbeError,
    RemoteRetryBudgetError,
    _RemoteSeqTarContainer,
    probe_remote,
)
from licensee_tpu_torch.ingest.sources import (
    IngestError,
    ManifestExpansion,
    expand_manifest,
    expanded_layout,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FILES = sorted(glob.glob(os.path.join(REPO, "tests", "fixtures", "*",
                                       "LICENSE*")))[:14]
BLOBS = {
    f"{os.path.basename(os.path.dirname(p))}/{os.path.basename(p)}":
        open(p, "rb").read()
    for p in _FILES
}
BLOBS["huge/LICENSE"] = b"MIT License\n" * 6000  # past the 64 KiB cap
ARTIFACTS = ("a.tar", "a.tar.gz", "a.zip")


def _tar_bytes(files=None) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, data in (files or BLOBS).items():
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            info.mtime = 1_600_000_000
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _zip_bytes(files=None) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, data in (files or BLOBS).items():
            zf.writestr(zipfile.ZipInfo(name, (2020, 1, 1, 0, 0, 0)), data)
    return buf.getvalue()


def _artifact(name: str, files=None) -> bytes:
    if name.endswith(".tar.gz"):
        return gzip.compress(_tar_bytes(files), mtime=0)
    if name.endswith(".tar"):
        return _tar_bytes(files)
    return _zip_bytes(files)


@pytest.fixture()
def host(monkeypatch):
    # 1 ms backoff, so the scripted faults' retries cost nothing
    monkeypatch.setenv("LICENSEE_TPU_REMOTE_BACKOFF_MS", "1")
    with LoopbackBlobHost({a: _artifact(a) for a in ARTIFACTS}) as h:
        yield h


def run(main, manifest, out, *flags) -> int:
    extra = ["--device", "cpu"] if main is port_main else []
    return main(["batch-detect", str(manifest), "--output", str(out),
                 "--batch-size", "4", *flags, *extra])


def outputs(out) -> tuple:
    return tuple(open(f"{out}{suffix}", "rb").read()
                 for suffix in ("", ".containers.jsonl", ".meta.json"))


def manifest_for(tmp_path, host, artifact, form) -> str:
    url = host.url(artifact)
    if form == "*":
        entries = [f"{url}::*"]
    else:  # listed members, one of them past the cap
        entries = [f"{url}::{m}" for m in sorted(BLOBS)[::3]]
        entries.append(f"{url}::huge/LICENSE")
    entries.insert(1, _FILES[0])  # a loose file between
    path = tmp_path / "m.txt"
    path.write_text("\n".join(entries) + "\n")
    return str(path)


def both(tmp_path, manifest, *flags) -> dict:
    got = {}
    for main, name in ((jax_main, "jax"), (port_main, "port")):
        out = tmp_path / f"{name}.jsonl"
        assert run(main, manifest, out, *flags) == 0
        got[name] = outputs(out)
    return got


@pytest.mark.parametrize("artifact", ARTIFACTS)
@pytest.mark.parametrize("form, flags", [
    ("*", ()),
    ("*", ("--mode", "auto", "--closest", "3", "--attribution")),
    ("member", ()),
])
def test_rows_containers_and_sidecar_match_jax(host, tmp_path, artifact,
                                               form, flags):
    got = both(tmp_path, manifest_for(tmp_path, host, artifact, form),
               *flags)
    assert got["port"] == got["jax"]
    assert b'"oversized"' in got["port"][0]
    assert got["port"][1].count(b"\n") == 1  # one container row


def test_featurize_procs_match_jax(host, tmp_path):
    manifest = manifest_for(tmp_path, host, "a.tar.gz", "*")
    got = both(tmp_path, manifest, "--featurize-procs", "2")
    assert got["port"] == got["jax"]
    out = tmp_path / "threads.jsonl"
    assert run(port_main, manifest, out) == 0
    assert outputs(out) == got["port"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(host, tmp_path, writer):
    """One package's output, cut mid-line, resumed by the other: the
    same bytes as an uncut run."""
    manifest = manifest_for(tmp_path, host, "a.zip", "*")
    full = tmp_path / "full.jsonl"
    assert run(jax_main, manifest, full) == 0
    first, second = ((jax_main, port_main) if writer == "jax"
                     else (port_main, jax_main))
    out = tmp_path / "cut.jsonl"
    assert run(first, manifest, out) == 0
    data = out.read_bytes()
    out.write_bytes(data[: len(data) // 2 + 7])
    assert run(second, manifest, out) == 0
    assert outputs(out) == outputs(full)


@pytest.mark.parametrize("main", [jax_main, port_main],
                         ids=["jax", "port"])
def test_republish_between_cut_and_resume_refused(host, tmp_path, capsys,
                                                  main):
    """The artifact's validators (ETag, Last-Modified, Content-Length)
    fold into the sidecar's expansion fingerprint: an archive
    republished with the same member table refuses the resume."""
    manifest = manifest_for(tmp_path, host, "a.tar", "*")
    out = tmp_path / "cut.jsonl"
    assert run(main, manifest, out) == 0
    data = out.read_bytes()
    out.write_bytes(data[: len(data) // 2])
    host.set_content("a.tar", _tar_bytes(
        {n: d[:-1] + b"?" for n, d in BLOBS.items()}))
    capsys.readouterr()
    assert run(main, manifest, out) == 1
    assert "ingest" in capsys.readouterr().err


def test_fingerprints_match_jax(host):
    for artifact in ARTIFACTS:
        url = host.url(artifact) + "::*"
        assert expanded_layout([url]) == jax_layout([url])


@pytest.mark.parametrize("fault", ["503", "torn"])
def test_faults_retried_to_the_same_bytes(host, tmp_path, fault):
    manifest = manifest_for(tmp_path, host, "a.zip", "*")
    clean = tmp_path / "clean.jsonl"
    assert run(port_main, manifest, clean) == 0
    for main, name in ((jax_main, "jax"), (port_main, "port")):
        if fault == "503":
            host.fail_next("a.zip", 2, 503)
        else:
            host.truncate_next("a.zip", 64)
        out = tmp_path / f"{name}.jsonl"
        assert run(main, manifest, out) == 0
        assert outputs(out) == outputs(clean)


def test_remote_git_refused_by_both(host, tmp_path, capsys):
    host.set_content("repo.git", b"not a repository")
    path = tmp_path / "m.txt"
    path.write_text(f"{_FILES[0]}\n{host.url('repo.git')}::HEAD\n")
    errs = []
    for main in (jax_main, port_main):
        out = tmp_path / "o.jsonl"
        capsys.readouterr()
        assert run(main, path, out) == 1
        assert not out.exists()
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and "git-over-HTTP" in errs[1]
    with pytest.raises(IngestError, match="publish a tar/zip"):
        expand_manifest([host.url("repo.git") + "::HEAD"])


# -- the reader's own failure model, on the port's module --


def test_restricted_spans_and_descriptor_reopen(host):
    url = host.url("a.tar") + "::*"
    names = list(BLOBS)
    halves = []
    for lo, hi in ((0, 7), (7, len(names))):
        ex = expand_manifest([url], span=(lo, hi))
        try:
            assert ex.total == len(names) and ex.span == (lo, hi)
            worker = ManifestExpansion.from_descriptor(ex.descriptor())
            try:
                halves.append([worker.read_at(i) for i in range(hi - lo)])
            finally:
                worker.close()
        finally:
            ex.close()
    got = halves[0] + halves[1]
    for name, blob in zip(names, got):
        if len(BLOBS[name]) > 64 * 1024:
            assert isinstance(blob, SkippedBlob)
        else:
            assert blob == BLOBS[name]


def test_budgets_and_fences(host):
    host.fail_next("a.tar", 99, 503)
    with pytest.raises(RemoteRetryBudgetError):
        expand_manifest([host.url("a.tar") + "::*"])
    host.fail_next("a.tar", 0, 503)
    host.truncate_next("a.tar", 40, times=99)
    with pytest.raises(RemoteRetryBudgetError):
        expand_manifest([host.url("a.tar") + "::*"])
    host.truncate_next("a.tar", 40, times=0)
    ex = expand_manifest([host.url("a.tar") + "::*"])
    try:
        host.set_content("a.tar", _tar_bytes() + b"\0" * 1024)
        with pytest.raises(RemoteChangedError):
            ex.read_at(0)
    finally:
        ex.close()


def test_behind_window_miss_counted_not_taken(host):
    container = _RemoteSeqTarContainer(host.url("a.tar.gz"))
    try:
        names = container.members()
        assert container.read(names[2]) == BLOBS[names[2]]
        assert container.rescans == 0
        assert container.read(names[0]) == BLOBS[names[0]]
        assert container.rescans == 1
    finally:
        container.close()


def test_probe_remote_shapes(host):
    info = probe_remote(host.url("a.tar"))
    assert info["kind"] == "rtar" and info["size"] == len(_tar_bytes())
    host.no_range = True
    assert probe_remote(host.url("a.tar.gz"))["kind"] == "rctar"
    with pytest.raises(RemoteProbeError, match="byte ranges"):
        probe_remote(host.url("a.tar"))
    host.no_range = False
    with pytest.raises(RemoteProbeError):
        probe_remote(host.url("missing.zip"))
    with pytest.raises(RemoteError):
        probe_remote(host.url("repo.git"))
