"""The port's corpus artifacts against the JAX package's
(`corpus/artifact.py`, the cases of `tests/test_corpus_artifact.py`):
equal fingerprints of the same corpus, each package loading the other's
artifact, `ArtifactError` on a corrupt or foreign file, the
`corpus-build` verb, `batch-detect --corpus ARTIFACT` giving the bytes
of the source it was built from, and a resume refused across a
different artifact.  Exact equality everywhere."""

import json

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import chip_smoke
from licensee_tpu.cli.main import main as jax_main
from licensee_tpu.corpus import artifact as jax_artifact
from licensee_tpu.corpus.compiler import CompiledCorpus as JaxCompiledCorpus
from licensee_tpu.corpus.license import License as JaxLicense
from licensee_tpu_torch.cli.main import load_corpus
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.corpus import artifact, spdx_synth
from licensee_tpu_torch.corpus.compiler import CompiledCorpus, default_corpus
from licensee_tpu_torch.corpus.license import License

torch.set_num_threads(1)


def small(lib_license, lib_compiled, keys):
    return lib_compiled.compile([lib_license.find(k) for k in keys])


@pytest.fixture(scope="module")
def synth_src(tmp_path_factory):
    return spdx_synth.synth_spdx_dir(
        str(tmp_path_factory.mktemp("spdx") / "src"), 64, seed=6)


@pytest.mark.parametrize("source", ["vendored", "spdx", "synth"])
def test_fingerprints_match_jax(synth_src, source):
    name = synth_src if source == "synth" else source
    ours, fp, manifest = artifact.resolve_corpus(name)
    ref, ref_fp, _ = jax_artifact.resolve_corpus(name)
    assert manifest is None and fp == ref_fp
    assert artifact.corpus_fingerprint(ours) == fp
    assert artifact.build_manifest(ours, "s") == jax_artifact.build_manifest(
        ref, "s")


def test_fingerprint_is_content_sensitive():
    mit_apache = small(License, CompiledCorpus, ["mit", "apache-2.0"])
    mit_isc = small(License, CompiledCorpus, ["mit", "isc"])
    fp = artifact.corpus_fingerprint(mit_apache)
    assert artifact.corpus_fingerprint(mit_isc) != fp
    assert fp == jax_artifact.corpus_fingerprint(
        small(JaxLicense, JaxCompiledCorpus, ["mit", "apache-2.0"]))
    assert artifact.short_fingerprint(fp) == fp[:12]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_artifact(tmp_path, writer):
    path = str(tmp_path / "vendored.npz")
    if writer == "jax":
        jax_artifact.write_artifact(path, jax_artifact.resolve_corpus(
            "vendored")[0], source="vendored")
    else:
        artifact.write_artifact(path, default_corpus(), source="vendored")
    ours, manifest = artifact.load_artifact(path)
    ref, ref_manifest = jax_artifact.load_artifact(path)
    assert manifest == ref_manifest
    assert manifest["fingerprint"] == artifact.corpus_fingerprint(
        default_corpus())
    assert ours.keys == ref.keys and ours.vocab == ref.vocab
    assert ours.exact_sets == ref.exact_sets
    assert ours.content_hashes == ref.content_hashes
    for name, _dtype in artifact.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    assert artifact.check_corpus_source(path) == manifest["fingerprint"]


def test_corrupt_and_foreign_files_raise(tmp_path):
    corpus = small(License, CompiledCorpus, ["mit", "apache-2.0"])
    path = tmp_path / "a.npz"
    artifact.write_artifact(str(path), corpus)
    data = bytearray(path.read_bytes())
    data[len(data) // 2 : len(data) // 2 + 16] = b"\0" * 16
    path.write_bytes(bytes(data))
    with pytest.raises(artifact.ArtifactError):
        artifact.load_artifact(str(path))
    garbage = tmp_path / "g.npz"
    garbage.write_bytes(b"not a zip at all")
    with pytest.raises(artifact.ArtifactError, match="cannot read"):
        artifact.load_artifact(str(garbage))
    plain = tmp_path / "plain.npz"
    np.savez(plain, foo=np.zeros(3))
    with pytest.raises(artifact.ArtifactError, match="not a corpus artifact"):
        artifact.load_artifact(str(plain))
    with pytest.raises(artifact.ArtifactError, match="not a corpus artifact"):
        artifact.check_corpus_source(str(plain))
    # a manifest that lies about its payload: another corpus's column
    # under the first one's fingerprint
    lie = tmp_path / "lie.npz"
    artifact.write_artifact(str(lie), corpus)
    with np.load(lie, allow_pickle=False) as npz:
        fields = {name: npz[name] for name in npz.files}
    fields["n_wf"] = small(License, CompiledCorpus, ["mit", "isc"]).n_wf
    np.savez(lie, **fields)
    with pytest.raises(artifact.ArtifactError, match="fingerprint"):
        artifact.load_artifact(str(lie))
    with pytest.raises(artifact.ArtifactError, match="cannot load corpus"):
        load_corpus(str(tmp_path / "nope"))


def test_corpus_build_matches_jax(synth_src, tmp_path, capsys):
    """`corpus-build` in each package: the same manifest line, and each
    `--inspect` reads the other's artifact; a corrupt one exits 1."""
    lines = []
    for main, name in ((port_main, "port.npz"), (jax_main, "jax.npz")):
        capsys.readouterr()
        assert main(["corpus-build", "--corpus", synth_src, "--output",
                     str(tmp_path / name)]) == 0
        lines.append(json.loads(capsys.readouterr().out))
    assert lines[0] == lines[1] and lines[0]["templates"] == 64
    for main, name in ((port_main, "jax.npz"), (jax_main, "port.npz")):
        assert main(["corpus-build", "--inspect", str(tmp_path / name)]) == 0
        assert json.loads(capsys.readouterr().out) == lines[0]
    assert port_main(["corpus-build"]) == 1
    bad = tmp_path / "port.npz"
    data = bytearray(bad.read_bytes())
    data[len(data) // 2] ^= 0xFF
    bad.write_bytes(bytes(data))
    assert port_main(["corpus-build", "--inspect", str(bad)]) == 1


def test_corpus_artifact_runs_like_its_source_and_fences_resume(
        synth_src, tmp_path):
    """`--corpus ART` writes the `--corpus DIR` run's bytes (and the JAX
    package's); a partial output written under one artifact refuses to
    resume under another corpus."""
    art = tmp_path / "synth.npz"
    assert port_main(["corpus-build", "--corpus", synth_src, "--output",
                      str(art)]) == 0
    manifest = chip_smoke.write_spdx_manifest(
        np, str(tmp_path / "rows"), synth_src, seed=3, n_files=40)
    outs = {}
    for label, main, corpus, extra in (
            ("dir", port_main, synth_src, ["--device", "cpu"]),
            ("art", port_main, str(art), ["--device", "cpu"]),
            ("jax-art", jax_main, str(art), [])):
        out = tmp_path / f"{label}.jsonl"
        assert main(["batch-detect", manifest, "--output", str(out),
                     "--corpus", corpus, "--closest", "2", *extra]) == 0
        outs[label] = out.read_bytes()
    assert outs["art"] == outs["dir"] == outs["jax-art"]
    out = tmp_path / "art.jsonl"
    out.write_bytes(outs["art"][: len(outs["art"]) // 2])
    for main, extra in ((port_main, ["--device", "cpu"]), (jax_main, [])):
        assert main(["batch-detect", manifest, "--output", str(out),
                     "--corpus", "vendored", "--closest", "2",
                     *extra]) == 1
    assert port_main(["batch-detect", manifest, "--output", str(out),
                      "--corpus", str(art), "--closest", "2",
                      "--device", "cpu"]) == 0
    assert out.read_bytes() == outs["dir"]
