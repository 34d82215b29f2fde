"""The port's SPDX corpus path against the JAX package's, kept small.

`corpus/spdx_synth.py` writes the same files, `corpus/spdx.py` compiles
the same constants, and `batch-detect --corpus DIR --device cpu` writes
the same JSONL bytes as `licensee_tpu`'s `BatchProject` over the same
directory; K2's plain version agrees with the interpret-mode Pallas MXU
kernel at the directory's width."""

import filecmp
import os

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

from licensee_tpu.corpus import spdx as jax_spdx
from licensee_tpu.corpus import spdx_synth as jax_synth
from licensee_tpu.kernels import dice_pallas, dice_xla
from licensee_tpu.projects.batch_project import BatchProject as JaxBatchProject
from licensee_tpu_torch import convert, vendor_paths
from licensee_tpu_torch.cli.main import load_corpus
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.corpus import spdx, spdx_synth
from licensee_tpu_torch.kernels import dice_cuda, dice_ref

torch.set_num_threads(1)

N_TEMPLATES = 64  # the 47 vendored XMLs and 17 synthetic ones


@pytest.fixture(scope="module")
def synth_dirs(tmp_path_factory):
    """The same synthetic directory written by each package."""
    root = tmp_path_factory.mktemp("spdx")
    port = spdx_synth.synth_spdx_dir(str(root / "port"), N_TEMPLATES, seed=3)
    ref = jax_synth.synth_spdx_dir(str(root / "jax"), N_TEMPLATES, seed=3)
    return port, ref


def test_synth_dir_is_byte_identical(synth_dirs):
    port, ref = synth_dirs
    names = sorted(os.listdir(ref))
    assert len(names) == N_TEMPLATES and sorted(os.listdir(port)) == names
    _match, mismatch, errors = filecmp.cmpfiles(port, ref, names, shallow=False)
    assert not mismatch and not errors


def assert_same_corpus(ours, ref):
    assert ours.keys == ref.keys
    assert ours.vocab == ref.vocab
    for name in convert.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ours, name),
                                      np.asarray(getattr(ref, name)), name)
    assert ours.exact_sets == ref.exact_sets
    assert ours.content_hashes == ref.content_hashes


@pytest.mark.parametrize("source", ["synth", "vendored-spdx"])
def test_spdx_corpus_matches_jax(synth_dirs, source):
    path = synth_dirs[0] if source == "synth" else None
    ours = spdx.spdx_corpus(path)
    ref = jax_spdx.spdx_corpus(synth_dirs[1] if path else None)
    assert ours.n_templates == (N_TEMPLATES if path else 47)
    assert ours.n_lanes % 4 == 0
    assert_same_corpus(ours, ref)


def test_load_corpus_sources(synth_dirs, tmp_path):
    assert load_corpus("vendored") is None
    assert load_corpus("spdx") is spdx.spdx_corpus(None)
    assert load_corpus(synth_dirs[0]).n_templates == N_TEMPLATES
    artifact = tmp_path / "corpus.npz"
    artifact.write_bytes(b"")
    with pytest.raises(ValueError, match="cannot read artifact"):
        load_corpus(str(artifact))
    with pytest.raises(ValueError):
        load_corpus(str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="no license templates"):
        load_corpus(str(tmp_path))
    assert vendor_paths.SPDX_DIR.endswith(os.path.join("license-list-XML", "src"))


@pytest.fixture(scope="module")
def spdx_manifest(synth_dirs, tmp_path_factory):
    """40 rows as chip_smoke.py writes its wide slice's: 24 rendered
    synthetic templates, 15 seeded mutations of them and one unreadable
    path (few rows: the interpret-mode JAX run is the test's cost)."""
    import chip_smoke

    root = str(tmp_path_factory.mktemp("rows"))
    bases = [(f"{t.key}.LICENSE", t.content)
             for t in spdx.load_spdx_dir(synth_dirs[0])[:24]]
    manifest = chip_smoke.write_rows(np, root, bases, seed=5, n_files=40)
    with open(manifest, encoding="utf-8") as f:
        return manifest, f.read().split()


@pytest.mark.parametrize("method", ["pallas", "pallas-mxu"])
def test_batch_detect_corpus_dir_matches_jax(synth_dirs, spdx_manifest,
                                             tmp_path, method):
    manifest, paths = spdx_manifest
    ref_out = tmp_path / "jax.jsonl"
    JaxBatchProject(paths, corpus=jax_spdx.spdx_corpus(synth_dirs[1]),
                    method=method, mesh=None, tracer=False).run(str(ref_out))
    want = ref_out.read_bytes()
    assert want.count(b"\n") == len(paths)
    assert b'"matcher": "dice"' in want and b'"matcher": "exact"' in want
    out = tmp_path / "port.jsonl"
    assert port_main(["batch-detect", manifest, "--output", str(out),
                      "--corpus", synth_dirs[0], "--method", method,
                      "--device", "cpu"]) == 0
    assert out.read_bytes() == want


def test_mma_overlap_plain_matches_pallas_at_synth_width(synth_dirs):
    """K2's plain version against the interpret-mode Pallas MXU kernel on
    the synthetic directory's own constants."""
    corpus = jax_spdx.spdx_corpus(synth_dirs[1])
    rng = np.random.default_rng(17)
    bits = rng.integers(0, 2**32, size=(40, corpus.n_lanes), dtype=np.uint32)
    ref = dice_pallas.overlap_pairs_mxu(
        dice_xla.CorpusArrays.from_compiled(corpus), bits, interpret=True)
    ct = dice_ref.CorpusTensors.from_compiled(spdx.spdx_corpus(synth_dirs[0]))
    ours = dice_cuda.overlap_pairs_mma(
        dice_cuda.pack_templates_mma(ct),
        torch.from_numpy(bits.view(np.int32)), ct.n_templates)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
