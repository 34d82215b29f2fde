"""The port's first slice end to end against the JAX package: the
`BatchClassifier` rows and the `batch-detect` JSONL bytes on the test
fixtures, the entry points' device contract, and the rule that the port
imports nothing of JAX, PyYAML or `licensee_tpu`."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest
import torch

from licensee_tpu.kernels.batch import BatchClassifier as JaxBatchClassifier
from licensee_tpu.projects.batch_project import BatchProject as JaxBatchProject
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.kernels.batch import BatchClassifier, BlobResult

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core would crowd them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
# every license-like fixture file (the analyzer's Python fixtures aside):
# 78 blobs, the .html one included
FIXTURE_FILES = sorted(
    os.path.join(d, f)
    for d, _dirs, files in os.walk(FIXTURES)
    if os.path.relpath(d, FIXTURES).split(os.sep)[0] != "analysis"
    for f in files
    if not f.endswith((".json", ".yml"))
)


@pytest.fixture(scope="module")
def blobs():
    contents = []
    for path in FIXTURE_FILES:
        with open(path, "rb") as f:
            contents.append(f.read())
    return contents, [os.path.basename(p) for p in FIXTURE_FILES]


def rows(results):
    """Each result as a dict of the port's BlobResult fields (the JAX rows
    also carry closest/attribution, None in license mode)."""
    names = [f.name for f in dataclasses.fields(BlobResult)]
    return [{n: getattr(r, n) for n in names} for r in results]


def test_fixture_set():
    assert 70 <= len(FIXTURE_FILES) <= 100
    assert any(p.endswith(".html") for p in FIXTURE_FILES)


@pytest.mark.parametrize("method", ["pallas", "pallas-mxu"])
def test_classify_blobs_matches_jax(blobs, method):
    contents, names = blobs
    ref = JaxBatchClassifier(method=method, mesh=None, pad_batch_to=128)
    ours = BatchClassifier(method=method, device="cpu", pad_batch_to=128)
    want = rows(ref.classify_blobs(contents, filenames=names))
    assert rows(ours.classify_blobs(contents, filenames=names)) == want
    matchers = {r["matcher"] for r in want}
    assert {"dice", "exact", "copyright", None} <= matchers


@pytest.mark.parametrize("method", ["auto", "popcount", "matmul"])
def test_classify_blobs_other_methods_match_jax(blobs, method):
    contents, names = blobs
    ref = JaxBatchClassifier(method=method, mesh=None, pad_batch_to=128)
    ours = BatchClassifier(method=method, device="cpu", pad_batch_to=32)
    want = rows(ref.classify_blobs(contents, filenames=names))
    assert rows(ours.classify_blobs(contents, filenames=names)) == want


def write_manifest(tmp_path):
    """The fixtures, plus a verbatim duplicate under another name, a
    repeated path and a path that cannot be read."""
    dup = tmp_path / "copy" / "LICENSE.txt"
    dup.parent.mkdir()
    shutil.copy(FIXTURE_FILES[5], dup)
    paths = [*FIXTURE_FILES, str(dup), FIXTURE_FILES[3],
             str(tmp_path / "missing" / "LICENSE")]
    manifest = tmp_path / "manifest.txt"
    manifest.write_text("\n".join(paths) + "\n", encoding="utf-8")
    return str(manifest), paths


def test_batch_detect_jsonl_matches_jax(tmp_path):
    manifest, paths = write_manifest(tmp_path)
    ref_out = tmp_path / "jax.jsonl"
    JaxBatchProject(paths, method="pallas", mesh=None, tracer=False).run(
        str(ref_out))
    want = ref_out.read_bytes()
    assert want.count(b"\n") == len(paths)
    assert b'"error": "read_error"' in want
    for extra in ([], ["--batch-size", "16", "--no-dedupe"]):
        out = tmp_path / f"port{len(extra)}.jsonl"
        rc = port_main(["batch-detect", manifest, "--output", str(out),
                        "--method", "pallas", "--device", "cpu", *extra])
        assert rc == 0
        assert out.read_bytes() == want, extra


def test_batch_detect_counts_and_dedupe(tmp_path):
    from licensee_tpu_torch.projects.batch_project import BatchProject

    _manifest, paths = write_manifest(tmp_path)
    project = BatchProject(paths, batch_size=16, device="cpu")
    stats = project.run(str(tmp_path / "out.jsonl"))
    assert stats.total == len(paths)
    assert stats.read_errors == 1
    assert stats.dedupe_hits >= 2  # the copied file and the repeated path
    assert stats.total == (
        stats.prefiltered_copyright + stats.prefiltered_exact
        + stats.dice_matched + stats.unmatched + stats.read_errors
        + stats.featurize_errors + stats.skipped_oversized
    )
    assert 0 < stats.device_rows < stats.total


def test_cuda_is_the_default_and_never_falls_back(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchClassifier()
    manifest, _paths = write_manifest(tmp_path)
    out = tmp_path / "out.jsonl"
    assert port_main(["batch-detect", manifest, "--output", str(out)]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()


def test_waiting_features_raise():
    """The refusals the JAX package keeps, kept by the port as it keeps
    them: an unknown mode, closest < 0, closest with the pallas methods
    and closest in package mode (and an unknown method)."""
    refused = [
        ({"mode": "bogus"}, "unknown mode"),
        ({"closest": -1}, "closest must be >= 0"),
        ({"closest": 3, "method": "pallas"}, "pallas"),
        ({"closest": 3, "method": "pallas-mxu"}, "pallas"),
        ({"closest": 3, "mode": "package"}, "package mode"),
    ]
    for kwargs, match in refused:
        with pytest.raises(ValueError, match=match):
            JaxBatchClassifier(mesh=None, **kwargs)
        with pytest.raises(ValueError, match=match):
            BatchClassifier(device="cpu", **kwargs)
    with pytest.raises(ValueError):
        BatchClassifier(method="bogus", device="cpu")


def test_auto_resolves_by_template_count():
    """``auto`` picks K1 or K2 by the corpus's width, from the port's own
    crossover table; the rows do not depend on the pick."""
    from licensee_tpu_torch.kernels import batch, dice_cuda

    ours = BatchClassifier(method="auto", device="cpu")
    assert ours.method == batch.resolve_method(47)
    for T in (1, 47, 128, 129, 608, 5000):
        assert batch.resolve_method(T) in dice_cuda.K1_METHODS + dice_cuda.K2_METHODS
    assert batch.METHOD_CROSSOVER[-1][0] is None


def test_port_imports_no_jax_yaml_or_jax_package():
    """Every module of the port, and chip_smoke.py, in a fresh process,
    with the port's native pipeline and scanners loaded, `detect`'s
    chain run (rules, fields, the matchers' lazy imports) and a `serve`
    session run (the selftest on the CPU: the scheduler's, the reload's
    and the diff verb's lazy imports), and `fleet --selftest --stub` and
    `stats --selftest` run through the CLI (the fleet's, the edge's and
    the telemetry plane's lazy imports): no JAX, no PyYAML, nothing of
    `licensee_tpu`, and no library built inside it."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import licensee_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "licensee_tpu_torch.__path__, 'licensee_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "from licensee_tpu_torch.native import pipeline, textops\n"
        "from licensee_tpu_torch.kernels.batch import BatchClassifier\n"
        "assert pipeline.load() and textops.load()\n"
        "assert BatchClassifier(device=None)._nat is pipeline.load()\n"
        "from licensee_tpu_torch.matchers import dice_xla_matcher\n"
        "dice_xla_matcher.use_device('cpu')\n"
        "p = licensee_tpu_torch.project('tests/fixtures/mit', "
        "detect_packages=True, detect_readme=True)\n"
        "assert p.to_h()['licenses'][0]['rules']['permissions']\n"
        "assert dice_xla_matcher.DiceXLA(p.license_file).confidence > 98\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert '/licensee_tpu/native/' not in maps, 'a JAX-side library'\n"
        "assert '/build/licensee_tpu_torch/native/_pipeline.so' in maps\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'yaml', 'licensee_tpu'))\n"
        "new = {'licensee_tpu_torch.corpus.spdx', "
        "'licensee_tpu_torch.corpus.spdx_synth', "
        "'licensee_tpu_torch.native.build', "
        "'licensee_tpu_torch.native.pipeline', "
        "'licensee_tpu_torch.native.textops', "
        "'licensee_tpu_torch.obs.pipeline', "
        "'licensee_tpu_torch.corpus.artifact', "
        "'licensee_tpu_torch.matchers.base', "
        "'licensee_tpu_torch.matchers.package', "
        "'licensee_tpu_torch.matchers.reference_matcher', "
        "'licensee_tpu_torch.project_files.package_manager_file', "
        "'licensee_tpu_torch.project_files.readme_file', "
        "'licensee_tpu_torch.ingest.sources', "
        "'licensee_tpu_torch.ingest.verdict', "
        "'licensee_tpu_torch.native.gitodb', "
        "'licensee_tpu_torch.projects.git_project', "
        "'licensee_tpu_torch.matchers', "
        "'licensee_tpu_torch.matchers.dice_xla_matcher', "
        "'licensee_tpu_torch.projects', "
        "'licensee_tpu_torch.projects.project', "
        "'licensee_tpu_torch.projects.fs_project', "
        "'licensee_tpu_torch.projects.github_project', "
        "'licensee_tpu_torch.corpus.rules', "
        "'licensee_tpu_torch.cli.main', "
        "'licensee_tpu_torch.obs', "
        "'licensee_tpu_torch.obs.registry', "
        "'licensee_tpu_torch.obs.tracing', "
        "'licensee_tpu_torch.obs.export', "
        "'licensee_tpu_torch.obs.slo', "
        "'licensee_tpu_torch.obs.flight', "
        "'licensee_tpu_torch.serve', "
        "'licensee_tpu_torch.serve.cache', "
        "'licensee_tpu_torch.serve.stats', "
        "'licensee_tpu_torch.serve.reload', "
        "'licensee_tpu_torch.serve.scheduler', "
        "'licensee_tpu_torch.serve.eventloop', "
        "'licensee_tpu_torch.serve.diffverb', "
        "'licensee_tpu_torch.serve.server', "
        "'licensee_tpu_torch.fleet', "
        "'licensee_tpu_torch.fleet.wire', "
        "'licensee_tpu_torch.fleet.supervisor', "
        "'licensee_tpu_torch.fleet.faults', "
        "'licensee_tpu_torch.fleet.router', "
        "'licensee_tpu_torch.fleet.http_edge', "
        "'licensee_tpu_torch.fleet.selftest', "
        "'licensee_tpu_torch.obs.tsdb', "
        "'licensee_tpu_torch.obs.anomaly', "
        "'licensee_tpu_torch.obs.collect', "
        "'licensee_tpu_torch.obs.selftest', "
        "'licensee_tpu_torch.normalize.worddiff', "
        "'licensee_tpu_torch.graft_entry', "
        "'licensee_tpu_torch.analysis', "
        "'licensee_tpu_torch.analysis.__main__', "
        "'licensee_tpu_torch.analysis.core', "
        "'licensee_tpu_torch.analysis.scopes', "
        "'licensee_tpu_torch.analysis.program', "
        "'licensee_tpu_torch.analysis.protocol_schema', "
        "'licensee_tpu_torch.analysis.rules_concurrency', "
        "'licensee_tpu_torch.analysis.rules_events', "
        "'licensee_tpu_torch.analysis.rules_house', "
        "'licensee_tpu_torch.analysis.rules_metrics', "
        "'licensee_tpu_torch.analysis.rules_protocol', "
        "'licensee_tpu_torch.analysis.rules_resources', "
        "'licensee_tpu_torch.analysis.rules_tracer'}\n"
        "from licensee_tpu_torch.serve import MicroBatcher, selftest\n"
        "assert selftest(verbose=False, device='cpu') == 0\n"
        "from licensee_tpu_torch.cli.main import main\n"
        "assert main(['fleet', '--selftest', '--stub']) == 0\n"
        "assert main(['stats', '--selftest']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'yaml', 'licensee_tpu'))\n"
        "print(len(names), bad, sorted(new - set(names)))\n"
        "sys.exit(1 if bad or len(names) < 85 or new - set(names) else 0)\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr


def test_chip_smoke_slice_manifest_on_cpu(tmp_path):
    """chip_smoke.py's slice inputs (rendered templates, fixtures, seeded
    mutations, one unreadable path) through the port's CLI on the CPU."""
    import numpy as np

    import chip_smoke

    manifest = chip_smoke.write_manifest(np, str(tmp_path), 0, n_files=160)
    with open(manifest, encoding="utf-8") as f:
        paths = f.read().split()
    assert len(paths) == 160
    stats = chip_smoke.run_cli([
        "batch-detect", manifest, "--output", str(tmp_path / "out.jsonl"),
        "--method", "pallas-mxu", "--device", "cpu", "--stats"])
    assert stats["total"] == 160 and stats["read_errors"] == 1
    assert stats["device_rows"] > 50 and stats["dice_matched"] > 0


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, str(lone))):
        result = subprocess.run([sys.executable, script], cwd=cwd,
                                capture_output=True, text=True, timeout=120)
        assert result.returncode != 0
        assert '"ok": true' not in result.stdout
