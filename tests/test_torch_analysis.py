"""The port's static analyzer (licensee_tpu_torch/analysis/) against the
JAX package's (licensee_tpu/analysis/).

* **parity** — every fixture program under tests/fixtures/analysis/
  (a ``.py`` case as a one-file program with every rule forced on, a
  directory case as its own root) gives the same (path, line, rule)
  findings through both analyzers, and both catalogs hold the same rule
  ids;
* **torch's blocking calls** — tests/analysis_torch/ holds the
  true-positive (``tp_*``) and clean (``ok_*``) cases of the verbs only
  the port's ``blocking-device-call`` knows (``.item()``, ``.cpu()``,
  ``.tolist()``, ``torch.cuda.synchronize()``, an event's or stream's
  ``.synchronize()``): a TP case is flagged on exactly its ``# BAD``
  lines, an OK case nowhere; the card scorer's real submit seam is
  inside the rule's gate;
* **the port's gate** — ``licensee_tpu_torch/`` and its launcher analyze
  clean, the warmed cache is finding-identical to the cold run, and
  ``python -m licensee_tpu_torch.analysis`` exits 0 on the tree and
  non-zero on a violation.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from licensee_tpu import analysis as jax_analysis
from licensee_tpu_torch import analysis as port_analysis
from licensee_tpu_torch.analysis.core import Module, analyze_module
from licensee_tpu_torch.analysis.program import AnalysisCache, engine_salt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
JAX_CORPUS = os.path.join(FIXTURES, "analysis")
# not under tests/fixtures/, whose every other directory the JAX
# package takes for a project fixture (`vendoring.fixture_names`)
TORCH_CORPUS = os.path.join(REPO, "tests", "analysis_torch")


def _cases(root: str) -> list:
    """(rule directory, case name, path) of every fixture program."""
    out = []
    for dirname in sorted(os.listdir(root)):
        dirpath = os.path.join(root, dirname)
        for name in sorted(os.listdir(dirpath)):
            path = os.path.join(dirpath, name)
            if name.endswith(".py") or os.path.isdir(path):
                out.append((dirname, name, path))
    return out


def _findings(pkg, path: str, name: str) -> set:
    """(path, line, rule) of a fixture program, as tests/test_analysis.py
    runs it."""
    if os.path.isdir(path):
        found, _checked = pkg.analyze_project(path)
    else:
        with open(path, encoding="utf-8") as f:
            found = pkg.analyze_source(f.read(), rel=name, force_all=True)
    return {(f.path, f.line, f.rule) for f in found}


def _marked_lines(path: str) -> set:
    with open(path, encoding="utf-8") as f:
        return {i for i, line in enumerate(f.read().splitlines(), 1)
                if line.rstrip().endswith("# BAD")}


@pytest.mark.parametrize("dirname,name,path", [
    pytest.param(d, n, p, id=f"{d}/{n}") for d, n, p in _cases(JAX_CORPUS)
])
def test_fixture_findings_match_the_jax_analyzer(dirname, name, path):
    want = _findings(jax_analysis, path, name)
    assert want or not name.startswith("tp_"), "a TP case must be flagged"
    assert _findings(port_analysis, path, name) == want


def test_rule_catalogs_match(capsys):
    assert set(port_analysis.RULES) == set(jax_analysis.RULES)
    assert set(port_analysis.PROGRAM_RULES) == set(jax_analysis.PROGRAM_RULES)
    assert port_analysis.main(["--list-rules"]) == 0
    listed = {line.split(":", 1)[0]
              for line in capsys.readouterr().out.splitlines()}
    assert listed == set(jax_analysis.RULES) | set(jax_analysis.PROGRAM_RULES)


@pytest.mark.parametrize("name,path", [
    pytest.param(n, p, id=f"{d}/{n}") for d, n, p in _cases(TORCH_CORPUS)
])
def test_torch_blocking_verbs(name, path):
    """Each TP case flagged on exactly its marked lines, no OK case at
    all; the JAX package's analyzer knows none of these verbs."""
    hits = {line for _p, line, rule in _findings(port_analysis, path, name)
            if rule == "blocking-device-call"}
    if name.startswith("tp_"):
        assert hits and hits == _marked_lines(path)
    else:
        assert not hits
    assert not {line for _p, line, rule in _findings(jax_analysis, path, name)
                if rule == "blocking-device-call"}


def test_the_card_scorers_submit_seam_is_gated():
    """A wait added to `BestMatchScorer.submit` in the real dice_cuda.py
    is flagged at its own line; the module as it stands is not, its
    `__call__` wait included."""
    rel = "licensee_tpu_torch/kernels/dice_cuda.py"
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        text = f.read()
    anchor = "        with torch.cuda.stream(self.stream):\n            dev = "
    assert text.count(anchor) == 1
    assert not [f for f in analyze_module(Module(rel, text))
                if f.rule == "blocking-device-call"]
    bad = text.replace(anchor, "        torch.cuda.synchronize()\n" + anchor)
    line = bad[: bad.index("torch.cuda.synchronize()\n")].count("\n") + 1
    found = [f for f in analyze_module(Module(rel, bad))
             if f.rule == "blocking-device-call"]
    assert [(f.line, "'submit'" in f.message) for f in found] == [(line, True)]


@pytest.fixture(scope="module")
def port_scan(tmp_path_factory):
    """The port's tree analyzed cold into a fresh cache, then warm from
    it: (cold findings, files, warm findings, warm cache, cache path)."""
    path = str(tmp_path_factory.mktemp("analysis") / "analyze-torch.json")
    files = list(port_analysis.iter_python_files(REPO))
    cold_cache = AnalysisCache(path, engine_salt())
    cold, checked = port_analysis.analyze_paths(
        files, REPO, complete=True, cache=cold_cache)
    cold_cache.save()
    warm_cache = AnalysisCache(path, engine_salt())
    warm, _ = port_analysis.analyze_paths(
        files, REPO, complete=True, cache=warm_cache)
    return cold, checked, warm, warm_cache, path


def test_port_tree_is_clean(port_scan):
    cold, checked, _warm, _cache, _path = port_scan
    assert checked > 100, "the scan should cover the port's package"
    assert cold == [], "\n".join(f.render() for f in cold)


def test_scan_covers_the_launcher_and_not_the_jax_package():
    rels = {os.path.relpath(p, REPO)
            for p in port_analysis.iter_python_files(REPO)}
    assert os.path.join("bin", "licensee-tpu-torch") in rels
    assert os.path.join("licensee_tpu_torch", "graft_entry.py") in rels
    assert not [r for r in rels if r.split(os.sep)[0] == "licensee_tpu"]


def test_warm_cache_equals_cold(port_scan):
    cold, _checked, warm, warm_cache, _path = port_scan
    assert [f.render() for f in warm] == [f.render() for f in cold]
    assert warm_cache.misses == 0 and warm_cache.hits > 100


def test_cli_exit_codes(port_scan, tmp_path):
    cache = port_scan[4]
    clean = subprocess.run(
        [sys.executable, "-m", "licensee_tpu_torch.analysis", "--cache",
         cache], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "0 finding(s)" in clean.stderr
    leak = tmp_path / "leak.py"
    leak.write_text(
        "import socket\n\n\n"
        "def dial(addr):\n"
        "    s = socket.socket()\n"
        "    s.connect(addr)\n"
        "    return s.recv(1)\n"
    )
    bad = subprocess.run(
        [sys.executable, "-m", "licensee_tpu_torch.analysis", str(leak)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "resource-leak" in bad.stdout
