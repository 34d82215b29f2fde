"""The port's two host-side twins against the JAX package's, on the CPU.

`native/selftest.py`: the parity blobs, `run_parity` over the port's own
native build, the `main` report (and its ``SKIP`` where the library is
missing) and the profile child's stage keys equal the JAX module's.
`corpus/vendoring.py`: the golden generators (license-hashes.json,
fixtures.yml) give the JAX module's bytes and the shipped files', the
fixture and SPDX-id lists are equal, and re-vendoring from a checkout
shaped like the vendor tree writes the same trees, or refuses a
checkout with the same errors."""

from __future__ import annotations

import contextlib
import filecmp
import io
import json
import os
import re
import shutil
import subprocess
import sys

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest

import licensee_tpu.corpus.vendoring as jax_vendoring
import licensee_tpu.native.pipeline as jax_pipeline
import licensee_tpu.native.selftest as jax_selftest
import licensee_tpu_torch.corpus.vendoring as port_vendoring
import licensee_tpu_torch.native.pipeline as port_pipeline
import licensee_tpu_torch.native.selftest as port_selftest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- native/selftest.py ------------------------------------------------------------


def test_parity_blobs_match_jax():
    assert port_selftest.adversarial_blobs() == jax_selftest.adversarial_blobs()
    assert port_selftest.corpus_blobs() == jax_selftest.corpus_blobs()


def test_run_parity_matches_jax():
    """Native against Python over the corpus and the adversarial blobs:
    the port's build passes with the JAX module's counts."""
    got = port_selftest.run_parity()
    assert "skipped" not in got, "the port's native featurizer did not load"
    assert got == jax_selftest.run_parity()


def report(selftest, pipeline, monkeypatch, native: bool):
    """(exit code, stdout lines without numbers) of ``selftest.main``;
    without ``native`` the library is reported missing, and no profile
    child is started either way."""
    if not native:
        monkeypatch.setattr(pipeline, "load", lambda: None)
    monkeypatch.setattr(selftest, "profile_split", lambda n=256: None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = selftest.main()
    return rc, re.sub(r"\d+\.\d+", "X", out.getvalue())


@pytest.mark.parametrize("native", (True, False))
def test_main_report_matches_jax(monkeypatch, native):
    want = report(jax_selftest, jax_pipeline, monkeypatch, native)
    got = report(port_selftest, port_pipeline, monkeypatch, native)
    assert got == want
    assert want[0] == 0
    assert ("SKIP" in want[1]) == (not native)


def test_profile_child_names_the_jax_stages():
    """The ``--profile-json`` child through the port's module path gives
    the JAX child's stage keys (eight blobs, each in its own process:
    the profiler's switch is read at start)."""
    rows = []
    for module in ("licensee_tpu.native.selftest",
                   "licensee_tpu_torch.native.selftest"):
        proc = subprocess.run(
            [sys.executable, "-m", module, "--profile-json", "8"], cwd=REPO,
            env={**os.environ, "LICENSEE_TPU_PIPE_PROFILE": "1"},
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert rows[0]["n"] == rows[1]["n"] == 8
    assert sorted(rows[1]["us_per_blob"]) == sorted(rows[0]["us_per_blob"])
    assert "stage.tokenize_only" in rows[1]["us_per_blob"]


# -- corpus/vendoring.py ------------------------------------------------------------


def test_golden_generators_match_jax_and_the_shipped_files():
    fixtures = os.path.join(REPO, "tests", "fixtures")
    for name, fn in (("license-hashes.json", "license_hashes_json"),
                     ("fixtures.yml", "fixtures_yml")):
        got = getattr(port_vendoring, fn)()
        assert got == getattr(jax_vendoring, fn)()
        with open(os.path.join(fixtures, name), encoding="utf-8") as f:
            assert got == f.read(), name


def test_fixture_and_spdx_lists_match_jax():
    assert port_vendoring.fixture_names() == jax_vendoring.fixture_names()
    assert port_vendoring.NON_PROJECT_FIXTURES == \
        jax_vendoring.NON_PROJECT_FIXTURES
    assert port_vendoring.vendored_spdx_ids() == \
        jax_vendoring.vendored_spdx_ids()


def fake_checkouts(root: str) -> tuple:
    """A choosealicense.com checkout and a license-list-XML checkout
    shaped like the vendor tree (with one extra XML the include list
    must leave behind)."""
    cal = os.path.join(root, "choosealicense.com")
    for sub in ("_data", "_licenses"):
        shutil.copytree(os.path.join(port_vendoring.VENDOR_LICENSES_DIR,
                                     sub), os.path.join(cal, sub))
    xml = os.path.join(root, "license-list-XML")
    shutil.copytree(os.path.join(port_vendoring.VENDOR_SPDX_DIR, "src"),
                    os.path.join(xml, "src"))
    with open(os.path.join(xml, "src", "Extra-1.0.xml"), "w",
              encoding="utf-8") as f:
        f.write("<SPDXLicenseCollection/>")
    return cal, xml


def vendor_run(vendoring, root: str, cal: str, xml: str) -> list:
    """Re-vendor both trees under ``root``: the relative paths copied,
    then the refusals of checkouts that are not one."""
    lic_dir = os.path.join(root, "licenses")
    spdx_dir = os.path.join(root, "spdx")
    out = [[os.path.relpath(p, root) for p in
            vendoring.vendor_licenses(cal, lic_dir)],
           [os.path.relpath(p, root) for p in
            vendoring.vendor_spdx(xml, spdx_dir, licenses_vendor_dir=lic_dir)]]
    empty = os.path.join(root, "empty")
    os.makedirs(os.path.join(empty, "src"))
    for call in (lambda: vendoring.vendor_licenses(empty, lic_dir),
                 lambda: vendoring.vendor_spdx(cal, spdx_dir,
                                               licenses_vendor_dir=lic_dir),
                 lambda: vendoring.vendor_spdx(
                     empty, spdx_dir, licenses_vendor_dir=lic_dir)):
        try:
            call()
            out.append(None)
        except FileNotFoundError as exc:
            out.append(str(exc).replace(root, "ROOT").replace(
                os.path.dirname(cal), "CO"))
    return out


def test_revendoring_matches_jax(tmp_path):
    cal, xml = fake_checkouts(str(tmp_path / "co"))
    answers = [vendor_run(v, str(tmp_path / name), cal, xml)
               for name, v in (("jax", jax_vendoring),
                               ("port", port_vendoring))]
    assert answers[0] == answers[1]
    assert all(isinstance(a, str) for a in answers[0][2:])
    for sub in ("licenses", "spdx"):
        cmp = filecmp.dircmp(tmp_path / "jax" / sub, tmp_path / "port" / sub)
        assert not (cmp.left_only or cmp.right_only or cmp.diff_files)
    # the re-vendored trees are the shipped ones
    assert sorted(os.listdir(tmp_path / "port" / "spdx" / "src")) == sorted(
        os.listdir(os.path.join(port_vendoring.VENDOR_SPDX_DIR, "src")))
