"""The port's entry points against the JAX package's: the graft-entry
twin (`licensee_tpu_torch/graft_entry.py` against `__graft_entry__.py`),
the `bin/licensee-tpu-torch` launcher against `bin/licensee-tpu`, and
the `pyproject.toml` script line, on the CPU."""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tomllib

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from licensee_tpu.kernels.batch import BatchClassifier as JaxBatchClassifier
from licensee_tpu_torch import graft_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_matches_the_jax_entry():
    """The example features and one scoring step, bit for bit: the port's
    plain `dice_ref.best_match` against the JAX step under `jax.jit`."""
    jax_fn, jax_args = jax_graft.entry()
    want = jax.jit(jax_fn)(*jax_args)
    fn, args = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got_args = (args[0].numpy().view(np.uint32),
                *(a.numpy() for a in args[1:]))
    for g, w in zip(got_args, jax_args, strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    got = fn(*args)
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    # every example is a rendered template: its own key wins
    assert (got[0].numpy()[:4] == [0, 1, 2, 3]).all()


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX `BatchClassifier`'s unsharded rows for the dry run's
    blobs, by batch size."""
    cache = {}

    def rows(batch):
        if batch not in cache:
            contents, _expected = graft_entry.dryrun_blobs(batch)
            classifier = JaxBatchClassifier(pad_batch_to=batch, mesh=None)
            cache[batch] = classifier.classify_blobs(contents,
                                                     threshold=25.0)
        return cache[batch]

    return rows


def _fields(r) -> tuple:
    return (r.key, r.matcher, r.confidence, r.score_num, r.score_den,
            r.error)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_dryrun_multichip_on_the_cpu(n_devices, jax_rows, capsys):
    rows = graft_entry.dryrun_multichip(n_devices, device="cpu")
    n_model = 2 if n_devices % 2 == 0 else 1
    n_data = n_devices // n_model
    batch = max(n_data * 8, 16)
    assert [_fields(r) for r in rows] == [_fields(r)
                                          for r in jax_rows(batch)]
    assert capsys.readouterr().out == (
        f"dryrun_multichip OK: mesh={{'data': {n_data}, 'model': "
        f"{n_model}}}, batch={batch}, agreement={batch}/{batch} (product "
        "BatchClassifier path)\n")


def test_entry_points_refuse_to_fall_back_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)
    run = subprocess.run(
        [sys.executable, "-m", "licensee_tpu_torch.graft_entry"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode == 1 and "CUDA is not available" in run.stderr
    assert "entry OK" not in run.stdout


def test_module_main_prints_the_jax_entry_line():
    """``python -m licensee_tpu_torch.graft_entry --device cpu`` prints
    what ``python __graft_entry__.py`` prints; ``dryrun N`` its line."""
    port = subprocess.run(
        [sys.executable, "-m", "licensee_tpu_torch.graft_entry", "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert port.returncode == 0, port.stderr
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "__graft_entry__.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300, env=env)
    assert ref.returncode == 0, ref.stderr
    assert port.stdout.startswith("entry OK: [array([0, 1, 2, 3]")
    assert port.stdout == ref.stdout
    dry = subprocess.run(
        [sys.executable, "-m", "licensee_tpu_torch.graft_entry", "dryrun",
         "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert dry.returncode == 0, dry.stderr
    assert dry.stdout.startswith(
        "dryrun_multichip OK: mesh={'data': 1, 'model': 2}, batch=16")


def _launch(script: str, argv: list) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", script), *argv],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)


@pytest.mark.parametrize("argv", [
    ["version"], ["help"], ["detect", "tests/fixtures/mit", "--json"],
], ids=["version", "help", "detect-json"])
def test_launcher_matches_the_jax_launcher(argv):
    """`bin/licensee-tpu-torch` answers as `bin/licensee-tpu` does, but
    for the program name; `help` lists the same verbs with the same
    lines, the port's CLI naming the GPU where the JAX package's names
    the TPU (batch-detect's line) and listing corpus-build beside
    batch-detect."""
    want = _launch("licensee-tpu", argv)
    got = _launch("licensee-tpu-torch", argv)
    assert want.returncode == got.returncode == 0, got.stderr
    out = got.stdout.replace("licensee-tpu-torch", "licensee-tpu")
    if argv != ["help"]:
        assert out == want.stdout
        return
    assert re.search(r"^  licensee-tpu-torch detect ", got.stdout, re.M)
    head, *lines = out.splitlines()
    want_head, *want_lines = want.stdout.splitlines()
    assert head == want_head == "Licensee commands:"
    by_verb = {line.split()[1]: line for line in lines}
    want_by_verb = {line.split()[1]: line for line in want_lines}
    want_by_verb["batch-detect"] = want_by_verb["batch-detect"].replace(
        "on the TPU batch path", "on the GPU batch path")
    assert by_verb == want_by_verb


def test_pyproject_script_resolves_to_the_port_cli():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    scripts = project["project"]["scripts"]
    assert scripts["licensee-tpu-torch"] == "licensee_tpu_torch.cli.main:main"
    module, attr = scripts["licensee-tpu-torch"].split(":")
    from importlib import import_module

    from licensee_tpu_torch.cli.main import main
    assert getattr(import_module(module), attr) is main
    assert scripts["licensee-tpu"] == "licensee_tpu.cli.main:main"
    assert "licensee_tpu*" in project["tool"]["setuptools"]["packages"][
        "find"]["include"]
