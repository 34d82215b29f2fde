"""A real fleet of the port's `serve` workers, on the CPU.

`fleet --workers 2 --device cpu` through the port's CLI as a child
process: the answers through its front socket equal a JAX `serve`
session's over stdio on the same requests (vendored variants and the
fixtures' license files), with the trace ID, the cache flag and the
worker that answered left out, and the merged exposition equal in its
families to the JAX package's but for the port's
`device_kernel_launches`; then chip_smoke.py's phase 11 at its tiny
size on the CPU."""

import base64
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import chip_smoke
from licensee_tpu.cli.main import main as jax_main
from licensee_tpu_torch.fleet.wire import WireError, oneshot
from licensee_tpu_torch.obs import check_exposition

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def requests() -> list:
    bases = chip_smoke.vendored_bases()
    reqs = chip_smoke.variant_requests(bases, 40, "live")
    for name in ("mit", "apache-2.0_markdown", "bsd-3-lists", "cc0-cc",
                 "bsd-plus-patents"):
        d = os.path.join(FIXTURES, name)
        for f in sorted(os.listdir(d)):
            with open(os.path.join(d, f), "rb") as fh:
                reqs.append({"id": len(reqs), "filename": f,
                             "content_b64": base64.b64encode(
                                 fh.read()).decode()})
    reqs.append({"id": len(reqs), "content": "Copyright (c) 2020 Someone\n"})
    reqs.append({"id": len(reqs), "content": ""})
    return reqs


def families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    front = str(root / "front.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "licensee_tpu_torch.cli.main", "fleet",
         "--workers", "2", "--socket", front, "--socket-dir", str(root),
         "--max-batch", "16", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.perf_counter() + 180
        while not os.path.exists(front):
            assert proc.poll() is None, proc.stderr.read()
            assert time.perf_counter() < deadline
            time.sleep(0.05)
        yield front, root
    finally:
        proc.terminate()
        _out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-2000:]
        assert not os.path.exists(front)


def test_fleet_answers_match_a_jax_serve_session(fleet, monkeypatch):
    front, _root = fleet
    reqs = requests()
    rows, _took = chip_smoke.socket_run(front, reqs, 4, 4)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in reqs)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_main(["serve", "--max-batch", "16"]) == 0
    want = {r["id"]: r for r in map(json.loads, out.getvalue().splitlines())}
    assert set(rows) == set(want)
    for i, row in rows.items():
        assert chip_smoke.fleet_verdict(row) == chip_smoke.verdict_of(
            want[i]), (row, want[i])
    assert {r.get("matcher") for r in rows.values()} >= {"dice", "exact"}
    assert all(r["worker"] in ("w0", "w1") for r in rows.values())


def test_fleet_exposition_and_worker_gauge(fleet):
    front, root = fleet
    merged = oneshot(front, {"op": "stats", "format": "prometheus"},
                     30.0)["prometheus"]
    assert check_exposition(merged) == []
    worker = oneshot(str(root / "w0.sock"),
                     {"op": "stats", "format": "prometheus"},
                     30.0)["prometheus"]
    assert "device_kernel_launches" in families(worker)
    # the card's kernels launch nowhere on the CPU
    assert all(n == 0 for n in chip_smoke.launch_counts(worker).values())
    with pytest.raises(WireError):
        oneshot(str(root / "w9.sock"), {"op": "stats"}, 1.0)


def test_chip_smoke_phase11_on_cpu():
    report = chip_smoke.phase_fleet(np, torch, seed=0, device="cpu",
                                    scale=chip_smoke.FleetScale.tiny())
    timing = report["timing"]
    assert report["launches"] == {("serve", "best_match_fused"): 0,
                                  ("serve608", "best_match_fused"): 0}
    assert timing["kill"]["restarts"] == 1
    assert [r["run"] for r in timing["runs"]] == [
        "front T=47", "edge T=47", "front T=608", "edge T=608"]
    assert set(timing["workers"]) == {"w0", "w1"}
    assert timing["roll"]["rows_new"] > 0


def test_worker_without_a_card_is_a_crash(tmp_path):
    """`fleet` on the card (its default) where no card is visible: each
    worker exits 1 at boot, the supervisor counts a crash and respawns
    it, and the fleet never serves; no worker falls back to the CPU."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "licensee_tpu_torch.cli.main", "fleet",
         "--workers", "1", "--socket", str(tmp_path / "f.sock"),
         "--socket-dir", str(tmp_path), "--boot-timeout", "8",
         "--restart-backoff-ms", "100"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "error: workers failed to boot" in proc.stderr
    assert "'exit_codes': [1" in proc.stderr
    assert "'reason': 'crash', 'exit_code': 1" in proc.stderr
    assert not (tmp_path / "f.sock").exists()
