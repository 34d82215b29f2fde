"""The port's fleet selftests in their stub mode, on the CPU.

`fleet --selftest --stub` (an open-loop burst with a slowloris, a
SIGKILL under traffic with zero client errors, the restart within its
backoff, trace propagation, the merged exposition, the flight
recorder's harvest, the telemetry drill's stored p99 and its one alert,
the assembled traces, a clean drain), `--selftest-reload --stub` (three
rolls, a corrupt artifact, a refused roll rolled back, a SIGKILL mid-
swap) and `--selftest-tcp --stub` (two supervisor domains over loopback
TCP behind a federated front and the HTTP edge) through the port's CLI,
as three child processes started together: each must exit 0 and print
``"problems": []``."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("--selftest", "--selftest-reload", "--selftest-tcp")


@pytest.fixture(scope="module")
def selftests():
    procs = {
        flag: subprocess.Popen(
            [sys.executable, "-m", "licensee_tpu_torch.cli.main", "fleet",
             flag, "--stub"], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for flag in FLAGS
    }
    done = {}
    try:
        for flag, proc in procs.items():
            out, err = proc.communicate(timeout=240)
            done[flag] = (proc.returncode, out, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return done


@pytest.mark.parametrize("flag", FLAGS)
def test_fleet_stub_selftest_passes(selftests, flag):
    rc, out, err = selftests[flag]
    summary = json.loads(err.strip().splitlines()[-1])
    assert rc == 0 and summary["problems"] == [], (out, err[-3000:])
    assert summary["stub_workers"] is True
