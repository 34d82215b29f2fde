"""Each cell as the driver runs it, on the card: ``python -m pytest
gpubench/tests -m cuda -q`` on a machine with one.  Skips (decided in the
test) where there is none."""

import json
import subprocess
import sys

import pytest

from gpubench import spec

BENCH = spec.load_json(spec.ROOT, "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_of_each_cell_is_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", name, "--seed",
         str(2**31 + 7), "--seconds", "10", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    assert list(line)[-1] == "checks"
