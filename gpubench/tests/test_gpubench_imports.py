"""The import check: a module counts as JAX's or the JAX package's by its
whole top-level name, and neither the harness nor the reference loads
one."""

import os
import shutil
import subprocess
import sys

from gpubench import spec
from gpubench.device import forbidden_modules


def test_whole_top_level_names():
    loaded = ["licensee_tpu_torch", "licensee_tpu_torch.kernels.batch",
              "jaxtyping", "numpy", "jax", "jax.numpy", "licensee_tpu",
              "licensee_tpu.kernels", "flax.linen", "jaxlib.xla_client"]
    assert forbidden_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "licensee_tpu", "licensee_tpu.kernels"]


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import gpubench.run, gpubench.control, gpubench.ref.classify;"
        "from gpubench import spec;"
        "b = spec.load_json(spec.ROOT, 'BENCHMARK.json');"
        "[spec.metric_reader(m['name']) for m in b['per_layer']];"
        "cells = [spec.Cell(w['name'], b) for w in b['workloads']];"
        "[(c.driver(), c.generator(), spec.corpus(c.config))"
        " for c in cells];"
        "from gpubench.device import forbidden_modules;"
        "print(forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code, spec.ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import gpubench.ref.classify;"
        "from gpubench import spec;"
        "spec.reference_templates(spec.load_json(sys.argv[1], 'gpubench',"
        " 'configs', 'lic47.json'));"
        "print(sorted(m for m in sys.modules if m.startswith('licensee')))")
    out = subprocess.run([sys.executable, "-c", code, spec.ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_bare_checkout_of_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "lic47.batch-variants", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
