"""AST-accurate ports of the script/lint house rules.

The regex originals matched raw text, so ``"time.time()"`` inside a
docstring or a log message tripped them, and ``from time import time``
slipped past.  These ports resolve aliased imports and look only at
real call expressions — strings and comments are invisible to the AST.

* **wallclock-time** — the long-running serving/observability
  subsystems use monotonic clocks only: an NTP step must never produce
  a negative latency in a week-old worker.
* **no-print** — exporters, selftests, and fleet/stripe processes
  write to explicit streams; a layer that chats on stdout corrupts the
  JSONL transport it observes or fronts.
* **per-blob-featurize** — hot paths cross the native boundary through
  the shared batch path only (prepare_batch / featurize_batch /
  produce_batch); one crossing covers a whole worker chunk.
"""

from __future__ import annotations

import ast

from licensee_tpu_torch.analysis.core import rule
from licensee_tpu_torch.analysis.rules_concurrency import _imports

WALLCLOCK_DIRS = (
    "licensee_tpu_torch/serve",
    "licensee_tpu_torch/obs",
    "licensee_tpu_torch/fleet",
    "licensee_tpu_torch/jobs",
    "licensee_tpu_torch/parallel/stripes",
    # remote ingest: retry backoff timing must survive clock steps
    # (file-precise gates — ingest/verdict.py has a legitimate stdout
    # print mode, so the whole package is NOT opted in)
    "licensee_tpu_torch/ingest/remote",
    "licensee_tpu_torch/ingest/loopback",
)
NO_PRINT_DIRS = (
    "licensee_tpu_torch/obs",
    "licensee_tpu_torch/fleet",
    "licensee_tpu_torch/jobs",
    "licensee_tpu_torch/parallel/stripes",
    "licensee_tpu_torch/ingest/remote",
    "licensee_tpu_torch/ingest/loopback",
)
PER_BLOB_DIRS = (
    "licensee_tpu_torch/projects",
    "licensee_tpu_torch/serve",
)
PER_BLOB_METHODS = ("featurize", "featurize_raw", "stage1", "stage2")


@rule(
    "wallclock-time",
    dirs=WALLCLOCK_DIRS,
    doc=(
        "Wall-clock time.time() in a monotonic-clock subsystem "
        "(use time.perf_counter)"
    ),
)
def check_wallclock(module):
    imports = _imports(module)
    findings = []
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            if imports.qualify(node.func) == "time.time":
                findings.append(
                    module.finding(
                        "wallclock-time",
                        node.lineno,
                        "wall-clock time.time() — latency/deadline math "
                        "here must survive an NTP step; use "
                        "time.perf_counter",
                    )
                )
    return findings


@rule(
    "no-print",
    dirs=NO_PRINT_DIRS,
    doc="print() in a subsystem that must write to explicit streams",
)
def check_no_print(module):
    imports = _imports(module)
    findings = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        qn = imports.qualify(node.func)
        if qn in ("print", "builtins.print"):
            findings.append(
                module.finding(
                    "no-print",
                    node.lineno,
                    "print() — this layer shares stdout with a JSONL "
                    "transport; write to an explicit stream or the "
                    "on_event callback",
                )
            )
    return findings


@rule(
    "per-blob-featurize",
    dirs=PER_BLOB_DIRS,
    doc=(
        "Per-blob native featurize call on a hot path (route through "
        "the batch crossing)"
    ),
)
def check_per_blob_featurize(module):
    findings = []
    for node in ast.walk(module.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in PER_BLOB_METHODS
        ):
            findings.append(
                module.finding(
                    "per-blob-featurize",
                    node.lineno,
                    f"per-blob native '.{node.func.attr}()' call on a "
                    "hot path — blobs cross the ctypes boundary through "
                    "the shared batch path (prepare_batch / "
                    "featurize_batch / produce_batch) only",
                )
            )
    return findings
