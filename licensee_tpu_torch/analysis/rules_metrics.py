"""The metrics-name lint: every series registered through the
obs/registry.py API must appear in the README metric reference table
or in the port-only table of ``licensee_tpu_torch/METRICS.md`` (the
series the JAX package does not register, so a README row for them
would fail the JAX package's own lint), every documented series must
still exist in code, and names must
satisfy the exposition grammar conventions ``check_exposition``
enforces at scrape time (so a bad name fails CI before it fails a
Prometheus server).

Registrations are extracted syntactically: ``registry.counter("x")`` /
``.gauge`` / ``.histogram`` calls with a constant first argument, plus
f-string names (``f"pipeline_{name}_busy"``) which become ``*``
wildcard patterns matched against the documented names.  The README
side is any markdown table whose header row is ``| name | type | ... |``
— backticked tokens in the first cell, ``{label}`` suffixes stripped,
``/`` and ``+`` separating multiple series per row.

Selftest modules (``*/selftest.py``) are exempt: their throwaway
``t_*`` series exist to test the registry, not to be scraped.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re

from licensee_tpu_torch.analysis.core import Finding, program_rule

_REG_METHODS = ("counter", "gauge", "histogram")
_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_EXCLUDE_BASENAMES = ("selftest.py",)
_BACKTICK_RE = re.compile(r"`([^`]+)`")
_LABELS_RE = re.compile(r"\{[^}]*\}")
# the metric tables the lint reads, relative to the program root: the
# README's, and the port's own; a missing file contributes no rows
METRIC_DOCS = ("README.md", os.path.join("licensee_tpu_torch", "METRICS.md"))


def extract_metric_registrations(tree) -> list:
    """[(name_or_pattern, kind, line, exact)] for every registration
    with a statically-visible name."""
    out = []
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _REG_METHODS
            and node.args
        ):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.append([arg.value, node.func.attr, node.lineno, True])
        elif isinstance(arg, ast.JoinedStr):
            parts = []
            for piece in arg.values:
                if isinstance(piece, ast.Constant) and isinstance(
                    piece.value, str
                ):
                    parts.append(piece.value)
                else:
                    parts.append("*")
            pattern = "".join(parts)
            if pattern.strip("*"):
                out.append([pattern, node.func.attr, node.lineno, False])
    return out


def documented_metrics(readme_text: str) -> dict[str, int]:
    """{series name: README line} from every ``| name | type | ... |``
    markdown table."""
    out: dict[str, int] = {}
    in_table = False
    for lineno, raw in enumerate(readme_text.splitlines(), 1):
        line = raw.strip()
        if not line.startswith("|"):
            in_table = False
            continue
        cells = [c.strip() for c in line.strip("|").split("|")]
        if not in_table:
            header = [c.lower() for c in cells]
            if "name" in header and "type" in header:
                in_table = True
            continue
        if cells and set(cells[0]) <= {"-", " ", ":"}:
            continue  # the |---|---| separator row
        if not cells:
            continue
        for token in _BACKTICK_RE.findall(cells[0]):
            name = _LABELS_RE.sub("", token).strip()
            if _NAME_RE.match(name):
                out.setdefault(name, lineno)
    return out


@program_rule(
    "metrics-doc",
    doc=(
        "A metric registered through obs/registry.py is missing from "
        "the README metric reference table and the port-only table of "
        "licensee_tpu_torch/METRICS.md (or a documented series is "
        "gone from code), or a registered name violates the exposition "
        "grammar conventions (counters end in _total, names match the "
        "Prometheus charset)"
    ),
)
def check_metrics_doc(program):
    if not program.complete or not program.root:
        return []
    regs = []  # (rel, name, kind, line, exact)
    for s in program.by_rel.values():
        base = s.rel.replace("\\", "/").rsplit("/", 1)[-1]
        if base in _EXCLUDE_BASENAMES:
            continue
        for name, kind, line, exact in s.metrics:
            regs.append((s.rel, name, kind, line, bool(exact)))
    if not regs:
        return []
    findings: list[Finding] = []
    # grammar conventions hold with or without a README
    for rel, name, kind, line, exact in regs:
        bare = name.replace("*", "x") if not exact else name
        if not _NAME_RE.match(bare):
            findings.append(Finding(
                rel, line, "metrics-doc",
                f"metric name {name!r} violates the exposition grammar "
                "([a-zA-Z_:][a-zA-Z0-9_:]*) — check_exposition would "
                "reject the scrape",
            ))
        elif kind == "counter" and exact and not name.endswith("_total"):
            findings.append(Finding(
                rel, line, "metrics-doc",
                f"counter {name!r} should end in '_total' (the "
                "exposition convention every existing counter follows)",
            ))
    documented: dict[str, tuple[str, int]] = {}  # name -> (doc, line)
    any_doc = False
    for doc_rel in METRIC_DOCS:
        try:
            with open(os.path.join(program.root, doc_rel),
                      encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        any_doc = True
        for name, line in documented_metrics(text).items():
            documented.setdefault(name, (doc_rel.replace(os.sep, "/"),
                                         line))
    if not any_doc:
        return findings  # no README to hold the table: grammar only

    def covered(name: str, exact: bool) -> bool:
        if exact:
            return name in documented
        return any(
            fnmatch.fnmatchcase(doc, name) for doc in documented
        )

    seen: set[str] = set()
    for rel, name, kind, line, exact in regs:
        if name in seen:
            continue
        seen.add(name)
        if not covered(name, exact):
            findings.append(Finding(
                rel, line, "metrics-doc",
                f"metric {name!r} is registered here but missing from "
                "the README metric reference table and the port-only "
                "table of licensee_tpu_torch/METRICS.md — the namespace "
                "must not grow undocumented",
            ))
    for doc_name, (doc_rel, doc_line) in sorted(documented.items()):
        hit = any(
            (exact and doc_name == name)
            or (not exact and fnmatch.fnmatchcase(doc_name, name))
            for _rel, name, _kind, _line, exact in regs
        )
        if not hit:
            findings.append(Finding(
                doc_rel, doc_line, "metrics-doc",
                f"{doc_rel} documents metric {doc_name!r} but no "
                "registration in the tree produces it — stale docs "
                "mislead dashboards",
            ))
    return findings
