"""The rule engine: one shared parse per file, a rule registry with
path-component gating, pragma suppression, and the
``python -m licensee_tpu_torch.analysis`` command.

Each rule is a function ``check(module: Module) -> list[Finding]``
registered under a stable rule id.  The engine parses every file ONCE
(``ast`` tree + ``tokenize`` comment scan) and hands the same ``Module``
to every applicable rule, so adding a rule costs one AST walk, never a
re-parse.  Findings print as ``path:line: rule-id: message`` and the
command exits non-zero when any survive pragma filtering.

Pragmas (the escape hatch — every use needs a justification comment):

* ``# analysis: disable=rule-id[,rule-id2]`` on the offending line, or
  as a standalone comment on the line directly above it, suppresses the
  named rules (or ``all``) for that line.
* The same pragma on a ``def``/``class`` line suppresses the named
  rules for the whole body — for functions whose contract is the
  exception (e.g. "caller holds the lock" spawn helpers).

Dir gating matches on PATH COMPONENTS, never string prefixes: the gate
``licensee_tpu_torch/parallel/stripes`` applies to ``stripes.py`` and any
future ``stripes/`` package, but never to a ``stripes_util.py`` that
merely shares the prefix (the script/lint bug this engine replaces).
"""

from __future__ import annotations

import ast
import io
import os
import tokenize
from dataclasses import dataclass

PRAGMA_PREFIX = "analysis:"
SKIP_DIRS = {
    ".git", "__pycache__", ".pytest_cache", ".hypothesis", "dist",
    "build", "vendor", "tests", ".venv", "venv", ".tox", ".eggs",
    "node_modules", ".analysis-cache",
}
# what the command scans by default: the port's package and its launcher
# (tests/ are excluded — they exercise violations on purpose; the
# fixture corpora under tests/fixtures/ doubly so)
DEFAULT_SCAN = ("licensee_tpu_torch", "bin/licensee-tpu-torch")


@dataclass(frozen=True)
class Finding:
    path: str  # repo-relative
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


class Module:
    """One parsed source file: the AST, raw lines, the pragma map, and
    the repo-relative path split into components for dir gating."""

    def __init__(self, rel: str, text: str):
        self.rel = rel
        self.text = text
        self.tree = ast.parse(text)
        self.lines = text.splitlines()
        # {lineno: set of rule ids (or {"all"})} for inline pragmas;
        # standalone-comment pragmas are resolved at filter time
        self.pragmas, self.pragma_only_lines = _collect_pragmas(text)
        self.parts = tuple(p for p in rel.replace(os.sep, "/").split("/") if p)

    def finding(self, rule: str, node_or_line, message: str) -> Finding:
        line = (
            node_or_line
            if isinstance(node_or_line, int)
            else node_or_line.lineno
        )
        return Finding(self.rel, line, rule, message)

    # -- pragma filtering --

    def suppressed(self, finding: Finding) -> bool:
        return self.suppressing_line(finding) is not None

    def suppressing_line(self, finding: Finding) -> int | None:
        """The pragma line that suppresses ``finding`` (the stale-pragma
        rule's usage ledger rides this), or None."""
        for line in (finding.line, finding.line - 1):
            rules = self.pragmas.get(line)
            if rules is None:
                continue
            if line != finding.line and line not in self.pragma_only_lines:
                continue  # a trailing pragma governs its OWN line only
            if "all" in rules or finding.rule in rules:
                return line
        return self._scope_suppressing_line(finding)

    def _scope_suppressing_line(self, finding: Finding) -> int | None:
        """A pragma on a ``def``/``class`` line — or a standalone
        pragma comment directly above one — covers the whole body."""
        for line, rules in self.pragmas.items():
            if not ("all" in rules or finding.rule in rules):
                continue
            candidates = [line]
            if line in self.pragma_only_lines:
                candidates.append(line + 1)
            for cand in candidates:
                scope = self._scope_span(cand)
                if (
                    scope is not None
                    and scope[0] <= finding.line <= scope[1]
                ):
                    return line
        return None

    def scope_spans(self) -> dict:
        """{def/class/decorator line: (start, end)} — the def-scope
        pragma surface, also exported into the program summary so
        cached files filter without an AST."""
        spans = getattr(self, "_scope_spans", None)
        if spans is None:
            spans = {}
            for node in ast.walk(self.tree):
                if isinstance(
                    node,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                ):
                    span = (node.lineno, node.end_lineno)
                    spans[node.lineno] = span
                    # a decorated def starts, for pragma purposes, at
                    # its first decorator: "directly above the def"
                    # must keep working when @jax.jit sits in between
                    for deco in node.decorator_list:
                        spans.setdefault(deco.lineno, span)
            self._scope_spans = spans
        return spans

    def _scope_span(self, line: int):
        return self.scope_spans().get(line)


def _collect_pragmas(text: str):
    """COMMENT tokens matching ``# analysis: disable=...`` — tokenizing
    (not regexing) means a pragma inside a string literal is inert,
    exactly like the rules the pragmas govern."""
    pragmas: dict[int, set[str]] = {}
    pragma_only: set[int] = set()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(text).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            body = tok.string.lstrip("#").strip()
            if not body.startswith(PRAGMA_PREFIX):
                continue
            directive = body[len(PRAGMA_PREFIX):].strip()
            if not directive.startswith("disable="):
                continue
            # everything after the first whitespace is justification
            # prose: `# analysis: disable=rule-id — why this is fine`
            rule_list = directive[len("disable="):].split(None, 1)[0]
            rules = {
                r.strip() for r in rule_list.split(",") if r.strip()
            }
            if not rules:
                continue
            line = tok.start[0]
            pragmas.setdefault(line, set()).update(rules)
            if not tok.line[: tok.start[1]].strip():
                pragma_only.add(line)
    except tokenize.TokenError:
        pass
    return pragmas, pragma_only


# -- the rule registries --


@dataclass(frozen=True)
class Rule:
    rule_id: str
    check: object  # callable(Module) -> list[Finding]
    dirs: tuple[tuple[str, ...], ...] | None  # None: every scanned file
    doc: str


RULES: dict[str, Rule] = {}


@dataclass(frozen=True)
class ProgramRule:
    """A whole-program rule: ``check(program)`` sees every module
    summary at once (call graph, protocol facts, metric registrations).
    ``post=True`` rules run AFTER pragma-usage accounting — the
    stale-pragma rule reads the ledger everyone else wrote."""

    rule_id: str
    check: object  # callable(Program) -> list[Finding]
    doc: str
    post: bool = False


PROGRAM_RULES: dict[str, ProgramRule] = {}


def rule(rule_id: str, dirs=None, doc: str = ""):
    """Register ``check(module)`` under ``rule_id``.  ``dirs`` is an
    iterable of ``a/b/c`` gates matched on path components (a gate's
    last component also matches ``<component>.py``)."""

    def deco(fn):
        gates = (
            None
            if dirs is None
            else tuple(tuple(d.split("/")) for d in dirs)
        )
        RULES[rule_id] = Rule(rule_id, fn, gates, doc or (fn.__doc__ or ""))
        return fn

    return deco


def program_rule(rule_id: str, doc: str = "", post: bool = False):
    """Register ``check(program)`` under ``rule_id`` in the
    whole-program registry."""

    def deco(fn):
        PROGRAM_RULES[rule_id] = ProgramRule(
            rule_id, fn, doc or (fn.__doc__ or ""), post
        )
        return fn

    return deco


@program_rule(
    "stale-pragma",
    post=True,  # runs after every other rule settled the usage ledger
    doc=(
        "A `# analysis: disable=rule-id` pragma that no longer "
        "suppresses any finding is itself a finding — the escape-hatch "
        "inventory can only shrink"
    ),
)
def check_stale_pragma(program):
    """Every pragma must pay rent: per-file and whole-program filtering
    record which pragma lines suppressed at least one finding, and
    whatever is left over is dead weight (typically a violation that a
    later refactor fixed for real, or a misspelled rule id that never
    matched anything)."""
    if not program.complete:
        return []  # a partial scan cannot prove a pragma useless
    findings = []
    for rel in sorted(program.by_rel):
        s = program.by_rel[rel]
        used = program.pragma_used.get(rel, set())
        for line in sorted(s.pragmas):
            if line in used:
                continue
            rules = ",".join(sorted(s.pragmas[line]))
            findings.append(Finding(
                rel, line, "stale-pragma",
                f"pragma 'disable={rules}' suppresses no finding; "
                "delete it (the escape-hatch inventory only shrinks)",
            ))
    return findings


def gate_matches(parts: tuple[str, ...], gate: tuple[str, ...]) -> bool:
    """Component-wise prefix match; the gate's LAST component also
    matches a module file of that name (``.../stripes`` covers both a
    ``stripes/`` package and ``stripes.py``)."""
    if len(parts) < len(gate):
        return False
    head, last = gate[:-1], gate[-1]
    if parts[: len(head)] != head:
        return False
    got = parts[len(head)]
    return got == last or got == f"{last}.py"


def applicable(module: Module, r: Rule, force_all: bool = False) -> bool:
    if force_all or r.dirs is None:
        return True
    return any(gate_matches(module.parts, g) for g in r.dirs)


def analyze_module(
    module: Module, force_all: bool = False, used_pragmas=None
) -> list[Finding]:
    """Run the PER-FILE rules over one module, pragma-filtered.
    ``used_pragmas`` (a set) collects the pragma lines that earned
    their keep — the stale-pragma ledger."""
    findings: list[Finding] = []
    for r in RULES.values():
        if applicable(module, r, force_all):
            findings.extend(r.check(module))
    kept = []
    for f in findings:
        line = module.suppressing_line(f)
        if line is None:
            kept.append(f)
        elif used_pragmas is not None:
            used_pragmas.add(line)
    return sorted(kept, key=lambda f: (f.line, f.rule))


def _run_program_rules(program, timings=None) -> list[Finding]:
    """All registered whole-program rules over ``program``, pragma-
    filtered (usage recorded on ``program.pragma_used``); ``post``
    rules run last, after the ledger settled."""
    import time as _time

    findings: list[Finding] = []
    for phase in (False, True):
        for pr in PROGRAM_RULES.values():
            if pr.post is not phase:
                continue
            t0 = _time.perf_counter()
            raw = pr.check(program)
            kept = program.filter_findings(raw)
            if timings is not None:
                entry = timings.setdefault(pr.rule_id, [0.0, 0])
                entry[0] += _time.perf_counter() - t0
                entry[1] += len(kept)
            findings.extend(kept)
    return findings


def analyze_source(
    text: str, rel: str = "<memory>", force_all: bool = True
) -> list[Finding]:
    """Analyze one source string (the fixture-test entry point) as a
    complete one-file program: per-file rules plus the whole-program
    rules (protocol, metrics, stale-pragma) over the lone summary.
    ``force_all`` bypasses dir gating so every rule sees the snippet."""
    from licensee_tpu_torch.analysis.program import Program, summarize

    module = Module(rel, text)
    used: set[int] = set()
    findings = analyze_module(module, force_all=force_all,
                              used_pragmas=used)
    program = Program(
        [summarize(module)], root=None, complete=True, force_all=force_all
    )
    program.pragma_used[rel] = used
    findings.extend(_run_program_rules(program))
    return sorted(findings, key=lambda f: (f.line, f.rule))


# -- file collection + the command --


def _is_python_script(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(21).startswith(b"#!/usr/bin/env python")
    except OSError:
        return False


def iter_python_files(root: str, scan=DEFAULT_SCAN):
    for entry in scan:
        top = os.path.join(root, entry)
        if os.path.isfile(top):
            if top.endswith(".py") or _is_python_script(top):
                yield top
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = sorted(
                d for d in dirnames if d not in SKIP_DIRS
            )
            for name in sorted(filenames):
                path = os.path.join(dirpath, name)
                if name.endswith(".py") or _is_python_script(path):
                    yield path


def analyze_paths(
    paths,
    root: str,
    force_all: bool = False,
    complete: bool = False,
    cache=None,
    changed_rels=None,
    timings=None,
) -> tuple[list[Finding], int]:
    """Analyze files; returns (findings, files_checked).  A file that
    does not parse yields a ``parse-error`` finding (script/lint's
    byte-compile gate normally catches this first).

    ``complete=True`` says the file set covers a whole program tree, so
    whole-universe rules (protocol drift, metrics-doc, stale-pragma)
    may reason about "nothing else handles X".  ``cache`` (an
    :class:`program.AnalysisCache`) skips parsing files whose content
    hash matches — per-file findings and the module summary come from
    the cache and the program rules recompute over summaries.
    ``changed_rels`` (with ``complete=True``) limits REPORTED findings
    to those files' reverse-dependency closure — the whole program is
    still summarized, so cross-module rules stay sound."""
    import time as _time

    from licensee_tpu_torch.analysis.program import (
        Program,
        content_sha,
        summarize,
    )

    findings: list[Finding] = []
    summaries = []
    used_by_rel: dict[str, set[int]] = {}
    checked = 0
    for path in paths:
        rel = os.path.relpath(path, root)
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        except (OSError, UnicodeDecodeError) as exc:
            findings.append(Finding(rel, 1, "parse-error", str(exc)))
            continue
        sha = content_sha(text)
        entry = cache.get(rel, sha) if cache is not None else None
        if entry is not None:
            from licensee_tpu_torch.analysis.program import ModuleSummary

            summaries.append(ModuleSummary.from_obj(entry["summary"]))
            used_by_rel[rel] = set(entry["used_pragmas"])
            findings.extend(
                Finding(rel, line, rule_id, message)
                for line, rule_id, message in entry["findings"]
            )
            checked += 1
            continue
        try:
            module = Module(rel, text)
        except SyntaxError as exc:
            findings.append(
                Finding(rel, exc.lineno or 1, "parse-error", str(exc.msg))
            )
            continue
        except ValueError as exc:
            # ast.parse raises bare ValueError for NUL bytes in source
            findings.append(Finding(rel, 1, "parse-error", str(exc)))
            continue
        checked += 1
        used: set[int] = set()
        file_findings: list[Finding] = []
        for r in RULES.values():
            if not applicable(module, r, force_all):
                continue
            t0 = _time.perf_counter()
            raw = r.check(module)
            kept = []
            for f in raw:
                pline = module.suppressing_line(f)
                if pline is None:
                    kept.append(f)
                else:
                    used.add(pline)
            if timings is not None:
                trow = timings.setdefault(r.rule_id, [0.0, 0])
                trow[0] += _time.perf_counter() - t0
                trow[1] += len(kept)
            file_findings.extend(kept)
        file_findings.sort(key=lambda f: (f.line, f.rule))
        summary = summarize(module)
        used_by_rel[rel] = used
        if cache is not None:
            cache.put(rel, sha, summary, file_findings, used)
        summaries.append(summary)
        findings.extend(file_findings)
    program = Program(
        summaries, root=root, complete=complete, force_all=force_all
    )
    program.pragma_used = used_by_rel
    program_findings = _run_program_rules(program, timings=timings)
    if changed_rels is not None:
        # the closure narrows only the PER-FILE reporting; whole-program
        # findings are global properties (a README row gone, a schema
        # op orphaned, a new cross-module edge) and always report —
        # --changed must never pass what the full scan fails
        closure = program.reverse_closure(changed_rels)
        findings = [f for f in findings if f.path in closure]
    findings.extend(program_findings)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule)), checked


def _iter_dir_files(dirpath: str):
    for walk_dir, dirnames, filenames in os.walk(dirpath):
        dirnames[:] = sorted(d for d in dirnames if d not in SKIP_DIRS)
        for name in sorted(filenames):
            path = os.path.join(walk_dir, name)
            if name.endswith(".py") or _is_python_script(path):
                yield path


def analyze_project(
    dirpath: str, force_all: bool = False
) -> tuple[list[Finding], int]:
    """Analyze a directory as a STANDALONE complete program rooted at
    the directory (the multi-file fixture mode, and what an explicit
    directory argument to the command means): module names and
    protocol/metrics roles resolve relative to the directory, and the
    whole-universe rules run over exactly its files."""
    return analyze_paths(
        _iter_dir_files(dirpath), dirpath, force_all=force_all,
        complete=True,
    )


# apart from the JAX package's analyzer's cache: each salts its entries
# with its own package, and neither reads the other's file
DEFAULT_CACHE_REL = os.path.join(".analysis-cache", "analyze-torch.json")


def _git_changed_rels(root: str, ref: str) -> set[str]:
    """Files changed vs ``ref`` plus untracked files, repo-relative."""
    import subprocess

    rels: set[str] = set()
    for argv in (
        ["git", "diff", "--name-only", ref, "--"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        run = subprocess.run(
            argv, cwd=root, capture_output=True, text=True,
        )
        if run.returncode != 0:
            raise RuntimeError(
                f"{' '.join(argv)}: {run.stderr.strip() or run.returncode}"
            )
        rels.update(
            line.strip() for line in run.stdout.splitlines() if line.strip()
        )
    return rels


def _print_stats(timings, checked, cache, elapsed_s, stream) -> None:
    stream.write(
        f"analyze --stats: {checked} files in {elapsed_s:.3f}s"
        + (
            f" (cache: {cache.hits} hit / {cache.misses} miss)"
            if cache is not None
            else ""
        )
        + "\n"
    )
    width = max((len(r) for r in timings), default=4)
    for rule_id, (secs, n) in sorted(
        timings.items(), key=lambda kv: -kv[1][0]
    ):
        stream.write(
            f"  {rule_id:<{width}}  {secs * 1000.0:8.1f} ms  "
            f"{n} finding(s)\n"
        )


def _cache_ab(root: str, stream) -> int:
    """The CI cache gate: a cold run then a warmed run over the same
    tree and a FRESH cache file must be finding-identical, and the
    warmed run must be faster (it re-parses nothing)."""
    import json as _json
    import tempfile
    import time as _time

    from licensee_tpu_torch.analysis.program import AnalysisCache, engine_salt

    salt = engine_salt()
    files = list(iter_python_files(root))
    with tempfile.TemporaryDirectory(prefix="analyze-ab-") as tmp:
        path = os.path.join(tmp, "analyze-torch.json")
        t0 = _time.perf_counter()
        cold_cache = AnalysisCache(path, salt)
        cold, n_cold = analyze_paths(
            files, root, complete=True, cache=cold_cache
        )
        cold_cache.save()
        cold_s = _time.perf_counter() - t0
        t1 = _time.perf_counter()
        warm_cache = AnalysisCache(path, salt)
        warm, n_warm = analyze_paths(
            files, root, complete=True, cache=warm_cache
        )
        warm_s = _time.perf_counter() - t1
    identical = [f.render() for f in cold] == [f.render() for f in warm]
    ok = identical and warm_s < cold_s and warm_cache.misses == 0
    stream.write(_json.dumps({
        "cache_ab": "ok" if ok else "FAIL",
        "cold_s": round(cold_s, 3),
        "warm_s": round(warm_s, 3),
        "speedup": round(cold_s / warm_s, 2) if warm_s > 0 else None,
        "files": n_cold,
        "warm_cache_misses": warm_cache.misses,
        "finding_identical": identical,
        "findings": len(cold),
    }) + "\n")
    return 0 if ok else 1


def main(argv=None) -> int:
    import argparse
    import sys
    import time as _time

    parser = argparse.ArgumentParser(
        prog="python -m licensee_tpu_torch.analysis",
        description=(
            "Whole-program AST static analysis: concurrency (lock "
            "discipline, cross-module blocking calls, resource leaks), "
            "tracer purity, the wire-protocol contract checker, the "
            "metrics-doc lint, stale pragmas, and the AST-accurate "
            "house rules."
        ),
    )
    parser.add_argument(
        "paths", nargs="*",
        help=(
            "Files/dirs to analyze (default: the port's package and "
            "its launcher).  A "
            "directory is analyzed as a standalone program rooted at "
            "itself (the fixture-program mode)."
        ),
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="Print the rule catalog"
    )
    parser.add_argument(
        "--changed", nargs="?", const="HEAD", default=None, metavar="REF",
        help=(
            "Report findings only for files changed vs REF (default "
            "HEAD) plus their reverse-dependency closure; the whole "
            "tree is still summarized, so cross-module rules stay "
            "sound"
        ),
    )
    parser.add_argument(
        "--stats", action="store_true",
        help="Print per-rule timing to stderr (analyzer cost tracking)",
    )
    parser.add_argument(
        "--cache", metavar="PATH", default=None,
        help=(
            "Incremental cache file (default: .analysis-cache/"
            "analyze-torch.json under the repo root for full-tree scans)"
        ),
    )
    parser.add_argument(
        "--no-cache", action="store_true",
        help="Disable the incremental cache for this run",
    )
    parser.add_argument(
        "--cache-ab", action="store_true",
        help=(
            "CI gate: cold-vs-warmed A/B over a fresh cache — asserts "
            "the warmed run is faster and finding-identical"
        ),
    )
    args = parser.parse_args(argv)
    if args.list_rules:
        for r in RULES.values():
            doc = " ".join((r.doc or "").split())
            sys.stdout.write(f"{r.rule_id}: {doc}\n")
        for pr in PROGRAM_RULES.values():
            doc = " ".join((pr.doc or "").split())
            sys.stdout.write(f"{pr.rule_id}: {doc}\n")
        return 0
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    if args.cache_ab:
        return _cache_ab(root, sys.stdout)
    timings: dict | None = {} if args.stats else None
    t0 = _time.perf_counter()
    findings: list[Finding] = []
    checked = 0
    cache = None
    if args.paths:
        if args.changed is not None:
            sys.stderr.write(
                "analyze: --changed applies to the default full scan, "
                "not explicit paths\n"
            )
            return 2
        files = []
        for p in args.paths:
            if not os.path.isdir(p):
                files.append(p)
                continue
            rel = os.path.relpath(os.path.abspath(p), root)
            inside_product = not rel.startswith("..") and rel.split(
                os.sep
            )[0] in {entry.split("/")[0] for entry in DEFAULT_SCAN}
            if inside_product:
                # a PRODUCT subtree keeps repo-rooted rels so dir
                # gating and pragma paths behave exactly like the full
                # scan (just narrowed)
                file_findings, n = analyze_paths(
                    _iter_dir_files(p), root, complete=False,
                    timings=timings,
                )
                findings.extend(file_findings)
                checked += n
            else:
                # anything else (fixture corpora, scratch programs) is
                # a standalone program rooted at the directory
                dir_findings, dir_checked = analyze_project(p)
                findings.extend(dir_findings)
                checked += dir_checked
        if files:
            file_findings, n = analyze_paths(
                files, root, complete=False, timings=timings
            )
            findings.extend(file_findings)
            checked += n
    else:
        if not args.no_cache:
            from licensee_tpu_torch.analysis.program import (
                AnalysisCache,
                engine_salt,
            )

            cache_path = args.cache or os.path.join(root, DEFAULT_CACHE_REL)
            cache = AnalysisCache(cache_path, engine_salt())
        changed_rels = None
        if args.changed is not None:
            try:
                changed_rels = _git_changed_rels(root, args.changed)
            except RuntimeError as exc:
                sys.stderr.write(f"analyze: --changed: {exc}\n")
                return 2
        findings, checked = analyze_paths(
            iter_python_files(root), root, complete=True, cache=cache,
            changed_rels=changed_rels, timings=timings,
        )
        if cache is not None:
            cache.save()
        if changed_rels is not None:
            sys.stderr.write(
                f"analyze: --changed: {len(changed_rels)} changed "
                f"file(s) vs {args.changed}, reporting their reverse-"
                "dependency closure\n"
            )
    for f in findings:
        sys.stdout.write(f.render() + "\n")
    if timings is not None:
        _print_stats(
            timings, checked, cache, _time.perf_counter() - t0, sys.stderr
        )
    sys.stderr.write(
        f"analyze: {checked} files, {len(RULES) + len(PROGRAM_RULES)} "
        f"rules, {len(findings)} finding(s)\n"
    )
    return 1 if findings else 0
