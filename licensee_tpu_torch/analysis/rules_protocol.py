"""The wire-protocol contract checker: every surface that speaks the
JSONL protocol (router, real worker, stub worker, wire helpers, CLI
clients, selftests, bench) is diffed against the declared schema
(protocol_schema.py) and against each other.

Extraction is syntactic and runs per file at summary time: request
dict literals (an ``"op"`` key, or an op-less ``content`` row) and
JSON-looking string constants record SENT ops and their request
fields; ``op == "stats"``-shaped comparisons record HANDLED ops;
response dict literals and ``row["field"] = ...`` stores record
EMITTED response fields and error codes (constant prefix before the
first ``:``); ``.get("field")`` / ``row["field"]`` / ``"field" in row``
record READS.  The program rules then check, over the whole tree:

* **protocol-drift** — an op sent that no surface handles; an op
  handled that nothing sends; ops/error codes/request fields absent
  from the schema (wire drift is a two-place change by design);
  response fields a client reads that no producer emits; schema
  entries with no remaining evidence (the declared-but-dead direction).
* **protocol-stub-divergence** — the stub worker (fleet/faults.py)
  must handle exactly the op set the real worker (serve/server.py)
  handles: "protocol-faithful" is a checked property, not a docstring.
* **protocol-http-drift** — the network edge's OUTER face: request
  lines sent by any harness vs the edge's ROUTES table vs
  protocol_schema.HTTP_ROUTES, the STATUS_TEXT table vs
  HTTP_STATUS_CODES (both directions), and literal ``_respond`` status
  mints vs the declared set.  (The edge's INNER face is a JSONL
  content row, so the worker/stub parity checks above cover it
  unchanged.)
"""

from __future__ import annotations

import ast
import json
import re

from licensee_tpu_torch.analysis import protocol_schema as schema
from licensee_tpu_torch.analysis.core import Finding, program_rule
from licensee_tpu_torch.analysis.scopes import rel_basename as _basename

_CODE_RE = re.compile(r"[a-z][a-z0-9_]*\Z")

# response-evidence keys: a dict literal carrying one of these (and no
# "op"/"content") is a response row, not an arbitrary mapping
_RESPONSE_EVIDENCE = {
    "error", "stats", "prometheus", "traces", "reload", "key",
    "retry_after",
}


def _const_str(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _error_code(value_node) -> str | None:
    """The error code carried by an ``"error"`` value: a constant (or
    the constant head of an f-string), prefix before the first colon."""
    text = _const_str(value_node)
    if text is None and isinstance(value_node, ast.JoinedStr):
        if value_node.values:
            text = _const_str(value_node.values[0])
    if text is None:
        return None
    code = text.split(":", 1)[0].strip()
    return code if _CODE_RE.match(code) else None


def _get_key(node) -> str | None:
    """The constant key of a ``x.get("k")`` / ``x["k"]`` expression."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "get"
        and node.args
    ):
        return _const_str(node.args[0])
    if isinstance(node, ast.Subscript):
        return _const_str(node.slice)
    return None


def _is_op_expr(node) -> bool:
    if isinstance(node, ast.Name) and node.id == "op":
        return True
    return _get_key(node) == "op"


def _classify_dict(keys: dict, line: int, facts: dict) -> None:
    if "op" in keys:
        op = _const_str(keys["op"])
        if op is not None:
            facts["sends"].append([op, line])
            for k in keys:
                if k != "op":
                    facts["req_fields"].append([op, k, line])
        return
    if "content" in keys or "content_b64" in keys:
        facts["sends"].append(["content", line])
        for k in keys:
            if k in schema.WATCHED_KEYS:
                facts["req_fields"].append(["content", k, line])
        return
    if not (set(keys) & _RESPONSE_EVIDENCE):
        return
    for k in keys:
        if k in schema.RESPONSE_FIELDS:
            facts["emits"].append([k, line])
    if "error" in keys:
        code = _error_code(keys["error"])
        if code is not None:
            facts["err_emit"].append([code, line])


# a request line a client harness writes ("POST /classify HTTP/1.1"),
# inside a string or bytes constant (f-string heads included)
_HTTP_SEND_RE = re.compile(
    r"\b(GET|POST|PUT|DELETE|HEAD|PATCH)\s+(/\S*)\s+HTTP/1\.[01]\b"
)


def _scan_http_sends(text: str, line: int, facts: dict) -> None:
    for m in _HTTP_SEND_RE.finditer(text):
        facts["http_sends"].append([m.group(1), m.group(2), line])


def _classify_http_tables(node: ast.Dict, facts: dict) -> None:
    """The edge's declared tables: a dict whose keys are all 2-tuples
    of string constants is a ROUTES table; one whose keys are all int
    constants with string values is a STATUS_TEXT table."""
    if not node.keys or any(k is None for k in node.keys):
        return
    routes = []
    for k in node.keys:
        if not (
            isinstance(k, ast.Tuple)
            and len(k.elts) == 2
            and all(_const_str(el) is not None for el in k.elts)
        ):
            routes = None
            break
        routes.append([_const_str(k.elts[0]), _const_str(k.elts[1])])
    if routes:
        for method, path in routes:
            facts["http_handles"].append([method, path, node.lineno])
        return
    statuses = []
    for k, v in zip(node.keys, node.values):
        if not (
            isinstance(k, ast.Constant)
            and type(k.value) is int
            and _const_str(v) is not None
        ):
            return
        statuses.append(k.value)
    if len(statuses) >= 2:
        for code in statuses:
            facts["http_status"].append([code, node.lineno])


def extract_protocol_facts(tree) -> dict:
    """One module's wire-protocol evidence, serializable."""
    facts: dict = {
        "sends": [], "handles": [], "err_emit": [], "err_read": [],
        "emits": [], "reads": [], "req_fields": [],
        "http_sends": [], "http_handles": [], "http_status": [],
        "http_minted": [],
    }
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {}
            for k, v in zip(node.keys, node.values):
                ks = _const_str(k) if k is not None else None
                if ks is not None:
                    keys[ks] = v
            if keys:
                _classify_dict(keys, node.lineno, facts)
            else:
                _classify_http_tables(node, facts)
        elif isinstance(node, ast.Constant):
            # request-line heads live in str, bytes, and f-string
            # constants (ast.walk reaches an f-string's Constant
            # pieces on its own)
            if isinstance(node.value, bytes):
                _scan_http_sends(
                    node.value.decode("utf-8", "replace"),
                    node.lineno, facts,
                )
            # raw JSON request lines ('{"op": "stats"}' written straight
            # onto a LineConn) carry protocol too
            s = node.value if isinstance(node.value, str) else None
            if s:
                _scan_http_sends(s, node.lineno, facts)
            if (
                s
                and s.lstrip().startswith("{")
                and ('"op"' in s or '"content"' in s)
            ):
                try:
                    row = json.loads(s)
                except ValueError:
                    row = None
                if isinstance(row, dict):
                    keys = {
                        k: ast.Constant(value=v)
                        for k, v in row.items()
                        if isinstance(k, str)
                        and isinstance(v, (str, int, float, bool))
                    }
                    if keys:
                        _classify_dict(keys, node.lineno, facts)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Subscript):
                    key = _const_str(target.slice)
                    if key in schema.RESPONSE_FIELDS:
                        facts["emits"].append([key, target.lineno])
                        if key == "error":
                            code = _error_code(node.value)
                            if code is not None:
                                facts["err_emit"].append(
                                    [code, target.lineno]
                                )
        elif isinstance(node, ast.Call):
            key = _get_key(node)
            if key in schema.WATCHED_KEYS:
                facts["reads"].append([key, node.lineno])
            # status mints: any *respond*(...) call whose positional
            # args carry a literal HTTP status (the edge's one answer
            # primitive — _EdgeSession._respond)
            fn = node.func
            fn_name = (
                fn.attr if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else ""
            )
            if "respond" in fn_name:
                for arg in node.args:
                    if (
                        isinstance(arg, ast.Constant)
                        and type(arg.value) is int
                        and 100 <= arg.value <= 599
                    ):
                        facts["http_minted"].append(
                            [arg.value, node.lineno]
                        )
                        break
        elif isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Load
        ):
            key = _get_key(node)
            if key in schema.WATCHED_KEYS:
                facts["reads"].append([key, node.lineno])
        elif isinstance(node, ast.Compare):
            _scan_compare(node, facts)
    return facts


def _scan_compare(node: ast.Compare, facts: dict) -> None:
    sides = [node.left, *node.comparators]
    # "field" in row
    if len(sides) == 2 and isinstance(node.ops[0], (ast.In, ast.NotIn)):
        key = _const_str(sides[0])
        if key in schema.WATCHED_KEYS:
            facts["reads"].append([key, node.lineno])
    if not all(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
        # `op in ("stats", "trace")` — a tuple of handled ops
        if (
            len(sides) == 2
            and isinstance(node.ops[0], (ast.In, ast.NotIn))
            and _is_op_expr(sides[0])
            and isinstance(sides[1], (ast.Tuple, ast.List, ast.Set))
        ):
            for el in sides[1].elts:
                v = _const_str(el)
                if v is not None:
                    facts["handles"].append([v, node.lineno])
        return
    for a, b in zip(sides, sides[1:]):
        for lhs, rhs in ((a, b), (b, a)):
            v = _const_str(rhs)
            if v is None:
                continue
            if _is_op_expr(lhs):
                facts["handles"].append([v, node.lineno])
            elif _get_key(lhs) == "error" and _CODE_RE.match(v or ""):
                facts["err_read"].append([v, node.lineno])


# -- the program rules -------------------------------------------------


def _surfaces(program):
    out = []
    for s in program.by_rel.values():
        if (
            program.force_all
            or _basename(s.rel) in schema.SURFACE_BASENAMES
        ):
            if s.protocol:
                out.append(s)
    return out


def _handled_ops(summary) -> dict[str, int]:
    """op -> first handling line for one module, content included:
    a surface handles content rows when it reads the content body or
    emits classification rows."""
    out: dict[str, int] = {}
    for op, line in summary.protocol.get("handles", ()):
        out.setdefault(op, line)
    content_line = None
    for key, line in summary.protocol.get("reads", ()):
        if key in ("content", "content_b64"):
            content_line = line if content_line is None else content_line
    if content_line is None:
        for key, line in summary.protocol.get("emits", ()):
            if key in ("matcher", "key"):
                content_line = line
                break
    if content_line is not None and out:
        # only a module that dispatches ops at all is a handler; a pure
        # client also reads "content" from its own requests
        out.setdefault("content", content_line)
    return out


def protocol_inventory(program) -> dict:
    """Every wire op with evidence in the program: request verbs plus
    error codes, each with where-sent/where-handled — the enumeration
    the acceptance gate (and curious operators) read."""
    ops: dict[str, dict] = {}
    for s in _surfaces(program):
        for op, line in s.protocol.get("sends", ()):
            ops.setdefault(op, {"sent": [], "handled": []})["sent"].append(
                f"{s.rel}:{line}"
            )
        for op, line in _handled_ops(s).items():
            ops.setdefault(op, {"sent": [], "handled": []})[
                "handled"
            ].append(f"{s.rel}:{line}")
        for code, line in s.protocol.get("err_emit", ()):
            ops.setdefault(code, {"sent": [], "handled": []})[
                "sent"
            ].append(f"{s.rel}:{line}")
        for code, line in s.protocol.get("err_read", ()):
            ops.setdefault(code, {"sent": [], "handled": []})[
                "handled"
            ].append(f"{s.rel}:{line}")
    return ops


@program_rule(
    "protocol-drift",
    doc=(
        "The JSONL wire protocol drifted: an op sent that nothing "
        "handles, an op handled that nothing sends, an op/error-code/"
        "request-field missing from protocol_schema.py, a response "
        "field read that no producer emits, or a schema entry with no "
        "remaining evidence in code"
    ),
)
def check_protocol_drift(program):
    if not program.complete:
        return []
    surfaces = _surfaces(program)
    if not surfaces:
        return []
    findings: list[Finding] = []

    sent: dict[str, list] = {}
    handled: dict[str, list] = {}
    err_emit: dict[str, list] = {}
    err_read: dict[str, list] = {}
    emits: set[str] = set()
    for s in surfaces:
        for op, line in s.protocol.get("sends", ()):
            sent.setdefault(op, []).append((s, line))
        for op, line in _handled_ops(s).items():
            handled.setdefault(op, []).append((s, line))
        for code, line in s.protocol.get("err_emit", ()):
            err_emit.setdefault(code, []).append((s, line))
        for code, line in s.protocol.get("err_read", ()):
            err_read.setdefault(code, []).append((s, line))
        for field, _line in s.protocol.get("emits", ()):
            emits.add(field)

    def per_module_first(sites):
        seen_mod: dict[str, tuple] = {}
        for s, line in sites:
            prev = seen_mod.get(s.rel)
            if prev is None or line < prev[1]:
                seen_mod[s.rel] = (s, line)
        return [seen_mod[rel] for rel in sorted(seen_mod)]

    # ops vs schema, both directions
    for op, sites in sorted(sent.items()):
        if op not in schema.REQUEST_OPS:
            for s, line in per_module_first(sites):
                findings.append(Finding(
                    s.rel, line, "protocol-drift",
                    f"request op {op!r} is sent here but not declared "
                    "in protocol_schema.REQUEST_OPS — wire drift is a "
                    "two-place change",
                ))
        elif op not in handled:
            s, line = per_module_first(sites)[0]
            findings.append(Finding(
                s.rel, line, "protocol-drift",
                f"request op {op!r} is sent here but NO surface "
                "handles it — the request would answer "
                "bad_request everywhere",
            ))
    for op, sites in sorted(handled.items()):
        if op not in schema.REQUEST_OPS:
            for s, line in per_module_first(sites):
                findings.append(Finding(
                    s.rel, line, "protocol-drift",
                    f"op {op!r} is handled here but not declared in "
                    "protocol_schema.REQUEST_OPS",
                ))
        elif op not in sent:
            for s, line in per_module_first(sites):
                findings.append(Finding(
                    s.rel, line, "protocol-drift",
                    f"op {op!r} is handled here but nothing in the "
                    "program sends it — a dead verb (or its sender "
                    "silently drifted)",
                ))

    # error codes
    for code, sites in sorted(err_emit.items()):
        if code not in schema.ERROR_CODES:
            for s, line in per_module_first(sites):
                findings.append(Finding(
                    s.rel, line, "protocol-drift",
                    f"error code {code!r} is emitted here but not "
                    "declared in protocol_schema.ERROR_CODES",
                ))
    for code, sites in sorted(err_read.items()):
        if code not in schema.ERROR_CODES:
            for s, line in per_module_first(sites):
                findings.append(Finding(
                    s.rel, line, "protocol-drift",
                    f"error code {code!r} is matched here but not "
                    "declared in protocol_schema.ERROR_CODES",
                ))
        elif code not in err_emit:
            for s, line in per_module_first(sites):
                findings.append(Finding(
                    s.rel, line, "protocol-drift",
                    f"error code {code!r} is matched here but no "
                    "producer emits it — this branch is dead (or the "
                    "producer renamed the code)",
                ))

    # response fields clients read that nobody produces
    for s in surfaces:
        reported: set[str] = set()
        for field, line in s.protocol.get("reads", ()):
            if (
                field in schema.RESPONSE_FIELDS
                and field not in emits
                and field not in reported
            ):
                reported.add(field)
                findings.append(Finding(
                    s.rel, line, "protocol-drift",
                    f"response field {field!r} is read here but no "
                    "producer in the program emits it",
                ))

    # request fields vs schema
    for s in surfaces:
        reported = set()
        for op, field, line in s.protocol.get("req_fields", ()):
            allowed = schema.REQUEST_OPS.get(op)
            if allowed is None or field in allowed:
                continue
            if (op, field) in reported:
                continue
            reported.add((op, field))
            findings.append(Finding(
                s.rel, line, "protocol-drift",
                f"request field {field!r} is sent with op {op!r} but "
                "protocol_schema.REQUEST_OPS does not declare it",
            ))

    # the declared-but-dead direction, anchored at the schema module
    schema_rel = None
    for rel in program.by_rel:
        if rel.replace("\\", "/").endswith("analysis/protocol_schema.py"):
            schema_rel = rel
            break
    if schema_rel is not None:
        for op in schema.REQUEST_OPS:
            if op not in sent and op not in handled:
                findings.append(Finding(
                    schema_rel, 1, "protocol-drift",
                    f"schema declares op {op!r} but no surface sends "
                    "or handles it — delete it from REQUEST_OPS",
                ))
        for code in schema.ERROR_CODES:
            if code not in err_emit:
                findings.append(Finding(
                    schema_rel, 1, "protocol-drift",
                    f"schema declares error code {code!r} but nothing "
                    "emits it — delete it from ERROR_CODES",
                ))
    return findings


@program_rule(
    "protocol-stub-divergence",
    doc=(
        "The protocol-faithful stub worker (fleet/faults.py) and the "
        "real serve worker (serve/server.py) disagree on the handled "
        "op set — the fault drills would exercise a different protocol "
        "than production speaks"
    ),
)
def check_stub_divergence(program):
    if not program.complete:
        return []
    workers = []
    stubs = []
    for s in program.by_rel.values():
        base = _basename(s.rel)
        if base in schema.WORKER_BASENAMES and s.protocol:
            workers.append(s)
        elif base in schema.STUB_BASENAMES and s.protocol:
            stubs.append(s)
    if not workers or not stubs:
        return []
    worker_ops: dict[str, str] = {}
    for s in workers:
        for op in _handled_ops(s):
            worker_ops.setdefault(op, s.rel)
    findings = []
    for stub in stubs:
        stub_ops = _handled_ops(stub)
        anchor = min(stub_ops.values()) if stub_ops else 1
        for op in sorted(set(worker_ops) - set(stub_ops)):
            findings.append(Finding(
                stub.rel, anchor, "protocol-stub-divergence",
                f"op {op!r} is handled by the real worker "
                f"({worker_ops[op]}) but dropped from this stub — the "
                "fault drills no longer cover it",
            ))
        for op in sorted(set(stub_ops) - set(worker_ops)):
            findings.append(Finding(
                stub.rel, stub_ops[op], "protocol-stub-divergence",
                f"this stub handles op {op!r} which the real worker "
                "does not — stub-only protocol is untested fiction",
            ))
    return findings


@program_rule(
    "protocol-http-drift",
    doc=(
        "The HTTP edge surface drifted: a request line sent that no "
        "edge route serves, an edge ROUTES/STATUS_TEXT entry absent "
        "from protocol_schema.HTTP_ROUTES/HTTP_STATUS_CODES (or the "
        "reverse — a declared route/status the edge no longer "
        "carries), or a minted status code outside the declared set"
    ),
)
def check_http_drift(program):
    if not program.complete:
        return []
    surfaces = _surfaces(program)
    edges = [
        s for s in surfaces
        if _basename(s.rel) in schema.EDGE_BASENAMES
    ]
    findings: list[Finding] = []

    handled: dict[tuple[str, str], tuple] = {}
    statuses: dict[int, tuple] = {}
    minted: dict[int, tuple] = {}
    for s in edges:
        for method, path, line in s.protocol.get("http_handles", ()):
            handled.setdefault((method, path), (s, line))
        for code, line in s.protocol.get("http_status", ()):
            statuses.setdefault(code, (s, line))
        for code, line in s.protocol.get("http_minted", ()):
            minted.setdefault(code, (s, line))

    # client-side request lines, anywhere on the surface list
    sent: dict[tuple[str, str], list] = {}
    for s in surfaces:
        for method, path, line in s.protocol.get("http_sends", ()):
            sent.setdefault((method, path), []).append((s, line))

    if not edges and not sent:
        return []  # no HTTP surface in this program

    def per_module_first(sites):
        seen_mod: dict[str, tuple] = {}
        for s, line in sites:
            prev = seen_mod.get(s.rel)
            if prev is None or line < prev[1]:
                seen_mod[s.rel] = (s, line)
        return [seen_mod[rel] for rel in sorted(seen_mod)]

    for route, sites in sorted(sent.items()):
        method, path = route
        if route not in schema.HTTP_ROUTES:
            for s, line in per_module_first(sites):
                findings.append(Finding(
                    s.rel, line, "protocol-http-drift",
                    f"request line {method} {path} is sent here but "
                    "not declared in protocol_schema.HTTP_ROUTES — "
                    "edge drift is a two-place change",
                ))
        elif edges and route not in handled:
            s, line = per_module_first(sites)[0]
            findings.append(Finding(
                s.rel, line, "protocol-http-drift",
                f"request line {method} {path} is sent here but the "
                "edge's ROUTES table does not serve it — the request "
                "would answer 404 everywhere",
            ))

    for route, (s, line) in sorted(handled.items()):
        if route not in schema.HTTP_ROUTES:
            method, path = route
            findings.append(Finding(
                s.rel, line, "protocol-http-drift",
                f"edge route {method} {path} is served here but not "
                "declared in protocol_schema.HTTP_ROUTES",
            ))
    if handled:
        anchor_s, anchor_line = next(iter(handled.values()))
        for route in schema.HTTP_ROUTES:
            if route not in handled:
                method, path = route
                findings.append(Finding(
                    anchor_s.rel, anchor_line, "protocol-http-drift",
                    f"protocol_schema.HTTP_ROUTES declares "
                    f"{method} {path} but this edge's ROUTES table "
                    "does not serve it",
                ))

    for code, (s, line) in sorted(statuses.items()):
        if code not in schema.HTTP_STATUS_CODES:
            findings.append(Finding(
                s.rel, line, "protocol-http-drift",
                f"status {code} is declared in the edge's STATUS "
                "table but not in protocol_schema.HTTP_STATUS_CODES",
            ))
    if statuses:
        anchor_s, anchor_line = next(iter(statuses.values()))
        for code in schema.HTTP_STATUS_CODES:
            if code not in statuses:
                findings.append(Finding(
                    anchor_s.rel, anchor_line, "protocol-http-drift",
                    f"protocol_schema.HTTP_STATUS_CODES declares "
                    f"{code} but the edge's STATUS table dropped it",
                ))
    # mint sites are the safety net UNDER the table equivalence: a
    # literal ``_respond(..., code, ...)`` outside the declared set is
    # drift even if someone also forgot to add it to STATUS_TEXT (the
    # declared-but-dead direction is the table check above — codes
    # minted through the routing verdict indirection still appear in
    # the table, which runtime lookup enforces)
    for code, (s, line) in sorted(minted.items()):
        if code not in schema.HTTP_STATUS_CODES:
            findings.append(Finding(
                s.rel, line, "protocol-http-drift",
                f"status {code} is minted here but not declared in "
                "protocol_schema.HTTP_STATUS_CODES",
            ))
    return findings
