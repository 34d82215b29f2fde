"""Resource-leak rules: sockets, ``Popen`` handles, and file objects
must be released on every path — including when ownership crosses a
module boundary through a returned value.

A resource-creating call is clean when any of these hold:

* it is the context expression of a ``with`` statement;
* its result is assigned to a local that is closed inside a
  ``finally`` block (``try: ... finally: x.close()``);
* its result ESCAPES the creating function — returned, yielded, stored
  on ``self``/an attribute/a container, or passed to another call —
  ownership moved, the creator is not the leak site.

Everything else is a finding: a bare ``open(p)`` expression, the
``open(p).read()`` temporary (closed only when the GC gets around to
it — on a week-long worker that is a descriptor leak), a local that is
never closed, and a local closed only on the happy path (the
stale-socket and SIGKILL-restart bugs of the fleet tier were exactly
this class).

The per-file rule stops at the function that CREATED the resource.
The whole-program extension follows the "returned" escape to its
callers: a module-level function whose return value derives from a
resource factory (directly, or through another returning function) is
itself a factory, and every cross-module caller is held to the same
with/finally/escape discipline at its call site.  The per-call
syntactic classification (``function_call_facts``) is shared between
both passes and exported into the module summary, so the program rule
runs from cache without re-parsing.
"""

from __future__ import annotations

import ast

from licensee_tpu_torch.analysis.core import Finding, program_rule, rule
from licensee_tpu_torch.analysis.scopes import module_imports

RESOURCE_FACTORIES = {
    "open": "file handle",
    "io.open": "file handle",
    "os.fdopen": "file handle",
    "gzip.open": "file handle",
    "bz2.open": "file handle",
    "lzma.open": "file handle",
    "tarfile.open": "archive handle",
    "zipfile.ZipFile": "archive handle",
    "socket.socket": "socket",
    "socket.create_connection": "socket",
    "subprocess.Popen": "child process handle",
    # remote ingest (ingest/remote.py) dials these; a pooled
    # keep-alive connection that escapes its release/discard path is a
    # leaked socket just the same
    "http.client.HTTPConnection": "http connection",
    "http.client.HTTPSConnection": "http connection",
}

CLOSE_METHODS = {
    "close", "server_close", "terminate", "kill", "wait", "communicate",
    "shutdown", "release", "unlink", "cleanup", "__exit__",
}

# call-site dispositions that leak when the callee hands back a live
# resource, with the message tail explaining each
LEAKY_DISPOSITIONS = {
    "bare": (
        "its result is never bound — the {kind} closes only when the "
        "GC collects the temporary; use `with`"
    ),
    "unclosed": (
        "'{name}' is never closed in this function and never handed "
        "off; use `with` or `try/finally`"
    ),
    "happy": (
        "'{name}' is closed only on the happy path — an exception "
        "between here and the close leaks it; use `with` or "
        "`try/finally`"
    ),
}


def _walk_body(fn_node):
    """Every node under the function's statements — works for both real
    FunctionDefs and the module-level pseudo-function."""
    for stmt in getattr(fn_node, "body", []):
        yield from ast.walk(stmt)


def _finally_closes(fn_node, name: str) -> bool:
    for node in _walk_body(fn_node):
        if not isinstance(node, ast.Try):
            continue
        for stmt in node.finalbody:
            for sub in ast.walk(stmt):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in CLOSE_METHODS
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id == name
                ):
                    return True
    return False


def _escapes(fn_node, name: str, creation: ast.Call) -> bool:
    """Ownership leaves the function: returned/yielded, stored into an
    attribute/subscript/container, re-aliased, or passed as a call
    argument (the callee or the structure owns the close)."""
    for node in _walk_body(fn_node):
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            val = node.value
            if val is not None and _bare_mentions(val, name):
                return True
        elif isinstance(node, ast.Assign):
            if node.value is creation:
                continue  # the tracked binding itself
            if _bare_mentions(node.value, name):
                return True  # aliased or stored into a structure
        elif isinstance(node, ast.Call):
            for arg in [*node.args, *[kw.value for kw in node.keywords]]:
                if isinstance(arg, ast.Name) and arg.id == name:
                    # x.close()/x.read() is a method ON x, not a hand-off
                    return True
    return False


def _bare_mentions(node, name: str) -> bool:
    """``name`` used as a VALUE (returned, put in a tuple, aliased) —
    not merely as the receiver of a method/attribute access: ``return
    sock.recv(1)`` uses sock, ``return sock`` hands it off."""
    receivers = {
        id(n.value)
        for n in ast.walk(node)
        if isinstance(n, ast.Attribute)
        and isinstance(n.value, ast.Name)
        and n.value.id == name
    }
    return any(
        isinstance(n, ast.Name) and n.id == name and id(n) not in receivers
        for n in ast.walk(node)
    )


def _with_context_names(fn_node) -> set[str]:
    names = set()
    for node in _walk_body(fn_node):
        if isinstance(node, ast.With):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Name):
                    names.add(ctx.id)
    return names


class _FakeModuleFn:
    """Module-level statements analyzed as one pseudo-function."""

    col_offset = 0

    def __init__(self, tree):
        self.body = [
            n
            for n in tree.body
            if not isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            )
        ]


def iter_function_nodes(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
    yield _FakeModuleFn(tree)


def _calls_in(fn_node):
    """Every Call lexically in this function, nested defs excluded
    (they are visited as their own functions)."""
    out = []

    def visit(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.Call):
            out.append(node)
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in getattr(fn_node, "body", []):
        visit(stmt)
    return out


def function_call_facts(fn_node) -> dict:
    """{call_node: (bound_name | None, disposition)} for every call in
    the function.  Dispositions: ``with`` / ``consumed`` (handed off,
    returned, or stored) / ``ctxlater`` (entered via ``with name``) /
    ``finally`` / ``escape`` / ``happy`` (closed on the happy path
    only) / ``unclosed`` / ``bare`` (never bound)."""
    with_items = set()
    assigned_to: dict[int, str] = {}  # id(call) -> local name
    consumed: set[int] = set()
    for stmt in getattr(fn_node, "body", []):
        for node in ast.walk(stmt):
            if isinstance(node, ast.With):
                for item in node.items:
                    if isinstance(item.context_expr, ast.Call):
                        with_items.add(id(item.context_expr))
            elif isinstance(node, ast.Assign):
                if isinstance(node.value, ast.Call) and len(
                    node.targets
                ) == 1:
                    target = node.targets[0]
                    if isinstance(target, ast.Name):
                        assigned_to[id(node.value)] = target.id
                    elif isinstance(
                        target, (ast.Attribute, ast.Subscript)
                    ):
                        consumed.add(id(node.value))  # escapes
            elif isinstance(node, ast.Call):
                for arg in [
                    *node.args, *[kw.value for kw in node.keywords]
                ]:
                    if isinstance(arg, ast.Call):
                        consumed.add(id(arg))  # hand-off to callee
            elif isinstance(node, (ast.Return, ast.Yield)):
                if isinstance(node.value, ast.Call):
                    consumed.add(id(node.value))
    ctx_names = _with_context_names(fn_node)
    facts: dict = {}
    for call in _calls_in(fn_node):
        if id(call) in with_items:
            facts[call] = (None, "with")
            continue
        if id(call) in consumed:
            facts[call] = (None, "consumed")
            continue
        name = assigned_to.get(id(call))
        if name is None:
            facts[call] = (None, "bare")
            continue
        if name in ctx_names:
            facts[call] = (name, "ctxlater")
            continue
        if _finally_closes(fn_node, name):
            facts[call] = (name, "finally")
            continue
        if _escapes(fn_node, name, call):
            facts[call] = (name, "escape")
            continue
        closes_somewhere = any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in CLOSE_METHODS
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == name
            for n in _walk_body(fn_node)
        )
        facts[call] = (name, "happy" if closes_somewhere else "unclosed")
    return facts


def returns_facts(fn_node, imports) -> tuple[str | None, set[str]]:
    """What a function hands back: a resource kind when it returns a
    factory's result (directly or through a local), plus the qualified
    names of other calls whose results it returns — the propagation
    edges of the cross-module ownership fixed point."""
    bindings: dict[str, str] = {}  # local name -> qualified call name
    for node in _walk_body(fn_node):
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            qn = imports.qualify(node.value.func)
            if qn is not None:
                bindings[node.targets[0].id] = qn
    kind = None
    ret_calls: set[str] = set()
    for node in _walk_body(fn_node):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        val = node.value
        qn = None
        if isinstance(val, ast.Call):
            qn = imports.qualify(val.func)
        elif isinstance(val, ast.Name):
            qn = bindings.get(val.id)
        if qn is None:
            continue
        if qn in RESOURCE_FACTORIES:
            kind = RESOURCE_FACTORIES[qn]
        elif not qn.startswith("self."):
            ret_calls.add(qn)
    return kind, ret_calls


@rule(
    "resource-leak",
    doc=(
        "A socket/Popen/file handle is created without `with` and "
        "without a close guaranteed by `finally` (or an ownership "
        "hand-off)"
    ),
)
def check_resource_leak(module):
    imports = module_imports(module)
    findings = []
    for fn_node in iter_function_nodes(module.tree):
        for call, (name, disp) in function_call_facts(fn_node).items():
            qn = imports.qualify(call.func)
            if qn not in RESOURCE_FACTORIES:
                continue
            kind = RESOURCE_FACTORIES[qn]
            if disp == "bare":
                findings.append(
                    module.finding(
                        "resource-leak",
                        call.lineno,
                        f"{kind} created and never bound — it is closed "
                        "only when the GC collects the temporary; use "
                        "`with`",
                    )
                )
            elif disp == "happy":
                findings.append(
                    module.finding(
                        "resource-leak",
                        call.lineno,
                        f"{kind} '{name}' is closed only on the happy "
                        "path — an exception between here and the close "
                        "leaks it; use `with` or `try/finally`",
                    )
                )
            elif disp == "unclosed":
                findings.append(
                    module.finding(
                        "resource-leak",
                        call.lineno,
                        f"{kind} '{name}' is never closed in this "
                        "function and never handed off; use `with`",
                    )
                )
    return findings


# -- the cross-module ownership pass -----------------------------------


def _resolve_fn(program, summary, ref):
    """A call reference (qualified dotted name, or a bare local name)
    -> the (rel, function name) key of a module-level function."""
    if "." in ref:
        for rel, sid in program.resolve(ref):
            sc = program.by_rel[rel].scopes[sid]
            if sc.owner is None:
                return (rel, sc.name)
        return None
    for sc in summary.scopes:
        if sc.owner is None and sc.name == ref:
            return (summary.rel, ref)
    return None


@program_rule(
    "resource-leak",
    doc=(
        "(whole-program) a function returns a live socket/file/Popen "
        "handle — ownership crossed the module boundary — and a caller "
        "neither closes it on all paths nor hands it on"
    ),
)
def check_cross_module_ownership(program):
    # fixed point: functions returning a factory's result, directly or
    # through other returning functions
    factories: dict[tuple[str, str], str] = {}
    for s in program.by_rel.values():
        for fname, info in s.ret_facts.items():
            if info.get("kind"):
                factories[(s.rel, fname)] = info["kind"]
    changed = True
    while changed:
        changed = False
        for s in program.by_rel.values():
            for fname, info in s.ret_facts.items():
                key = (s.rel, fname)
                if key in factories:
                    continue
                for ref in info.get("calls", ()):
                    target = _resolve_fn(program, s, ref)
                    if target is not None and target in factories:
                        factories[key] = factories[target]
                        changed = True
                        break
    if not factories:
        return []
    findings = []
    for s in program.by_rel.values():
        for q, line, disp, bound in s.pcalls:
            tail = LEAKY_DISPOSITIONS.get(disp)
            if tail is None:
                continue
            target = _resolve_fn(program, s, q)
            if target is None or target not in factories:
                continue
            kind = factories[target]
            callee = q.split(".")[-1]
            findings.append(Finding(
                s.rel, line, "resource-leak",
                f"{callee}() (defined in {target[0]}) returns a live "
                f"{kind}, and "
                + tail.format(kind=kind, name=bound or callee),
            ))
    return findings
