"""Tracer-purity rule: functions handed to ``jax.jit``/``vmap``/
``pmap``/``shard_map`` must be pure traces.

Two failure classes:

* **host-side effects** — a call to ``time.*``, stdlib ``random.*``,
  ``print``, ``os.*``, ``open``, ``numpy.random.*``, ``input`` inside
  a jitted function runs ONCE at trace time and never again: the
  compiled kernel silently bakes in the first call's value (or worse,
  the effect disappears entirely on cache hits).  ``jax.random`` is
  functional and exempt.
* **branching on a tracer** — ``if``/``while`` over a traced argument
  raises ``TracerBoolConversionError`` at best and silently
  specializes at worst; shape/dtype/ndim reads are static and exempt,
  as are ``static_argnums``/``static_argnames`` parameters.

Jitted functions are found syntactically: ``@jax.jit``-style
decorators (``functools.partial(jax.jit, ...)`` included) and local
defs passed to ``jax.jit(f)`` / ``jax.vmap(f)`` / ``jax.pmap(f)`` /
``shard_map(f, ...)``.
"""

from __future__ import annotations

import ast

from licensee_tpu_torch.analysis.core import rule
from licensee_tpu_torch.analysis.rules_concurrency import _imports

JIT_WRAPPERS = {
    "jax.jit", "jax.vmap", "jax.pmap", "jax.named_call",
    "jax.experimental.shard_map.shard_map", "shard_map", "jit", "vmap",
    "pmap",
}

IMPURE_PREFIXES = {
    "time.": "reads the host clock at trace time",
    "random.": "draws host randomness at trace time (use jax.random)",
    "os.": "performs a host OS call at trace time",
    "numpy.random.": "draws host randomness at trace time",
    "subprocess.": "spawns a process at trace time",
}
IMPURE_EXACT = {
    "print": "prints at trace time only (use jax.debug.print)",
    "open": "opens a file at trace time",
    "input": "blocks on stdin at trace time",
}
# attributes whose value is static under tracing: reading them off a
# tracer does not taint the expression
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "aval", "sharding"}


def _is_wrapper_name(qn: str | None) -> bool:
    if qn is None:
        return False
    return qn in JIT_WRAPPERS or qn.split(".")[-1] in (
        "jit", "vmap", "pmap", "shard_map"
    )


def _qualifies_as_jit(imports, node) -> bool:
    """Is this decorator/callable expression a jit-family wrapper?
    Handles ``jax.jit``, ``functools.partial(jax.jit, ...)``, and the
    called-decorator form ``jax.jit(...)`` / ``partial(jax.jit, ...)``."""
    if not isinstance(node, ast.Call):
        return _is_wrapper_name(imports.qualify(node))
    fn_qn = imports.qualify(node.func)
    if _is_wrapper_name(fn_qn):
        return True
    if fn_qn in ("functools.partial", "partial") and node.args:
        return _qualifies_as_jit(imports, node.args[0])
    return False


def _static_names(imports, decorator, fn_node) -> set[str]:
    """Parameter names excluded from tracing by static_argnames/nums."""
    call = None
    if isinstance(decorator, ast.Call):
        call = decorator
        if imports.qualify(call.func) in ("functools.partial", "partial"):
            pass  # kwargs live on the partial call itself
    if call is None:
        return set()
    names: set[str] = set()
    params = [a.arg for a in (
        *fn_node.args.posonlyargs, *fn_node.args.args,
        *fn_node.args.kwonlyargs,
    )]
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            for el in ast.walk(kw.value):
                if isinstance(el, ast.Constant) and isinstance(
                    el.value, str
                ):
                    names.add(el.value)
        elif kw.arg == "static_argnums":
            for el in ast.walk(kw.value):
                if isinstance(el, ast.Constant) and isinstance(
                    el.value, int
                ) and 0 <= el.value < len(params):
                    names.add(params[el.value])
    return names


def _jitted_functions(module, imports):
    """(fn_node, static_param_names) for every syntactically-jitted
    def in the module."""
    out = []
    defs_by_name: dict[str, ast.FunctionDef] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, node)
            for deco in node.decorator_list:
                if _qualifies_as_jit(imports, deco):
                    out.append((node, _static_names(imports, deco, node)))
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        qn = imports.qualify(node.func)
        if not _is_wrapper_name(qn):
            continue
        if node.args and isinstance(node.args[0], ast.Name):
            fn = defs_by_name.get(node.args[0].id)
            if fn is not None and all(f is not fn for f, _ in out):
                out.append((fn, _static_names(imports, node, fn)))
    return out


def _shielded(node) -> ast.AST | None:
    """Return the subtree to SKIP when taint-scanning: a static
    attribute read (x.shape...) shields its whole base."""
    if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
        return node
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and (
        node.func.id in ("len", "isinstance", "type", "getattr")
    ):
        return node
    return None


def _tainted_names(expr, tainted: set[str]) -> set[str]:
    """Tainted names referenced in ``expr`` outside shielded subtrees."""
    hits: set[str] = set()

    def visit(node):
        if _shielded(node) is not None:
            return
        if isinstance(node, ast.Name) and node.id in tainted:
            hits.add(node.id)
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(expr)
    return hits


def _source_order(node):
    """Pre-order DFS — statements arrive in SOURCE order, so a taint
    assignment nested inside an earlier block is processed before a
    later same-level branch reads it (ast.walk is BFS and is not)."""
    for child in ast.iter_child_nodes(node):
        yield child
        yield from _source_order(child)


@rule(
    "tracer-purity",
    doc=(
        "A jit/vmap-wrapped function calls host-side effects or "
        "branches on a traced value"
    ),
)
def check_tracer_purity(module):
    imports = _imports(module)
    findings = []
    seen: set[tuple[int, str]] = set()
    for fn_node, static in _jitted_functions(module, imports):
        params = {
            a.arg
            for a in (
                *fn_node.args.posonlyargs, *fn_node.args.args,
                *fn_node.args.kwonlyargs,
            )
        } - static
        tainted = set(params)
        for node in _source_order(fn_node):
            if isinstance(node, ast.Call):
                qn = imports.qualify(node.func)
                why = None
                if qn in IMPURE_EXACT:
                    why = IMPURE_EXACT[qn]
                elif qn is not None:
                    for prefix, reason in IMPURE_PREFIXES.items():
                        if qn.startswith(prefix):
                            why = reason
                            break
                if why is not None:
                    key = (node.lineno, "call")
                    if key not in seen:
                        seen.add(key)
                        findings.append(
                            module.finding(
                                "tracer-purity",
                                node.lineno,
                                f"jitted '{fn_node.name}' calls {qn}() "
                                f"which {why}",
                            )
                        )
            elif isinstance(node, ast.Assign):
                if _tainted_names(node.value, tainted):
                    for target in node.targets:
                        for n in ast.walk(target):
                            if isinstance(n, ast.Name):
                                tainted.add(n.id)
            elif isinstance(node, (ast.If, ast.While)):
                hits = _tainted_names(node.test, tainted)
                if hits:
                    key = (node.lineno, "branch")
                    if key not in seen:
                        seen.add(key)
                        findings.append(
                            module.finding(
                                "tracer-purity",
                                node.lineno,
                                f"jitted '{fn_node.name}' branches on "
                                f"traced value(s) {sorted(hits)} — use "
                                "jax.lax.cond/select, or mark the "
                                "argument static",
                            )
                        )
    return findings
