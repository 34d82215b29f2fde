"""The ``event-ring-purity`` rule: the flight recorder's hot append
path (obs/flight.py) must stay lock-free and I/O-free.

The whole point of a flight recorder is to be cheap enough to leave on
at full serving rate, and to never perturb the thing it records: one
slot store per event, no lock a stalled flusher could hold, no
filesystem call a full disk could block on.  That property is easy to
erode one "small" edit at a time — a debug ``open()``, a "just to be
safe" lock — so it is a checked invariant, not a docstring.

Scope: classes whose name contains ``Recorder``; the hot path is the
``record`` method (:data:`HOT_METHODS`) plus every same-class helper
it (transitively) calls.  Flagged inside the hot path:

* blocking I/O calls — ``open``, ``os.replace``/``rename``/``fsync``/
  ``fdatasync``, ``time.sleep``, ``socket.socket``, ``subprocess.*``,
  ``print``;
* write/flush/acquire-shaped method calls (``.write()``, ``.flush()``,
  ``.dump()``, ``.acquire()``, ``.join()``, ``.put()``, ``.get()`` on
  anything — the append path owns no file, queue, or lock to call
  them on);
* ``with``-statement lock acquisition (a context manager over an
  attribute or name containing ``lock``).

The dirs gate scopes the rule to ``licensee_tpu_torch/obs``; fixture
programs exercise it via ``force_all`` like every other rule.
"""

from __future__ import annotations

import ast

from licensee_tpu_torch.analysis.core import rule
from licensee_tpu_torch.analysis.rules_concurrency import _imports

EVENT_RING_DIRS = ("licensee_tpu_torch/obs",)

# the hot append entry points on a *Recorder class
HOT_METHODS = ("record",)

# fully-qualified blocking primitives (after import-alias resolution)
BLOCKING_QNAMES = {
    "open", "builtins.open", "print", "builtins.print",
    "time.sleep",
    "os.replace", "os.rename", "os.fsync", "os.fdatasync",
    "os.open", "os.write",
    "socket.socket", "socket.create_connection",
    "json.dump",
}
BLOCKING_QNAME_PREFIXES = ("subprocess.",)

# attribute-call names that mean "this path touched a file, socket,
# or lock" — none of which the hot append owns.  Deliberately narrow
# (no `.get`/`.join`: dict reads and str.join are pure) so the rule
# never cries wolf on honest formatting.
BLOCKING_ATTRS = {
    "write", "flush", "dump", "acquire", "sendall", "recv",
    "replace", "fsync",
}


def _is_lockish(node) -> bool:
    """A with-item context expression that names a lock (``self._lock``,
    ``lock``, ``self.cond`` does not count — only lock-named things)."""
    if isinstance(node, ast.Call):
        return _is_lockish(node.func)
    if isinstance(node, ast.Attribute):
        return "lock" in node.attr.lower()
    if isinstance(node, ast.Name):
        return "lock" in node.id.lower()
    return False


def _class_methods(cls: ast.ClassDef) -> dict[str, ast.FunctionDef]:
    return {
        node.name: node
        for node in cls.body
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _hot_closure(cls: ast.ClassDef) -> dict[str, ast.FunctionDef]:
    """The hot methods plus every same-class ``self.helper()`` they
    transitively reach — a blocking call cannot hide one hop away."""
    methods = _class_methods(cls)
    worklist = [m for m in HOT_METHODS if m in methods]
    hot: dict[str, ast.FunctionDef] = {}
    while worklist:
        name = worklist.pop()
        if name in hot:
            continue
        hot[name] = methods[name]
        for node in ast.walk(methods[name]):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"
                and node.func.attr in methods
            ):
                worklist.append(node.func.attr)
    return hot


@rule(
    "event-ring-purity",
    dirs=EVENT_RING_DIRS,
    doc=(
        "Blocking I/O or lock acquisition inside a flight recorder's "
        "hot append path (the `record` method of a *Recorder class and "
        "its same-class helpers) — the event ring must never perturb "
        "the serving path it records"
    ),
)
def check_event_ring_purity(module):
    imports = _imports(module)
    findings = []
    for cls in ast.walk(module.tree):
        if not (
            isinstance(cls, ast.ClassDef) and "Recorder" in cls.name
        ):
            continue
        for mname, method in sorted(_hot_closure(cls).items()):
            where = (
                f"{cls.name}.{mname}"
                if mname in HOT_METHODS
                else f"{cls.name}.{mname} (reached from the hot append)"
            )
            for node in ast.walk(method):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if _is_lockish(item.context_expr):
                            findings.append(module.finding(
                                "event-ring-purity",
                                node.lineno,
                                f"lock acquisition in {where} — the "
                                "hot append path is lock-free by "
                                "contract (a stalled flusher holding "
                                "this lock would block every event)",
                            ))
                if not isinstance(node, ast.Call):
                    continue
                qn = imports.qualify(node.func) or ""
                blocking = qn in BLOCKING_QNAMES or qn.startswith(
                    BLOCKING_QNAME_PREFIXES
                )
                attr_blocking = (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in BLOCKING_ATTRS
                )
                if blocking or attr_blocking:
                    what = qn if blocking else f".{node.func.attr}()"
                    findings.append(module.finding(
                        "event-ring-purity",
                        node.lineno,
                        f"blocking call {what} in {where} — dumps and "
                        "spills belong on the flusher thread "
                        "(dump()/stop()), never the append path",
                    ))
    return findings
