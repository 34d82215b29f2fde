"""Shared AST infrastructure for the rules: import-alias resolution,
qualified call names, class/method collection with lexical lock depth,
thread-entry detection, and intra-class / intra-module reachability.

Everything here is deliberately syntactic — no imports are executed,
no types inferred.  The contract with the rules is "resolve what a
careful reader resolves": ``from time import sleep as s; s()`` is
``time.sleep``, ``with self._cond:`` guards exactly like the lock it
wraps, and a nested ``def`` handed to ``threading.Thread(target=...)``
is a thread entry point of its enclosing class.
"""

from __future__ import annotations

import ast

# attribute-method calls that mutate their receiver in place — a
# ``self.x.append(...)`` under the lock marks ``x`` guarded exactly
# like ``self.x = ...`` would
MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "remove", "discard", "pop", "popitem", "popleft", "clear", "update",
    "setdefault", "move_to_end", "sort", "reverse",
}

# constructors whose result owns an OS resource (rules_resources)
LOCK_FACTORIES = ("threading.Lock", "threading.RLock", "threading.Condition")


def rel_to_modname(rel: str) -> str:
    """Repo-relative path -> dotted module name: the join key between
    the per-file import tables and the program-wide symbol table
    (``licensee_tpu_torch/fleet/wire.py`` -> ``licensee_tpu_torch.fleet.wire``;
    a package ``__init__.py`` names the package itself)."""
    parts = [p for p in rel.replace("\\", "/").split("/") if p]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][: -len(".py")]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def rel_basename(rel: str) -> str:
    """The final path component of a repo-relative path — the role/
    surface key the protocol and blocking rules match on."""
    return rel.replace("\\", "/").rsplit("/", 1)[-1]


def rel_to_package(rel: str) -> str:
    """The dotted ENCLOSING package of a repo-relative path — the base
    relative imports resolve against (for a package ``__init__.py``
    that is the package itself)."""
    modname = rel_to_modname(rel)
    base = rel.replace("\\", "/").rsplit("/", 1)[-1]
    if base == "__init__.py":
        return modname
    return modname.rsplit(".", 1)[0] if "." in modname else ""


def _canonical_relative(dotted: str, package: str) -> str:
    """Resolve a leading-dot relative import against the importing
    module's enclosing ``package`` (``.wire.oneshot`` inside package
    ``licensee_tpu_torch.fleet`` -> ``licensee_tpu_torch.fleet.wire.oneshot``; each
    extra dot climbs one package).  An over-deep relative import (more
    dots than packages) is left as-is — it would not import either."""
    level = len(dotted) - len(dotted.lstrip("."))
    if level == 0 or not package:
        return dotted
    base = package.split(".")
    climb = level - 1
    if climb >= len(base):
        return dotted
    base = base[: len(base) - climb]
    tail = dotted[level:]
    return ".".join(base + [tail]) if tail else ".".join(base)


class ImportTable:
    """name -> dotted qualified name, from every import in the tree
    (function-local imports included — they bind names the same way).
    When ``package`` is given, relative imports are canonicalized
    against it so cross-module resolution sees absolute names."""

    def __init__(self, tree: ast.AST, package: str = ""):
        self.names: dict[str, str] = {}
        # full dotted names of IMPORTED MODULES (``import a.b`` depends
        # on a.b even though it only binds ``a``) — the import-graph
        # edges behind the --changed reverse closure
        self.modules: set[str] = set()
        self.package = package
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.modules.add(alias.name)
                    if alias.asname:
                        self.names[alias.asname] = alias.name
                    else:
                        # ``import a.b`` binds ``a``; dotted uses
                        # resolve naturally through qualify()
                        root = alias.name.split(".")[0]
                        self.names.setdefault(root, root)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                prefix = "." * node.level + mod
                if prefix.startswith(".") and package:
                    prefix = _canonical_relative(prefix, package)
                if prefix:
                    self.modules.add(prefix)
                for alias in node.names:
                    bound = alias.asname or alias.name
                    if prefix:
                        sep = "" if prefix.endswith(".") else "."
                        value = f"{prefix}{sep}{alias.name}"
                    else:
                        value = alias.name
                    self.names[bound] = value

    def qualify(self, node: ast.AST) -> str | None:
        """Dotted name of a Name/Attribute chain with the first segment
        resolved through the import table; None when the base is not a
        plain name chain (a call result, a subscript)."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.names.get(parts[0], parts[0])
        return ".".join([head, *parts[1:]])


def call_name(imports: ImportTable, call: ast.Call) -> str | None:
    return imports.qualify(call.func)


def is_self_attr(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    )


class AttrAccess:
    """One attribute touch: ``kind`` is "read" or "write", ``lock_depth``
    counts enclosing ``with self.<lock>:`` blocks of the OWNING function
    (a nested ``def`` resets the depth — its body runs later, outside
    the with).  Accesses are recorded for ANY receiver, not just
    ``self``: the supervisor/handle pattern guards WorkerHandle attrs
    under the Supervisor's lock, and receiver-agnostic name matching is
    what lets the lock-discipline rule see that class of race."""

    __slots__ = ("attr", "line", "kind", "lock_depth", "func")

    def __init__(self, attr, line, kind, lock_depth, func):
        self.attr = attr
        self.line = line
        self.kind = kind
        self.lock_depth = lock_depth
        self.func = func


class CallSite:
    """One call expression inside a scope, with everything the
    whole-program graph needs: the attr/bare callee name, the
    import-qualified dotted name when the callee is a plain name chain,
    whether the receiver is ``self`` (class-hierarchy dispatch), the
    line, and the lexical lock depth at the call (the caller-holds-the-
    lock contract rides this)."""

    __slots__ = ("kind", "name", "q", "recv_self", "line", "lock_depth")

    def __init__(self, kind, name, q, recv_self, line, lock_depth):
        self.kind = kind  # "attr" | "name"
        self.name = name
        self.q = q  # canonical dotted name, or None
        self.recv_self = recv_self
        self.line = line
        self.lock_depth = lock_depth


class FunctionScope:
    """One function/method (or nested def): its accesses, the self-call
    and local-call edges out of it, and whether it is handed to a
    thread/executor anywhere."""

    def __init__(self, name: str, node, owner: str | None):
        self.name = name
        self.node = node
        self.owner = owner  # class name, or None at module level
        self.accesses: list[AttrAccess] = []
        self.self_calls: set[str] = set()  # self.m() / obj.m() attr names
        self.name_calls: set[str] = set()  # bare f() names
        self.calls: list[CallSite] = []  # every call, graph-resolution form


class ClassScope:
    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.name = node.name
        self.lock_attrs: set[str] = set()
        self.functions: dict[str, FunctionScope] = {}  # incl. nested defs
        self.guarded: dict[str, int] = {}  # attr -> first guarded-write line


class ModuleScopes:
    """The one-pass visitor every concurrency rule shares."""

    def __init__(self, tree: ast.AST, imports: ImportTable):
        self.imports = imports
        self.classes: list[ClassScope] = []
        self.module_functions: dict[str, FunctionScope] = {}
        # names handed to Thread(target=)/Timer/submit anywhere in the
        # module — matched against method/function names
        self.spawned_names: set[str] = set()
        # spawn targets that qualify to a dotted name (``wire.probe``):
        # the program layer resolves these into OTHER modules
        self.spawned_qualified: set[str] = set()
        self._walk_module(tree)

    # -- collection --

    def _walk_module(self, tree) -> None:
        for node in tree.body if hasattr(tree, "body") else []:
            if isinstance(node, ast.ClassDef):
                self.classes.append(self._walk_class(node))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = FunctionScope(node.name, node, None)
                self.module_functions[node.name] = scope
                self._walk_function(node, scope, None, on_register=(
                    lambda s: self.module_functions.setdefault(s.name, s)
                ))
            else:
                self._scan_spawns(node)

    def _walk_class(self, node: ast.ClassDef) -> ClassScope:
        cls = ClassScope(node)
        # pre-pass: lock attrs must be known before ANY method walks,
        # whatever the source order of __init__ and the lock's users
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and isinstance(
                sub.value, ast.Call
            ):
                qn = self.imports.qualify(sub.value.func)
                if qn in LOCK_FACTORIES:
                    for target in sub.targets:
                        if is_self_attr(target):
                            cls.lock_attrs.add(target.attr)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = FunctionScope(item.name, item, cls.name)
                cls.functions[item.name] = scope
                self._walk_function(item, scope, cls, on_register=(
                    lambda s: cls.functions.setdefault(s.name, s)
                ))
            else:
                self._scan_spawns(item)
        return cls

    def _walk_function(self, fn_node, scope, cls, on_register) -> None:
        """Walk one def: record accesses with lexical lock depth, call
        edges, spawn targets, and lock-attr assignments; recurse into
        nested defs as their own scopes (lock depth resets — a closure
        body does not run under the enclosing with)."""

        def visit(node, depth: int) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested = FunctionScope(node.name, node, scope.owner)
                on_register(nested)
                self._walk_function(node, nested, cls, on_register)
                return
            if isinstance(node, ast.Lambda):
                return  # lambdas run later too; none mutate state here
            if isinstance(node, ast.With):
                d = depth
                for item in node.items:
                    ctx = item.context_expr
                    if (
                        cls is not None
                        and is_self_attr(ctx)
                        and ctx.attr in cls.lock_attrs
                    ):
                        d = depth + 1
                for item in node.items:
                    visit(item.context_expr, depth)
                    if item.optional_vars is not None:
                        visit(item.optional_vars, depth)
                for child in node.body:
                    visit(child, d)
                return
            if isinstance(node, ast.Call):
                self._record_call(node, scope, cls, depth)
            if isinstance(node, ast.Attribute):
                kind = (
                    "write"
                    if isinstance(node.ctx, (ast.Store, ast.Del))
                    else "read"
                )
                scope.accesses.append(
                    AttrAccess(node.attr, node.lineno, kind, depth, scope)
                )
                if kind == "write" and depth > 0 and cls is not None:
                    cls.guarded.setdefault(node.attr, node.lineno)
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                self._record_assign(node, cls, depth)
            for child in ast.iter_child_nodes(node):
                visit(child, depth)

        for stmt in fn_node.body:
            visit(stmt, 0)

    def _record_assign(self, node, cls, depth) -> None:
        """Two jobs: (a) ``self.x = threading.Lock()`` registers a lock
        attr; (b) a subscript store ``x.attr[k] = v`` under the lock
        guards ``attr`` (the Attribute itself is a Load in that form)."""
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        value = getattr(node, "value", None)
        for target in targets:
            if (
                cls is not None
                and is_self_attr(target)
                and isinstance(value, ast.Call)
            ):
                qn = self.imports.qualify(value.func)
                if qn in LOCK_FACTORIES:
                    cls.lock_attrs.add(target.attr)
            if (
                cls is not None
                and depth > 0
                and isinstance(target, ast.Subscript)
                and isinstance(target.value, ast.Attribute)
            ):
                cls.guarded.setdefault(
                    target.value.attr, target.value.lineno
                )

    def _record_call(self, node: ast.Call, scope, cls, depth) -> None:
        func = node.func
        q = self.imports.qualify(func)
        if isinstance(func, ast.Attribute):
            scope.calls.append(CallSite(
                "attr", func.attr, q,
                isinstance(func.value, ast.Name) and func.value.id == "self",
                node.lineno, depth,
            ))
            scope.self_calls.add(func.attr)
            # in-place mutation of a guarded attribute under the lock:
            # self.x.append(...) / backend.pool.checkin are reads of
            # .x/.pool; only known mutators mark the attr guarded
            if (
                cls is not None
                and depth > 0
                and func.attr in MUTATOR_METHODS
                and isinstance(func.value, ast.Attribute)
            ):
                cls.guarded.setdefault(func.value.attr, func.value.lineno)
        elif isinstance(func, ast.Name):
            scope.calls.append(CallSite(
                "name", func.id, q, False, node.lineno, depth,
            ))
            scope.name_calls.add(func.id)
        self._scan_spawns(node)

    def _scan_spawns(self, node) -> None:
        for call in (
            n for n in ast.walk(node) if isinstance(n, ast.Call)
        ):
            qn = self.imports.qualify(call.func)
            target = None
            if qn in ("threading.Thread", "threading.Timer"):
                for kw in call.keywords:
                    if kw.arg in ("target", "function"):
                        target = kw.value
                if target is None and qn == "threading.Timer":
                    if len(call.args) >= 2:
                        target = call.args[1]
                elif target is None and call.args:
                    # Thread(group, target, ...) positional form
                    if len(call.args) >= 2:
                        target = call.args[1]
            elif (
                isinstance(call.func, ast.Attribute)
                and call.func.attr in ("submit", "apply_async", "map")
                and call.args
            ):
                target = call.args[0]
            if target is None:
                continue
            if isinstance(target, ast.Attribute):
                self.spawned_names.add(target.attr)
            elif isinstance(target, ast.Name):
                self.spawned_names.add(target.id)
            tq = self.imports.qualify(target)
            if tq is not None and "." in tq:
                self.spawned_qualified.add(tq)

    # -- reachability --

    def thread_reachable(self, cls: ClassScope) -> set[str]:
        """Function names of ``cls`` reachable from any thread/executor
        entry: spawned methods and spawned nested defs, closed over
        self-calls and bare calls to sibling scopes."""
        entries = {
            name
            for name in cls.functions
            if name in self.spawned_names
        }
        reachable = set()
        frontier = list(entries)
        while frontier:
            name = frontier.pop()
            if name in reachable:
                continue
            reachable.add(name)
            scope = cls.functions.get(name)
            if scope is None:
                continue
            for callee in scope.self_calls | scope.name_calls:
                if callee in cls.functions and callee not in reachable:
                    frontier.append(callee)
        return reachable

    def module_reachable(self, entry_names: set[str]) -> set[FunctionScope]:
        """Every scope (method, nested def, or module function) reachable
        from scopes whose NAME matches ``entry_names``, following both
        attribute calls (``x.f()``) and bare calls to names defined in
        this module — the coarse intra-module graph the blocking-call
        rule walks."""
        by_name: dict[str, list[FunctionScope]] = {}
        for scope in self.iter_scopes():
            by_name.setdefault(scope.name, []).append(scope)
        # instantiating a class runs its __init__ where the call sits:
        # `Conn(...)` on the loop thread makes Conn.__init__ (and
        # whatever it calls) loop code
        for cls in self.classes:
            init = cls.functions.get("__init__")
            if init is not None:
                by_name.setdefault(cls.name, []).append(init)
        frontier = [
            s for name in entry_names for s in by_name.get(name, [])
        ]
        reachable: set = set()
        while frontier:
            scope = frontier.pop()
            if scope in reachable:
                continue
            reachable.add(scope)
            for callee in scope.self_calls | scope.name_calls:
                for nxt in by_name.get(callee, []):
                    if nxt not in reachable:
                        frontier.append(nxt)
        return reachable

    def iter_scopes(self):
        for cls in self.classes:
            yield from cls.functions.values()
        yield from self.module_functions.values()


# calls whose function arguments run ON the event-loop thread:
# callbacks are handed over BY REFERENCE (or as lambdas), so plain
# call-edge reachability never sees them — loop_callback_refs collects
# these references (and the call names inside lambda arguments) as
# extra entry points.  Deliberately NOT here: ``submit`` (the ops
# executor — its thunks block by design) and ``Thread`` (its own
# thread).
LOOP_SCHEDULING_NAMES = {
    "call_later", "call_soon", "call_soon_threadsafe", "run_sync",
    "register", "modify",
    # loop-callback factories: their function args / on_* keywords fire
    # on the loop
    "connect_unix", "LineConn",
}


def loop_callback_refs(
    tree, imports: ImportTable | None = None
) -> tuple[set[str], set[str]]:
    """Functions handed to the event loop by reference: args to the
    scheduling verbs above, call targets inside lambda args to those
    verbs, and values bound to ``on_*`` attributes (``conn.on_line =
    self.handle_line``).  Returns ``(names, qualified)`` — bare/attr
    names for intra-module matching plus import-qualified dotted names
    the program layer resolves into other modules."""

    def ref_name(expr) -> str | None:
        if isinstance(expr, ast.Attribute):
            return expr.attr
        if isinstance(expr, ast.Name):
            return expr.id
        return None

    def note(expr) -> None:
        name = ref_name(expr)
        if name is not None:
            refs.add(name)  # non-function names miss by_name: inert
            if imports is not None:
                q = imports.qualify(expr)
                if q is not None and "." in q:
                    qualified.add(q)

    refs: set[str] = set()
    qualified: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if (
                    isinstance(target, ast.Attribute)
                    and target.attr.startswith("on_")
                ):
                    note(node.value)
            continue
        if not isinstance(node, ast.Call):
            continue
        fname = ref_name(node.func)
        if fname not in LOOP_SCHEDULING_NAMES:
            continue
        args = list(node.args) + [kw.value for kw in node.keywords]
        for arg in args:
            if isinstance(arg, ast.Lambda):
                for sub in ast.walk(arg.body):
                    if isinstance(sub, ast.Call):
                        note(sub.func)
            else:
                note(arg)
    return refs, qualified


def module_scopes(module) -> ModuleScopes:
    """The shared one-pass visitor for a parsed ``core.Module``, cached
    on the module object — every rule (and the program summarizer)
    reads the same walk."""
    cached = getattr(module, "_mod_scopes", None)
    if cached is None:
        imports = ImportTable(
            module.tree, rel_to_package(getattr(module, "rel", ""))
        )
        cached = ModuleScopes(module.tree, imports)
        module._mod_scopes = cached
        module._imports = imports
    return cached


def module_imports(module) -> ImportTable:
    module_scopes(module)
    return module._imports
