"""The whole-program layer: a project-wide symbol table + call graph
built from the same one-parse-per-file ``Module`` objects the per-file
rules share, plus the on-disk incremental cache that keeps
warm runs fast.

Per file, :func:`summarize` distills a parsed ``Module`` into a
serializable :class:`ModuleSummary` — scopes with call sites (callee
name, import-qualified dotted form, receiver-is-self, lexical lock
depth), attribute accesses, class shapes (bases, lock attrs, guarded
writes), spawn/loop-callback references, resource-ownership facts, and
the wire-protocol / metrics-registration facts the program rules
consume.  :class:`Program` joins the summaries: imports resolve to
project modules (re-exports through ``__init__.py`` followed), class
hierarchies link across files, and :meth:`Program.reachable` walks the
cross-module call graph — including edges through first-class callback
references and class instantiation into ``__init__``.

Program rules see ONLY summaries, never ASTs.  That is what makes the
:class:`AnalysisCache` sound: a cache entry (keyed by the file's
content hash plus an engine-version salt over the analysis package
itself) carries the summary, the per-file findings, and the pragma
lines those findings consumed — so a warmed run re-parses nothing and
still recomputes every cross-module judgement from fresh summaries.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os

from licensee_tpu_torch.analysis.rules_metrics import extract_metric_registrations
from licensee_tpu_torch.analysis.rules_protocol import extract_protocol_facts
from licensee_tpu_torch.analysis.rules_resources import (
    RESOURCE_FACTORIES,
    function_call_facts,
    iter_function_nodes,
    returns_facts,
)
from licensee_tpu_torch.analysis.scopes import (
    loop_callback_refs,
    module_imports,
    module_scopes,
    rel_to_modname,
)

SUMMARY_VERSION = 1


class ScopeSummary:
    """One function/method/nested-def scope, AST-free."""

    __slots__ = (
        "sid", "name", "owner", "lineno", "end_lineno", "calls", "accesses",
    )

    def __init__(self, sid, name, owner, lineno, end_lineno, calls, accesses):
        self.sid = sid
        self.name = name
        self.owner = owner  # class name, or None at module level
        self.lineno = lineno
        self.end_lineno = end_lineno
        # [(kind, name, q, recv_self, line, lock_depth)]
        self.calls = calls
        # [(attr, line, kind, lock_depth)]
        self.accesses = accesses

    def to_obj(self):
        return [
            self.sid, self.name, self.owner, self.lineno, self.end_lineno,
            self.calls, self.accesses,
        ]

    @classmethod
    def from_obj(cls, obj):
        sid, name, owner, lineno, end_lineno, calls, accesses = obj
        return cls(
            sid, name, owner, lineno, end_lineno,
            [tuple(c) for c in calls], [tuple(a) for a in accesses],
        )


class ModuleSummary:
    """Everything the program rules need to know about one file."""

    def __init__(self, rel: str):
        self.rel = rel
        self.modname = rel_to_modname(rel)
        self.scopes: list[ScopeSummary] = []
        # {class name: {"lineno", "bases": [qualified], "lock_attrs": [],
        #  "guarded": {attr: line}, "methods": [scope names]}}
        self.classes: dict[str, dict] = {}
        self.imports: dict[str, str] = {}
        self.imported_modules: list[str] = []
        self.spawned_names: list[str] = []
        self.spawned_qualified: list[str] = []
        self.loop_refs: list[str] = []
        self.loop_refs_qualified: list[str] = []
        # pragma surface (suppression without re-parsing)
        self.pragmas: dict[int, list[str]] = {}
        self.pragma_only: list[int] = []
        self.scope_spans: dict[int, tuple[int, int]] = {}
        # resource ownership: calls to qualified project functions as
        # (qualified, line, disposition, bound name), plus per-function
        # return facts
        self.pcalls: list[tuple[str, int, str, str]] = []
        self.ret_facts: dict[str, dict] = {}
        # wire-protocol + metrics facts (rules_protocol / rules_metrics)
        self.protocol: dict = {}
        self.metrics: list[tuple[str, str, int, bool]] = []

    # -- (de)serialization -------------------------------------------

    def to_obj(self) -> dict:
        return {
            "v": SUMMARY_VERSION,
            "rel": self.rel,
            "scopes": [s.to_obj() for s in self.scopes],
            "classes": self.classes,
            "imports": self.imports,
            "imported_modules": self.imported_modules,
            "spawned_names": self.spawned_names,
            "spawned_qualified": self.spawned_qualified,
            "loop_refs": self.loop_refs,
            "loop_refs_qualified": self.loop_refs_qualified,
            "pragmas": {str(k): sorted(v) for k, v in self.pragmas.items()},
            "pragma_only": self.pragma_only,
            "scope_spans": {
                str(k): list(v) for k, v in self.scope_spans.items()
            },
            "pcalls": self.pcalls,
            "ret_facts": self.ret_facts,
            "protocol": self.protocol,
            "metrics": self.metrics,
        }

    @classmethod
    def from_obj(cls, obj: dict) -> "ModuleSummary":
        out = cls(obj["rel"])
        out.scopes = [ScopeSummary.from_obj(s) for s in obj["scopes"]]
        out.classes = obj["classes"]
        out.imports = obj["imports"]
        out.imported_modules = obj.get("imported_modules", [])
        out.spawned_names = obj["spawned_names"]
        out.spawned_qualified = obj["spawned_qualified"]
        out.loop_refs = obj["loop_refs"]
        out.loop_refs_qualified = obj["loop_refs_qualified"]
        out.pragmas = {
            int(k): set(v) for k, v in obj["pragmas"].items()
        }
        out.pragma_only = obj["pragma_only"]
        out.scope_spans = {
            int(k): tuple(v) for k, v in obj["scope_spans"].items()
        }
        out.pcalls = [tuple(p) for p in obj["pcalls"]]
        out.ret_facts = obj["ret_facts"]
        out.protocol = obj["protocol"]
        out.metrics = [tuple(m) for m in obj["metrics"]]
        return out

    # -- pragma filtering (the summary twin of Module.suppressed) ----

    def suppressing_line(self, at_line: int, rule_id: str) -> int | None:
        """The pragma line that suppresses a ``rule_id`` finding at
        ``at_line``, or None — same semantics as Module.suppressing_line
        but AST-free (cached files filter through this)."""
        for line in (at_line, at_line - 1):
            rules = self.pragmas.get(line)
            if rules is None:
                continue
            if line != at_line and line not in self.pragma_only:
                continue  # a trailing pragma governs its OWN line only
            if "all" in rules or rule_id in rules:
                return line
        for line, rules in self.pragmas.items():
            if not ("all" in rules or rule_id in rules):
                continue
            candidates = [line]
            if line in self.pragma_only:
                candidates.append(line + 1)
            for cand in candidates:
                span = self.scope_spans.get(cand)
                if span is not None and span[0] <= at_line <= span[1]:
                    return line
        return None


def summarize(module) -> ModuleSummary:
    """Distill one parsed Module into its program-level summary."""
    scopes = module_scopes(module)
    imports = module_imports(module)
    out = ModuleSummary(module.rel)
    out.imports = dict(imports.names)
    out.imported_modules = sorted(imports.modules)
    out.spawned_names = sorted(scopes.spawned_names)
    out.spawned_qualified = sorted(scopes.spawned_qualified)
    refs, refs_q = loop_callback_refs(module.tree, imports)
    out.loop_refs = sorted(refs)
    out.loop_refs_qualified = sorted(refs_q)
    out.pragmas = {k: set(v) for k, v in module.pragmas.items()}
    out.pragma_only = sorted(module.pragma_only_lines)
    out.scope_spans = dict(module.scope_spans())

    def add_scope(fs, owner):
        sid = len(out.scopes)
        node = fs.node
        out.scopes.append(ScopeSummary(
            sid, fs.name, owner, node.lineno, node.end_lineno,
            [
                (c.kind, c.name, c.q, c.recv_self, c.line, c.lock_depth)
                for c in fs.calls
            ],
            [
                (a.attr, a.line, a.kind, a.lock_depth)
                for a in fs.accesses
            ],
        ))
        return fs.name

    for cls in scopes.classes:
        bases = []
        for base in cls.node.bases:
            q = imports.qualify(base)
            if q is not None:
                bases.append(q)
        methods = []
        for fs in cls.functions.values():
            methods.append(add_scope(fs, cls.name))
        out.classes[cls.name] = {
            "lineno": cls.node.lineno,
            "bases": bases,
            "lock_attrs": sorted(cls.lock_attrs),
            "guarded": dict(cls.guarded),
            "methods": methods,
        }
    for fs in scopes.module_functions.values():
        add_scope(fs, None)

    # resource-ownership facts: dispositions of qualified calls, and
    # what each module-level function returns
    module_fn_names = {
        s.name for s in out.scopes if s.owner is None
    }
    for fn_node in iter_function_nodes(module.tree):
        facts = function_call_facts(fn_node)
        for call, (name, disp) in facts.items():
            q = imports.qualify(call.func)
            if q is None or q in RESOURCE_FACTORIES:
                continue
            if q.startswith(("self.", "cls.")):
                continue  # method on an instance: not a module function
            if "." not in q and q not in module_fn_names:
                continue  # a local name that is not a project function
            out.pcalls.append((q, call.lineno, disp, name or ""))
        if (
            isinstance(fn_node, ast.FunctionDef)
            and fn_node.name in module_fn_names
            and fn_node.col_offset == 0
        ):
            kind, ret_calls = returns_facts(fn_node, imports)
            if kind is not None or ret_calls:
                out.ret_facts[fn_node.name] = {
                    "kind": kind, "calls": sorted(ret_calls),
                }

    out.protocol = extract_protocol_facts(module.tree)
    out.metrics = extract_metric_registrations(module.tree)
    return out


class Program:
    """The joined view over every module summary in one analysis run."""

    def __init__(
        self,
        summaries,
        root: str | None = None,
        complete: bool = False,
        force_all: bool = False,
    ):
        self.by_rel: dict[str, ModuleSummary] = {
            s.rel: s for s in summaries
        }
        self.by_modname: dict[str, ModuleSummary] = {}
        for s in self.by_rel.values():
            self.by_modname.setdefault(s.modname, s)
        self.root = root
        # complete: the scan covered a whole tree, so "nothing else
        # sends/handles/registers X" arguments are valid.  Rules that
        # reason about the whole universe must return [] otherwise.
        self.complete = complete
        self.force_all = force_all
        # rel -> pragma lines that suppressed at least one finding; the
        # the caller seeds this from the per-file pass and program-rule
        # filtering adds to it — stale-pragma reads the residue
        self.pragma_used: dict[str, set[int]] = {}
        # per-module symbol indices
        self._names: dict[str, dict[str, list[int]]] = {}
        self._inits: dict[str, dict[str, int]] = {}
        for rel, s in self.by_rel.items():
            names: dict[str, list[int]] = {}
            inits: dict[str, int] = {}
            for sc in s.scopes:
                names.setdefault(sc.name, []).append(sc.sid)
                if sc.name == "__init__" and sc.owner is not None:
                    inits.setdefault(sc.owner, sc.sid)
            self._names[rel] = names
            self._inits[rel] = inits
        # class hierarchy: qualified class name -> (rel, class name),
        # and parent/child edges between known classes
        self._classes: dict[str, tuple[str, str]] = {}
        for rel, s in self.by_rel.items():
            for cname in s.classes:
                self._classes.setdefault(
                    f"{s.modname}.{cname}" if s.modname else cname,
                    (rel, cname),
                )
        self._parents: dict[tuple[str, str], set[tuple[str, str]]] = {}
        self._children: dict[tuple[str, str], set[tuple[str, str]]] = {}
        for rel, s in self.by_rel.items():
            for cname, cinfo in s.classes.items():
                for base in cinfo["bases"]:
                    target = self._resolve_class(rel, base)
                    if target is None:
                        continue
                    self._parents.setdefault((rel, cname), set()).add(target)
                    self._children.setdefault(target, set()).add((rel, cname))

    # -- symbol resolution -------------------------------------------

    def _resolve_class(self, rel: str, ref: str, _seen=None):
        """A base-class reference (bare or dotted) -> (rel, class).
        ``_seen`` guards circular re-export chains (a/__init__ and
        b/__init__ re-exporting each other's name must resolve to
        None, not recurse forever)."""
        if _seen is None:
            _seen = set()
        if (rel, ref) in _seen:
            return None
        _seen.add((rel, ref))
        if "." not in ref:
            s = self.by_rel[rel]
            if ref in s.classes:
                return (rel, ref)
            ref = s.imports.get(ref, ref)
            if (rel, ref) in _seen:
                return None
            _seen.add((rel, ref))
        key = ref if ref in self._classes else None
        if key is None:
            # the tail may be re-exported: resolve module prefix + name
            parts = ref.split(".")
            for i in range(len(parts) - 1, 0, -1):
                mod = self.by_modname.get(".".join(parts[:i]))
                if mod is None:
                    continue
                tail = parts[i:]
                if len(tail) == 1:
                    if tail[0] in mod.classes:
                        return (mod.rel, tail[0])
                    alias = mod.imports.get(tail[0])
                    if alias is not None and alias != ref:
                        return self._resolve_class(mod.rel, alias, _seen)
                return None
            return None
        return self._classes[key]

    def resolve(self, q: str, _seen=None) -> list[tuple[str, int]]:
        """A canonical dotted name -> [(rel, sid)] callable targets:
        module functions, ``Class`` -> its ``__init__``,
        ``Class.method``, and names re-exported through package
        ``__init__`` files (one ``from x import y`` hop at a time)."""
        if _seen is None:
            _seen = set()
        if q in _seen or not q:
            return []
        _seen.add(q)
        parts = q.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = self.by_modname.get(".".join(parts[:i]))
            if mod is None:
                continue
            tail = parts[i:]
            rel = mod.rel
            if len(tail) == 1:
                name = tail[0]
                hits = [
                    (rel, sid)
                    for sid in self._names[rel].get(name, [])
                    if mod.scopes[sid].owner is None
                ]
                init = self._inits[rel].get(name)
                if init is not None:
                    hits.append((rel, init))
                if not hits:
                    alias = mod.imports.get(name)
                    if alias is not None:
                        return self.resolve(alias, _seen)
                return hits
            if len(tail) == 2:
                cname, mname = tail
                if cname in mod.classes:
                    return [
                        (rel, sid)
                        for sid in self._names[rel].get(mname, [])
                        if mod.scopes[sid].owner == cname
                    ]
                alias = mod.imports.get(cname)
                if alias is not None:
                    return self.resolve(f"{alias}.{mname}", _seen)
            return []
        return []

    def class_family(self, rel: str, owner: str) -> set[tuple[str, str]]:
        """``owner`` plus its ancestors and descendants program-wide —
        the set of classes whose ``self`` may be the same instance."""
        family = {(rel, owner)}
        frontier = [(rel, owner)]
        while frontier:
            node = frontier.pop()
            for nxt in (
                *self._parents.get(node, ()), *self._children.get(node, ()),
            ):
                if nxt not in family:
                    family.add(nxt)
                    frontier.append(nxt)
        return family

    def hierarchy_methods(self, rel: str, owner: str, name: str):
        """Methods called ``name`` across ``owner``'s class hierarchy
        (ancestors and descendants program-wide): a ``self.m()`` in a
        base class dispatches to any override, and an override's caller
        may hold a base-class self."""
        family = self.class_family(rel, owner)
        hits = []
        for crel, cname in family:
            for sid in self._names.get(crel, {}).get(name, []):
                if self.by_rel[crel].scopes[sid].owner == cname:
                    hits.append((crel, sid))
        return hits

    # -- the call-graph walk -----------------------------------------

    def call_targets(self, rel: str, scope: ScopeSummary, call):
        """Targets of one call site: cross-module via the qualified
        name, intra-module by callee name (attr calls match any scope
        of that name — the receiver is untyped), class instantiation
        into ``__init__``, and ``self.m()`` through the hierarchy."""
        kind, name, q, recv_self, _line, _depth = call
        targets: list[tuple[str, int]] = []
        if q is not None:
            targets.extend(self.resolve(q))
        names = self._names[rel]
        s = self.by_rel[rel]
        for sid in names.get(name, []):
            targets.append((rel, sid))
        init = self._inits[rel].get(name)
        if init is not None:
            targets.append((rel, init))
        if kind == "attr" and recv_self and scope.owner is not None:
            targets.extend(self.hierarchy_methods(rel, scope.owner, name))
        del s
        # dedupe, preserving order
        seen = set()
        out = []
        for t in targets:
            if t not in seen:
                seen.add(t)
                out.append(t)
        return out

    def reachable(self, entries, skip_edge=None):
        """BFS over the cross-module call graph.  ``entries`` is an
        iterable of ``(rel, sid, why)``; returns ``{(rel, sid): why}``
        where ``why`` names the entry that first reached the scope.
        ``skip_edge(module_summary, scope, call)`` may veto edges (the
        blocking-call rule skips pragma-suppressed call sites)."""
        result: dict[tuple[str, int], str] = {}
        frontier: list[tuple[str, int, str]] = list(entries)
        while frontier:
            rel, sid, why = frontier.pop()
            if (rel, sid) in result:
                continue
            result[(rel, sid)] = why
            s = self.by_rel[rel]
            scope = s.scopes[sid]
            for call in scope.calls:
                if skip_edge is not None and skip_edge(s, scope, call):
                    continue
                for trel, tsid in self.call_targets(rel, scope, call):
                    if (trel, tsid) not in result:
                        frontier.append((trel, tsid, why))
        return result

    # -- import graph (the --changed reverse closure) ----------------

    def module_deps(self, rel: str) -> set[str]:
        """Project files ``rel`` imports (directly) — from bound names
        AND full imported-module paths (``import a.b`` depends on
        ``a.b`` though it binds only ``a``)."""
        s = self.by_rel[rel]
        deps: set[str] = set()
        for target in (*s.imports.values(), *s.imported_modules):
            parts = target.split(".")
            for i in range(len(parts), 0, -1):
                mod = self.by_modname.get(".".join(parts[:i]))
                if mod is not None:
                    deps.add(mod.rel)
                    break
        deps.discard(rel)
        return deps

    def reverse_closure(self, rels) -> set[str]:
        """``rels`` plus every file that (transitively) imports one of
        them — the set whose findings a change can affect."""
        importers: dict[str, set[str]] = {}
        for rel in self.by_rel:
            for dep in self.module_deps(rel):
                importers.setdefault(dep, set()).add(rel)
        out = {r for r in rels if r in self.by_rel}
        frontier = list(out)
        while frontier:
            rel = frontier.pop()
            for importer in importers.get(rel, ()):
                if importer not in out:
                    out.add(importer)
                    frontier.append(importer)
        return out

    # -- pragma bookkeeping ------------------------------------------

    def mark_used(self, rel: str, line: int) -> None:
        self.pragma_used.setdefault(rel, set()).add(line)

    def filter_findings(self, findings):
        """Drop pragma-suppressed program-rule findings, recording
        which pragma lines earned their keep."""
        kept = []
        for f in findings:
            s = self.by_rel.get(f.path)
            if s is None:
                kept.append(f)
                continue
            line = s.suppressing_line(f.line, f.rule)
            if line is None:
                kept.append(f)
            else:
                self.mark_used(f.path, line)
        return kept


# -- the incremental cache -------------------------------------------


def engine_salt() -> str:
    """Content hash over the analysis package itself (plus nothing
    else): any rule/schema edit invalidates every cache entry."""
    here = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for name in sorted(os.listdir(here)):
        if not name.endswith(".py"):
            continue
        h.update(name.encode("utf-8"))
        with open(os.path.join(here, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def content_sha(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


class AnalysisCache:
    """Per-file (summary, findings, used-pragmas) keyed by content
    hash, salted by the engine version.  Misses cost a parse; hits cost
    a dict lookup — the warmed CI run re-parses only changed files."""

    def __init__(self, path: str, salt: str):
        self.path = path
        self.salt = salt
        self.hits = 0
        self.misses = 0
        self._entries: dict[str, dict] = {}
        self._dirty = False
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
            if (
                isinstance(data, dict)
                and data.get("salt") == salt
                and isinstance(data.get("files"), dict)
            ):
                self._entries = data["files"]
        except (OSError, ValueError):
            pass  # cold cache: corrupt or absent files start empty

    def get(self, rel: str, sha: str) -> dict | None:
        entry = self._entries.get(rel)
        if entry is not None and entry.get("sha") == sha:
            self.hits += 1
            return entry
        self.misses += 1
        return None

    def put(
        self, rel: str, sha: str, summary: ModuleSummary,
        findings, used_pragmas,
    ) -> None:
        self._entries[rel] = {
            "sha": sha,
            "summary": summary.to_obj(),
            "findings": [[f.line, f.rule, f.message] for f in findings],
            "used_pragmas": sorted(used_pragmas),
        }
        self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"salt": self.salt, "files": self._entries}, f)
        os.replace(tmp, self.path)
        self._dirty = False
