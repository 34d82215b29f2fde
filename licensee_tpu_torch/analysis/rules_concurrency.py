"""Concurrency rules: whole-program lock-discipline race detection,
cross-module blocking-call reachability, and the per-module
blocking-device-call pipeline gate.

**lock-discipline** (whole-program) — per class that owns a
``threading.Lock``/``RLock``/``Condition`` attribute AND hands work to
a thread or executor: the guarded attribute set is inferred from
writes inside ``with self._lock:`` blocks (assignments, subscript
stores, and in-place mutator calls like ``.append``), then every read
or write of a guarded attribute OUTSIDE any lock block, in a method
reachable from a thread entry (``threading.Thread(target=...)``,
``executor.submit``, ``threading.Timer`` — spawn references resolved
across modules), is a finding.  ``__init__`` is exempt — object
construction happens-before any thread start.  A method whose EVERY
same-class call site holds the lock (transitively: or is itself only
called lock-held) carries the caller-holds-the-lock contract through
the call graph — the ``_spawn``-style helpers that previously needed
pragmas are now proven, not excused.

**blocking-call** (whole-program) — inside the router dispatch/handler
call paths AND every event-loop callback (the selectors core of
serve/eventloop.py carries all fleet and serve socket I/O on ONE
thread — a single blocking primitive there stalls every connection at
once), calls that park the carrying thread are findings: ``time.sleep``,
blocking socket verbs (``recv``/``sendall``/``accept``/``connect``/
``makefile``), file ``open``, ``subprocess`` waits, the fleet's own
``oneshot`` probe round trip, and the synchronous ``dispatch_chunks``
device wrapper.  Entry points are the session/dispatch methods plus
the loop-callback surface: any ``_on_*``/``on_*`` scope (the fd-event
convention), the named timer callbacks, and every function handed to
the loop BY REFERENCE (``call_later``/``call_soon*``/``run_sync``
args, lambdas passed to the connect/LineConn factories, ``on_*``
rebinding).  Reachability now crosses MODULE boundaries: qualified
calls into imported project functions, class instantiation into
``__init__`` (imported classes included), ``self.m()`` through class
hierarchies, and callback references that resolve into other modules —
a blocking helper in fleet/wire.py is flagged when an eventloop
callback in router.py can reach it.  A call edge whose own line is
pragma-suppressed for blocking-call is a sanctioned synchronous
fan-out: the walk does not descend through it.

**blocking-device-call** (per-module) — ``block_until_ready()`` / the
sync ``dispatch_chunks`` wrapper on the overlap pipeline's SUBMIT
paths; the completion/await side is deliberately exempt.
"""

from __future__ import annotations

import ast

from licensee_tpu_torch.analysis.core import Finding, program_rule, rule
from licensee_tpu_torch.analysis.scopes import (
    LOOP_SCHEDULING_NAMES,  # noqa: F401  (re-export: the one list)
    module_imports,
    module_scopes,
    rel_basename as _basename,
)

# -- shared per-module accessors (kept here: every rule module uses
# these names) --------------------------------------------------------


def _scopes(module):
    return module_scopes(module)


def _imports(module):
    return module_imports(module)


# -- lock-discipline -----------------------------------------------------

# attributes that are themselves synchronization objects (a secondary
# mutex/condition assigned inside a locked section): reading them to
# acquire them is not a data race.  Deliberately NARROW — an exemption
# for e.g. "done"/"stop" would hide any guarded counter that happens
# to carry those substrings, and Event attrs never enter the guarded
# set anyway (.set() is not a tracked mutator)
_SYNC_ATTR_HINTS = ("lock", "cond")


@program_rule(
    "lock-discipline",
    doc=(
        "An attribute written under `with self._lock:` is read or "
        "written lock-free in thread-reachable code (methods whose "
        "every call site provably holds the lock are exempt — the "
        "caller-holds-the-lock contract, propagated through the call "
        "graph)"
    ),
)
def check_lock_discipline(program):
    findings = []
    # spawn targets that qualify across modules (Thread(target=mod.fn))
    extra_spawned: dict[str, set[str]] = {}
    for s in program.by_rel.values():
        for q in s.spawned_qualified:
            for rel, sid in program.resolve(q):
                sc = program.by_rel[rel].scopes[sid]
                extra_spawned.setdefault(rel, set()).add(sc.name)
    # every attr-call site in the program, for the contract's OUTSIDE
    # view: (caller rel, caller class, receiver-is-self, lock depth).
    # A `self.m()` in an unrelated class is that class's own method; a
    # `handle.m()` on an unknown receiver might be OURS — it revokes.
    ext_attr_calls: dict[str, list] = {}
    method_defs: set[tuple[str, str, str]] = set()
    for s in program.by_rel.values():
        for sc in s.scopes:
            if sc.owner is not None:
                method_defs.add((s.rel, sc.owner, sc.name))
            for kind, callee, _q, recv_self, _line, depth in sc.calls:
                if kind == "attr":
                    ext_attr_calls.setdefault(callee, []).append(
                        (s.rel, sc.owner, recv_self, depth)
                    )
    for s in program.by_rel.values():
        spawned = set(s.spawned_names) | extra_spawned.get(s.rel, set())
        by_owner: dict[str, list] = {}
        for sc in s.scopes:
            if sc.owner is not None:
                by_owner.setdefault(sc.owner, []).append(sc)
        for cname, cinfo in s.classes.items():
            lock_attrs = set(cinfo["lock_attrs"])
            guarded_map = cinfo["guarded"]
            if not lock_attrs or not guarded_map:
                continue
            class_scopes = by_owner.get(cname, [])
            names_of: dict[str, list] = {}
            for sc in class_scopes:
                names_of.setdefault(sc.name, []).append(sc)
            entries = {n for n in names_of if n in spawned}
            if not entries:
                continue
            # intra-class reachability from the thread entries
            reach: set[str] = set()
            frontier = list(entries)
            while frontier:
                n = frontier.pop()
                if n in reach:
                    continue
                reach.add(n)
                for sc in names_of.get(n, []):
                    for _k, callee, _q, _rs, _line, _d in sc.calls:
                        if callee in names_of and callee not in reach:
                            frontier.append(callee)
            # the caller-holds-the-lock contract: every same-class call
            # site at lock depth > 0 (or from a scope that itself
            # carries the contract) — greatest fixed point, violators
            # removed until stable
            call_sites: dict[str, list] = {}
            for sc in class_scopes:
                for _k, callee, _q, _rs, _line, depth in sc.calls:
                    if callee in names_of:
                        call_sites.setdefault(callee, []).append(
                            (sc.name, depth)
                        )
            family = program.class_family(s.rel, cname)

            def revoked_from_outside(method: str) -> bool:
                """A call site OUTSIDE this class that may target this
                method lock-free breaks the contract: any non-self
                receiver (unknown — could be our instance), or a
                ``self.m()`` elsewhere in the hierarchy that does not
                resolve to that class's own override and runs without
                the (shared) lock."""
                for crel, cowner, recv_self, depth in ext_attr_calls.get(
                    method, ()
                ):
                    if (crel, cowner) == (s.rel, cname):
                        continue  # same class: already a call site
                    if not recv_self:
                        return True
                    if cowner is None:
                        continue  # self outside a class cannot be ours
                    if (crel, cowner) not in family:
                        continue  # an unrelated class's own method
                    if (crel, cowner, method) in method_defs:
                        continue  # the subclass overrides it
                    if depth == 0:
                        return True
                return False

            held = {
                n
                for n in names_of
                if n != "__init__"
                and n not in entries
                and call_sites.get(n)
                and not revoked_from_outside(n)
            }
            changed = True
            while changed:
                changed = False
                for n in list(held):
                    if not all(
                        depth > 0 or caller in held
                        for caller, depth in call_sites[n]
                    ):
                        held.discard(n)
                        changed = True
            guarded = {
                a
                for a in guarded_map
                if a not in lock_attrs
                and not any(h in a.lower() for h in _SYNC_ATTR_HINTS)
            }
            seen: set[tuple[int, str]] = set()
            for fname in sorted(reach):
                if fname == "__init__" or fname in held:
                    continue
                for sc in names_of.get(fname, []):
                    for attr, line, kind, depth in sc.accesses:
                        if (
                            attr in guarded
                            and depth == 0
                            and (line, attr) not in seen
                        ):
                            seen.add((line, attr))
                            findings.append(Finding(
                                s.rel, line, "lock-discipline",
                                f"{cname}.{fname} {kind}s "
                                f"'.{attr}' without the lock, but it is "
                                f"lock-guarded elsewhere (first guarded "
                                f"write at line {guarded_map[attr]}) and "
                                f"this method runs on a spawned thread",
                            ))
    return findings


# -- blocking-call -------------------------------------------------------

# entry points of the dispatch/handler paths (matched against method
# and function names in the loop-carrying modules)
HANDLER_ENTRY_NAMES = {
    "dispatch", "handle", "handle_line", "run_session", "_drain",
    "_race", "_attempt", "_emit",
}

# timer callbacks the event loop dispatches (EventLoop.call_later
# targets in the loop modules).  fd-event callbacks need no list:
# every scope named ``_on_*``/``on_*`` is treated as a loop callback
# by convention — see check_blocking_call.
LOOP_TIMER_ENTRY_NAMES = {
    "_beat", "_sweep", "_probe_tick", "_probe_send",
    "_attempt_timeout", "_hedge_fire", "_dispatch_round",
    "_submit", "_begin", "_start_op", "_fill", "_push", "_flush",
    "_split_lines", "_flush_writes",
    "_run_loop",  # the loop thread itself IS loop code
}

# the modules whose scopes may BE loop entries (basename match, so a
# fixture program can cast its own router.py); blocking SITES are
# flagged wherever the walk reaches, any module
LOOP_MODULE_BASENAMES = (
    "router.py", "server.py", "eventloop.py", "http_edge.py",
)

# fully-qualified calls that block the carrying thread
BLOCKING_QUALIFIED = {
    "time.sleep": "sleeps on the handler path",
    "subprocess.run": "waits on a subprocess",
    "subprocess.call": "waits on a subprocess",
    "subprocess.check_call": "waits on a subprocess",
    "subprocess.check_output": "waits on a subprocess",
    "os.system": "waits on a subprocess",
    "socket.create_connection": "dials a socket synchronously",
    "licensee_tpu_torch.fleet.wire.oneshot": (
        "performs a synchronous probe round trip"
    ),
    "open": "performs synchronous file I/O",
    "io.open": "performs synchronous file I/O",
}
# blocking socket/process verbs called as methods on SOME object; the
# receiver is untyped, so these only fire on the loop-reachable walk
BLOCKING_METHODS = {
    "recv": "blocks on a socket read",
    "recv_into": "blocks on a socket read",
    "sendall": "blocks on a socket write",
    "accept": "blocks accepting a connection",
    "connect": "dials a socket synchronously (use connect_ex on a "
               "non-blocking socket)",
    "makefile": "wraps a blocking socket stream",
    "communicate": "waits on a subprocess",
    "dispatch_chunks": "is the synchronous device submit+await "
                       "wrapper; the loop must never wait on the "
                       "device",
}
# bare names that resolve to module functions known to block (the
# wire-layer probe helpers imported into the loop modules)
BLOCKING_IMPORT_TAILS = {"oneshot": "performs a synchronous probe round trip"}


def _blocking_match(summary, module_fn_names, call):
    """(what, why) when this call site parks the carrying thread."""
    kind, name, q, _recv_self, _line, _depth = call
    if q is not None and q in BLOCKING_QUALIFIED:
        return q, BLOCKING_QUALIFIED[q]
    if q is not None:
        tail = q.split(".")[-1]
        if tail in BLOCKING_IMPORT_TAILS and (
            tail in summary.imports or tail in module_fn_names
        ):
            return tail, BLOCKING_IMPORT_TAILS[tail]
    if kind == "attr" and name in BLOCKING_METHODS:
        return f".{name}", BLOCKING_METHODS[name]
    return None


def _entry_scopes(summary):
    """(sid, entry-name) loop entries of one module: the handler/timer
    name lists, the ``_on_*`` fd-callback convention, and references
    handed to the loop's scheduling verbs."""
    names = (
        HANDLER_ENTRY_NAMES | LOOP_TIMER_ENTRY_NAMES | set(summary.loop_refs)
    )
    out = []
    for sc in summary.scopes:
        if sc.name in names or sc.name.startswith(("_on_", "on_")):
            out.append((sc.sid, sc.name))
    return out


@program_rule(
    "blocking-call",
    doc=(
        "A dispatch/handler path or an event-loop callback (fd event "
        "or timer) reaches a blocking primitive (time.sleep, socket "
        "verbs, file I/O, subprocess waits, the sync dispatch_chunks "
        "wrapper) — across module boundaries — and one blocked loop "
        "callback stalls every connection"
    ),
)
def check_blocking_call(program):
    entries = []
    any_loop_module = False
    for s in program.by_rel.values():
        if not (
            program.force_all or _basename(s.rel) in LOOP_MODULE_BASENAMES
        ):
            continue
        any_loop_module = True
        for sid, name in _entry_scopes(s):
            entries.append((s.rel, sid, (s.rel, name)))
        for q in s.loop_refs_qualified:
            for rel, sid in program.resolve(q):
                entries.append((rel, sid, (s.rel, f"callback ref {q}")))
    if not any_loop_module or not entries:
        return []
    mf_names = {
        s.rel: {sc.name for sc in s.scopes if sc.owner is None}
        for s in program.by_rel.values()
    }

    def skip_edge(summary, _scope, call):
        # a blocking call IS the finding — never also walk through it —
        # and a pragma on the call line sanctions the whole subtree
        # (the sync fleet-scrape fan-out pattern)
        if _blocking_match(summary, mf_names[summary.rel], call):
            return True
        pline = summary.suppressing_line(call[4], "blocking-call")
        if pline is not None:
            program.mark_used(summary.rel, pline)
            return True
        return False

    reached = program.reachable(entries, skip_edge)
    findings = []
    seen: set[tuple[str, int]] = set()
    for (rel, sid), origin in sorted(
        reached.items(), key=lambda kv: (kv[0][0], kv[0][1])
    ):
        s = program.by_rel[rel]
        scope = s.scopes[sid]
        for call in scope.calls:
            match = _blocking_match(s, mf_names[rel], call)
            if match is None:
                continue
            what, why = match
            line = call[4]
            if (rel, line) in seen:
                continue
            seen.add((rel, line))
            origin_rel, origin_name = origin
            via = (
                ""
                if origin_rel == rel
                else f" (loop-reachable from {origin_rel} {origin_name})"
            )
            findings.append(Finding(
                rel, line, "blocking-call",
                f"handler path '{scope.name}' calls {what}() which "
                f"{why}; the async router core cannot carry this{via}",
            ))
    return findings


# -- blocking-device-call ------------------------------------------------

# Entry points of the overlap pipeline's SUBMIT side: the scheduler
# thread's flush path (serve/scheduler.py), the batch run loop with its
# nested producers (projects/batch_project.py), and the card scorer's
# submit seam (kernels/dice_cuda.py `BestMatchScorer.submit`, which
# enqueues the copies and the launch on a dispatch stream and returns
# the CUDA event).  The completion/await side (_complete_group,
# finish_chunks callers, warmup, `DeviceFuture.result`) is ALLOWED to
# block — awaiting the device there is its whole job — so it is
# deliberately not an entry.
PIPELINE_ENTRY_NAMES = {
    "_flush", "_submit_group", "_loop", "submit",  # scheduler thread
    "run", "dispatch_gathered", "submit_next",     # batch run loop
    "dispatch_chunks_async",                       # the submit seam itself
}

# device synchronization verbs that must never ride the submit path
BLOCKING_DEVICE_METHODS = {
    "block_until_ready": "synchronizes the carrying thread with the device",
    "dispatch_chunks": (
        "is the synchronous submit+await wrapper; submit with "
        "dispatch_chunks_async and await the DeviceFuture on the "
        "completion lane"
    ),
    # torch: each of these waits for the card's queue to drain up to
    # the tensor (or the event/stream) it is called on
    "item": "copies a device scalar to the host, waiting for the card",
    "cpu": "copies a device tensor to the host, waiting for the card",
    "tolist": "copies a device tensor to the host, waiting for the card",
    "synchronize": (
        "waits for a CUDA event or stream; return the event and let "
        "the completion lane wait on it"
    ),
}
BLOCKING_DEVICE_QUALIFIED = {
    "jax.block_until_ready": (
        "synchronizes the carrying thread with the device"
    ),
    "torch.cuda.synchronize": (
        "synchronizes the carrying thread with every stream of the card"
    ),
}
# the synchronous wrappers whose own DEFINITION is the sanctioned home
# of the await: the JAX package's `dispatch_chunks`, and the card
# scorer's `__call__` (submit, then wait on the returned event)
SYNC_WRAPPER_NAMES = {"block_until_ready", "dispatch_chunks", "__call__"}


@rule(
    "blocking-device-call",
    dirs=(
        "licensee_tpu_torch/serve/scheduler",
        "licensee_tpu_torch/projects/batch_project",
        "licensee_tpu_torch/kernels/batch",
        "licensee_tpu_torch/kernels/dice_cuda",
    ),
    doc=(
        "The overlap pipeline's submit path (scheduler flush, batch "
        "run loop, dispatch_chunks_async, the card scorer's submit) "
        "calls a device-synchronizing primitive (block_until_ready, "
        "the sync dispatch_chunks wrapper, torch.cuda.synchronize, "
        ".item(), .cpu(), .tolist(), an event's or stream's "
        ".synchronize()) — the device lane must stay asynchronous"
    ),
)
def check_blocking_device_call(module):
    scopes = _scopes(module)
    imports = _imports(module)
    reachable = scopes.module_reachable(PIPELINE_ENTRY_NAMES)
    findings = []
    seen: set[int] = set()
    for scope in reachable:
        if scope.name in SYNC_WRAPPER_NAMES:
            # the sync wrapper's own DEFINITION is the one sanctioned
            # home of the await; flagging its body would flag the seam
            continue
        for node in ast.walk(scope.node):
            if not isinstance(node, ast.Call):
                continue
            qn = imports.qualify(node.func)
            why = None
            what = qn
            if qn is not None and qn in BLOCKING_DEVICE_QUALIFIED:
                why = BLOCKING_DEVICE_QUALIFIED[qn]
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in BLOCKING_DEVICE_METHODS
            ):
                why = BLOCKING_DEVICE_METHODS[node.func.attr]
                what = f".{node.func.attr}"
            if why is None or node.lineno in seen:
                continue
            seen.add(node.lineno)
            findings.append(
                module.finding(
                    "blocking-device-call",
                    node.lineno,
                    f"pipeline submit path '{scope.name}' calls "
                    f"{what}() which {why}",
                )
            )
    return findings
