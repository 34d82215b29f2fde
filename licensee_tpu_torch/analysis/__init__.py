"""Whole-program AST static analysis of the port
(``python -m licensee_tpu_torch.analysis``).

The port is a threaded serving stack — micro-batcher, writer thread,
fleet supervisor/router, stripe runner, event-loop I/O core, the
card's dispatch streams — and this package holds it to the same rules
as the JAX package's analyzer, retargeted at ``licensee_tpu_torch/``
and ``bin/licensee-tpu-torch``.  It is a WHOLE-PROGRAM analyzer:
a shared parse + scope/class visitor (``scopes.py``), a project-wide
symbol table / call graph with an on-disk incremental cache
(``program.py``), a rule registry with path-component gating and
inline pragmas (``core.py``), and the rule set:

== ======================= ==============================================
1  ``lock-discipline``     infer the lock-guarded attribute set per
                           class, flag lock-free access in
                           thread-reachable methods; methods whose
                           every call site provably holds the lock are
                           exempt (caller-holds-the-lock, propagated
                           through the call graph)
2  ``blocking-call``       blocking primitives reachable from router
                           dispatch paths and event-loop callbacks,
                           ACROSS module boundaries (a blocking helper
                           in fleet/wire.py is flagged when a loop
                           callback in router.py can reach it)
3  ``blocking-device-call`` ``block_until_ready()``/sync
                           ``dispatch_chunks``, and torch's syncing
                           calls (``torch.cuda.synchronize``,
                           ``.item()``, ``.cpu()``, ``.tolist()``,
                           ``.synchronize()``) on the overlap
                           pipeline's submit paths
4  ``resource-leak``       sockets/``Popen``/file handles without
                           ``with``/``finally`` close on all paths —
                           including ownership that crossed a module
                           boundary through a returned value
5  ``tracer-purity``       ``jax.jit``/``vmap`` functions calling host
                           effects or branching on tracer values
6  ``wallclock-time``      AST-accurate monotonic-clock house rule
7  ``no-print``            AST-accurate no-print house rule
8  ``per-blob-featurize``  AST-accurate batch-crossing house rule
9  ``protocol-drift``      the JSONL wire protocol diffed against the
                           declared schema (protocol_schema.py): ops
                           sent-but-unhandled / handled-but-unsent /
                           undeclared, error-code drift, response
                           fields read that nothing emits
10 ``protocol-stub-divergence`` the stub worker must handle exactly
                           the real worker's op set — "protocol-
                           faithful" is a checked property
11 ``metrics-doc``         every registered metric documented in the
                           README reference table or the port-only
                           table of ``licensee_tpu_torch/METRICS.md``,
                           every documented series still registered,
                           names grammatical
12 ``stale-pragma``        a pragma that suppresses nothing is itself
                           a finding — the escape-hatch inventory only
                           shrinks
== ======================= ==============================================

Suppress a finding with ``# analysis: disable=rule-id`` plus a written
justification (see core.py for scope semantics); the command exits
non-zero on any unsuppressed finding, warmed by the content-hash
incremental cache
(``--cache-ab`` is the CI gate that the cache is faster AND
finding-identical; ``--changed REF`` scans a git diff plus its
reverse-dependency closure; ``--stats`` prices every rule).
"""

from licensee_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    Module,
    PROGRAM_RULES,
    RULES,
    analyze_module,
    analyze_paths,
    analyze_project,
    analyze_source,
    iter_python_files,
    main,
)

# importing the rule modules registers their rules
from licensee_tpu_torch.analysis import (  # noqa: F401  (registration imports)
    rules_concurrency,
    rules_events,
    rules_house,
    rules_metrics,
    rules_protocol,
    rules_resources,
    rules_tracer,
)

__all__ = [
    "Finding",
    "Module",
    "PROGRAM_RULES",
    "RULES",
    "analyze_module",
    "analyze_paths",
    "analyze_project",
    "analyze_source",
    "iter_python_files",
    "main",
]
