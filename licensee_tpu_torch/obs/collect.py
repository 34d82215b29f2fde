"""Cross-process trace assembly: join the per-process trace tails
(router + every worker) by 16-hex trace ID into complete trace trees,
compute the critical path per trace, and render "where did the p99 go"
as one tree.

The serve path gives every request a Dapper-style trace ID and the
router propagates it to the worker, but the spans live in two
per-process JSONL tails.  This module is the Dapper collector/assembly
half: a :class:`TraceCollector` (owned by the fleet router) PULLS
``{"op": "trace"}`` tails from every worker plus the router's own tail,
and :func:`assemble_rows` joins them into trees:

* the row whose ``proc`` is the root proc ("router") becomes the tree
  root — its spans (``route``/``hedge``/``failover``) are the routing
  story and its ``dur_ms`` is the recorded end-to-end latency;
* every worker row under the same trace ID becomes an **attempt**
  child (a failover or hedge produces several; a SIGKILLed worker's
  attempt is simply absent — its evidence is the flight recorder's
  job, obs/flight.py);
* a worker row with no router row is an **orphan** (router restarted
  mid-request): it roots its own tree, flagged, never dropped;
* exact-duplicate rows (the same tail pulled twice, a ring re-read
  after partial truncation) are deduplicated by content, so assembly
  is deterministic and re-pulling is idempotent.

**Critical path.**  Span offsets from different processes share no
clock, but durations are comparable.  The path is: the root's
end-to-end duration, attributed first to the WINNING attempt (the
answered one — at most one attempt ever contributes, so a hedged twin
can never double-count), then within that attempt to its stage spans
in time order, each clamped so the running total never exceeds the
attempt's duration; whatever remains at each level is that node's
``self_ms``.  Self-times over the critical path therefore sum to the
root duration exactly — the acceptance gate's "within 5% of the
recorded end-to-end latency" holds by construction, and truncated or
duplicated inputs can only move time BETWEEN self buckets, never mint
it.

House rules (script/lint): monotonic clocks only, no print — the
renderer returns a string.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

ROOT_PROC = "router"


def _row_fingerprint(row: dict) -> str:
    """Content identity of one tail row — the dedupe key for duplicate
    arrival (the same ring pulled twice, a hedged twin's tail re-read)."""
    return json.dumps(
        {
            "proc": row.get("proc"),
            "id": row.get("id"),
            "status": row.get("status"),
            "dur_ms": row.get("dur_ms"),
            "kind": row.get("kind"),
            "spans": row.get("spans") or [],
        },
        sort_keys=True,
    )


def _row_dur_ms(row: dict) -> float:
    """A row's duration: ``dur_ms`` when recorded, else the furthest
    span end (a truncated or stub row still gets an honest extent)."""
    dur = row.get("dur_ms")
    if isinstance(dur, (int, float)):
        return float(dur)
    end = 0.0
    for span in row.get("spans") or []:
        t = span.get("t_ms") or 0.0
        d = span.get("dur_ms") or 0.0
        try:
            end = max(end, float(t) + float(d))
        except (TypeError, ValueError):
            continue
    return end


def _span_nodes(row: dict) -> list[dict]:
    out = []
    for span in row.get("spans") or []:
        if not isinstance(span, dict) or "name" not in span:
            continue
        node = {
            "proc": row.get("proc"),
            "name": span["name"],
            "t_ms": float(span.get("t_ms") or 0.0),
            "dur_ms": float(span.get("dur_ms") or 0.0),
            "self_ms": float(span.get("dur_ms") or 0.0),
            "children": [],
        }
        if span.get("note"):
            node["note"] = span["note"]
        out.append(node)
    out.sort(key=lambda n: (n["t_ms"], n["name"]))
    return out


def _attempt_node(row: dict) -> dict:
    """One worker attempt as a tree node: its stage spans as children,
    self_ms = its duration minus the (clamped) stage coverage."""
    dur = _row_dur_ms(row)
    children = _span_nodes(row)
    covered = 0.0
    for child in children:
        contrib = max(0.0, min(child["dur_ms"], dur - covered))
        child["self_ms"] = round(contrib, 3)
        covered += contrib
    return {
        "proc": row.get("proc"),
        "name": "serve",
        "status": row.get("status"),
        "kind": row.get("kind", "trace"),
        "t_ms": 0.0,
        "dur_ms": round(dur, 3),
        "self_ms": round(max(0.0, dur - covered), 3),
        "children": children,
    }


def _pick_root(rows: list[dict], root_proc: str) -> tuple[dict, bool]:
    """The root row and whether the tree is an orphan (no root-proc
    row survived — router restarted mid-request, or single-process
    traffic).  Deterministic under duplicates and truncation: full
    ("trace") rows beat span-less slow exemplars, longer durations
    beat shorter, and the fingerprint breaks exact ties."""

    def rank(row: dict):
        return (
            row.get("proc") == root_proc,
            row.get("kind", "trace") == "trace",
            _row_dur_ms(row),
            _row_fingerprint(row),
        )

    root = max(rows, key=rank)
    return root, root.get("proc") != root_proc


def assemble_trace(rows: list[dict], root_proc: str = ROOT_PROC) -> dict:
    """Join one trace ID's rows (any order, duplicates tolerated) into
    a tree with critical-path attribution."""
    seen: dict[str, dict] = {}
    duplicates = 0
    for row in rows:
        fp = _row_fingerprint(row)
        if fp in seen:
            duplicates += 1
        else:
            seen[fp] = row
    unique = sorted(seen.items())  # fingerprint order: deterministic
    uniq_rows = [row for _fp, row in unique]
    root_row, orphan = _pick_root(uniq_rows, root_proc)
    attempts = [
        _attempt_node(row) for row in uniq_rows if row is not root_row
    ]
    root_dur = _row_dur_ms(root_row)
    root = {
        "proc": root_row.get("proc"),
        "name": "request",
        "status": root_row.get("status"),
        "kind": root_row.get("kind", "trace"),
        "t_ms": 0.0,
        "dur_ms": round(root_dur, 3),
        "children": _span_nodes(root_row) + attempts,
    }
    # the winning attempt: the answered one.  Among ok attempts the
    # FASTEST wins — a hedge race is won by the first responder, so
    # the slower ok twin is the discarded loser (its worker never
    # learns it lost and still records status ok); with no ok attempt
    # at all, the longest best explains where the time went.  At most
    # ONE attempt is ever on the critical path — a hedged twin's
    # duplicate work can never double-count.
    winner = None
    if attempts:
        ok_attempts = [a for a in attempts if a.get("status") == "ok"]
        if ok_attempts:
            winner = min(
                ok_attempts,
                key=lambda a: (a["dur_ms"], a["proc"] or ""),
            )
        else:
            winner = max(
                attempts,
                key=lambda a: (a["dur_ms"], a["proc"] or ""),
            )
    critical: list[dict] = []
    covered = 0.0
    if winner is not None:
        # every contribution clamps against the remaining budget, so
        # the path sums to root_dur EXACTLY even when clock skew or
        # truncation makes the attempt claim more time than the root
        contrib = min(winner["dur_ms"], root_dur)
        covered = contrib
        acc = 0.0
        for child in winner["children"]:
            c = max(0.0, min(child["self_ms"], contrib - acc))
            if c > 0.0:
                critical.append({
                    "proc": child["proc"],
                    "name": child["name"],
                    "self_ms": round(c, 3),
                })
                acc += c
        winner_self = max(0.0, contrib - acc)
        if winner_self > 0.0:
            critical.append({
                "proc": winner["proc"],
                "name": winner["name"],
                "self_ms": round(winner_self, 3),
            })
    else:
        # no attempt children (an orphan worker row, or single-process
        # traffic): the root's own stage spans ARE the path
        acc = 0.0
        for child in root["children"]:
            c = max(
                0.0, min(child.get("self_ms") or 0.0, root_dur - acc)
            )
            if c > 0.0:
                critical.append({
                    "proc": child["proc"],
                    "name": child["name"],
                    "self_ms": round(c, 3),
                })
                acc += c
        covered = acc
    root_self = max(0.0, root_dur - covered)
    root["self_ms"] = round(root_self, 3)
    critical.insert(0, {
        "proc": root["proc"],
        "name": root["name"],
        "self_ms": root["self_ms"],
    })
    return {
        "trace": rows[0].get("trace"),
        "status": root["status"],
        "e2e_ms": root["dur_ms"],
        "orphan": orphan,
        "procs": sorted({
            r.get("proc") for r in uniq_rows if r.get("proc")
        }),
        "attempts": len(attempts),
        "duplicates_dropped": duplicates,
        "critical_path": critical,
        "critical_ms": round(sum(c["self_ms"] for c in critical), 3),
        "root": root,
    }


def assemble_rows(
    rows: list[dict], root_proc: str = ROOT_PROC
) -> list[dict]:
    """Group tail rows by trace ID and assemble each; trees sorted
    slowest-first (the ``--slowest`` view), ID as the tie-break."""
    by_trace: dict[str, list[dict]] = {}
    for row in rows:
        tid = row.get("trace")
        if isinstance(tid, str) and tid:
            by_trace.setdefault(tid, []).append(row)
    trees = [
        assemble_trace(trace_rows, root_proc)
        for trace_rows in by_trace.values()
    ]
    trees.sort(key=lambda t: (-(t["e2e_ms"] or 0.0), t["trace"]))
    return trees


class TraceCollector:
    """Pull-model collector: fan out over tail sources (callables
    returning tail rows), tag each row with its source proc when the
    row itself carries none, and keep a bounded per-trace row store so
    spans survive between pulls (a worker ring that wrapped between
    pulls loses only what it already evicted).

    Thread-safe by lock: the router serves ``{"op": "traces"}`` from a
    small ops THREAD POOL, so concurrent pulls and reads are the
    normal case — sources are polled outside the lock (they block on
    sockets), the store is only ever touched under it."""

    def __init__(
        self,
        sources: dict | None = None,
        *,
        root_proc: str = ROOT_PROC,
        capacity: int = 512,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity!r}")
        self.sources: dict = dict(sources or {})
        self.root_proc = root_proc
        self.capacity = int(capacity)
        # trace id -> {row fingerprint: row}, LRU by insertion refresh
        self._store: OrderedDict[str, dict] = OrderedDict()
        self._lock = threading.Lock()
        # the fan-out pool is created ONCE, lazily, and reused across
        # pulls (a dashboard polling the traces verb must not churn
        # threads per request).  Deliberately NOT the router's ops
        # executor: pulls are submitted FROM an ops task, and nesting
        # a fan-out into the same bounded pool deadlocks at saturation.
        self._pool: ThreadPoolExecutor | None = None
        self.pulls = 0
        self.rows_seen = 0

    def add_source(self, name: str, fn) -> None:
        with self._lock:
            self.sources[name] = fn

    @staticmethod
    def _poll(fn) -> list:
        try:
            return fn() or []
        except Exception:  # noqa: BLE001 — a dead worker exports nothing this pull
            return []

    def _fanout_pool(self, n: int) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=min(8, max(2, n)),
                    thread_name_prefix="trace-pull",
                )
            return self._pool

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def pull(self) -> int:
        """One fan-out over every source (BLOCKING: socket round trips
        — callers run this on an ops thread, never an event loop).
        Sources are polled CONCURRENTLY, so one wedged worker costs
        the pull a single tail timeout, not one per worker.  Returns
        how many new rows were absorbed."""
        with self._lock:
            sources = list(self.sources.items())
            self.pulls += 1
        if not sources:
            return 0
        if len(sources) == 1:
            polled = [(sources[0][0], self._poll(sources[0][1]))]
        else:
            pool = self._fanout_pool(len(sources))
            futures = [
                (name, pool.submit(self._poll, fn))
                for name, fn in sources
            ]
            polled = [(name, f.result()) for name, f in futures]
        added = 0
        with self._lock:
            for name, rows in polled:
                for row in rows:
                    if not isinstance(row, dict):
                        continue
                    tid = row.get("trace")
                    if not (isinstance(tid, str) and tid):
                        continue
                    if not row.get("proc"):
                        row = {**row, "proc": name}
                    row.setdefault("kind", "trace")
                    self.rows_seen += 1
                    bucket = self._store.get(tid)
                    if bucket is None:
                        bucket = {}
                        self._store[tid] = bucket
                    else:
                        self._store.move_to_end(tid)
                    fp = _row_fingerprint(row)
                    if fp not in bucket:
                        bucket[fp] = row
                        added += 1
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
        return added

    def assembled(
        self, n: int = 20, *, trace_id: str | None = None
    ) -> list[dict]:
        """Assemble the stored rows into trees, slowest first (what
        the traces verb and CLI serve).  ``trace_id`` filters to IDs
        starting with the given hex prefix."""
        rows: list[dict] = []
        with self._lock:
            for tid, bucket in self._store.items():
                if trace_id is not None and not tid.startswith(trace_id):
                    continue
                rows.extend(bucket.values())
        trees = assemble_rows(rows, self.root_proc)
        return trees[: max(0, int(n))]

    def stats(self) -> dict:
        with self._lock:
            return {
                "traces": len(self._store),
                "sources": sorted(self.sources),
                "pulls": self.pulls,
                "rows_seen": self.rows_seen,
                "capacity": self.capacity,
            }


def render_tree(tree: dict) -> str:
    """One assembled trace as an indented text tree with per-span
    self-time — the ``licensee-tpu-torch traces`` CLI's output (returned,
    never printed: obs house rule)."""
    lines = [
        f"trace {tree['trace']}  e2e {tree['e2e_ms']:.3f}ms  "
        f"status {tree['status']}  procs {','.join(tree['procs'])}"
        + ("  [orphan]" if tree.get("orphan") else "")
    ]

    def walk(node: dict, depth: int) -> None:
        pad = "  " * depth
        note = f"  ({node['note']})" if node.get("note") else ""
        self_ms = node.get("self_ms")
        self_txt = (
            f"  self {self_ms:.3f}ms" if self_ms is not None else ""
        )
        lines.append(
            f"{pad}- [{node.get('proc') or '?'}] {node['name']}  "
            f"+{node['t_ms']:.3f}ms  dur {node['dur_ms']:.3f}ms"
            f"{self_txt}{note}"
        )
        for child in node.get("children") or []:
            walk(child, depth + 1)

    walk(tree["root"], 1)
    crit = " -> ".join(
        f"{c['proc'] or '?'}:{c['name']} {c['self_ms']:.3f}ms"
        for c in tree["critical_path"]
    )
    lines.append(
        f"  critical path ({tree['critical_ms']:.3f}ms of "
        f"{tree['e2e_ms']:.3f}ms): {crit}"
    )
    return "\n".join(lines)
