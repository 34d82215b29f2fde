"""The append-only job journal: one JSONL record per lifecycle edge.

The port's copy of `licensee_tpu/jobs/journal.py`: the same file format,
so either package replays the other's journal.

Durability is the whole design.  Every record is a single newline-
terminated ``write()`` followed by flush + fsync, so a record is
either fully on disk or not there at all — the only partial state a
crash can leave is a TORN TAIL (the final line missing its newline,
or cut mid-JSON), and replay tolerates exactly that: the tail is
dropped, everything before it is law.  A torn or invalid line
ANYWHERE ELSE is real corruption and replay refuses loudly rather
than silently resurrecting half a fleet's worth of jobs.

The journal never rewrites: job state folds at replay time (last
state record wins), which keeps appends O(record) and makes the
on-disk format trivially inspectable with ``tail -f``.  Records carry
no wall-clock stamps — ordering IS the journal order, and the batch
tier's house rule (monotonic clocks only) holds here too.
"""

from __future__ import annotations

import json
import os
import threading

__all__ = ["JobJournal", "JournalError"]


class JournalError(RuntimeError):
    """The journal is corrupt beyond the torn-tail contract (an
    invalid record that IS newline-terminated, i.e. was fully
    written once) — replay must not guess."""


class JobJournal:
    """One on-disk journal file, append-only, thread-safe.

    ``append`` serializes the record to one JSON line and fsyncs it;
    ``replay`` yields every durable record in order.  The file handle
    stays open across appends (the executor appends on job lifecycle
    edges, a few per job)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = None
        self.appended = 0

    def _handle(self):
        if self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "ab")
        return self._f

    def append(self, record: dict) -> None:
        """Durably append one record: a single write of the full
        newline-terminated line, then flush + fsync — after this
        returns, the record survives a SIGKILL."""
        line = json.dumps(record, separators=(",", ":")) + "\n"
        data = line.encode("utf-8")
        if b"\n" in data[:-1]:
            raise ValueError("journal record serialized with embedded newline")
        with self._lock:
            f = self._handle()
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
            self.appended += 1

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def replay(self) -> list[dict]:
        """Every durable record, in append order.  A torn tail (the
        last line lacking its newline, or the last line not parsing)
        is dropped — that is the one state an fsync'd single-write
        append can leave after a crash.  An invalid NON-tail record
        raises :class:`JournalError`."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return []
        records: list[dict] = []
        lines = raw.split(b"\n")
        # a newline-terminated file splits with a trailing empty
        # element; anything after the final newline is the torn tail
        torn_tail = lines.pop() if lines else b""
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as exc:
                if i == len(lines) - 1 and not torn_tail:
                    # final newline made it to disk but the line body
                    # didn't survive the crash intact: still the tail
                    continue
                raise JournalError(
                    f"{self.path}: corrupt record at line {i + 1}: {exc}"
                ) from None
            if isinstance(rec, dict):
                records.append(rec)
        return records
