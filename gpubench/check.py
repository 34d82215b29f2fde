"""The comparison that decides ``correct``: what the timed path wrote or
answered, against the plain reference (`ref/classify.py`) over the same
raw bytes.  Every verdict is compared exactly (key, matcher, the
confidence as the float the port printed, the error), so every limit is
0: a count of rows that differ.
"""

from __future__ import annotations

import numpy as np

# rows (or answers) of a window that the reference checks, drawn from
# the seed: the reference normalizes in pure Python, ~10 ms a long blob
SAMPLE = 1024


def verdict_of(row: dict) -> tuple:
    """(key, matcher, confidence, error) of a written row or an answer."""
    return (row.get("key"), row.get("matcher"), row.get("confidence"),
            row.get("error"))


def sample(seed: int, n: int, always=()) -> list[int]:
    """Indexes of up to SAMPLE of ``n`` rows, drawn from the seed, with
    the ``always`` rows among them."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 99])
    picked = set(rng.choice(n, size=min(n, SAMPLE), replace=False).tolist())
    picked.update(i for i in always if i < n)
    return sorted(picked)


def compare(got: list[dict], want: list[tuple]) -> tuple[int, list]:
    """(how many differ, the first few as (got, want))."""
    bad = [(verdict_of(g), w) for g, w in zip(got, want)
           if verdict_of(g) != tuple(w)]
    return len(bad), bad[:3]
