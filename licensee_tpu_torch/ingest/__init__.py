"""Blob-source markers shared by the read paths.

The port's copy of the part of `licensee_tpu/ingest/__init__.py` the
loose-file batch path needs: the skip-not-truncate read contract.  The
container sources (tar / zip / git / remote) wait for a later slice
(ROADMAP A).
"""

from __future__ import annotations


class SkippedBlob:
    """A blob the reader refused to load — most commonly ``oversized``
    (past the reference's MAX_LICENSE_SIZE 64 KiB cap, git_project.rb:53).

    Skipped means skipped: the blob is never truncated-and-scored; its
    output row carries ``error`` = :attr:`error` instead of a verdict."""

    __slots__ = ("error",)

    def __init__(self, error: str = "oversized"):
        self.error = error

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SkippedBlob({self.error!r})"


OVERSIZED = "oversized"

__all__ = ["SkippedBlob", "OVERSIZED"]
