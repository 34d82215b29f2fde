"""Container ingestion for the batch path: tarballs, zips and git
repositories as blob sources, read without extracting to disk.

The port's counterpart of `licensee_tpu/ingest/`.  Manifest entries
address containers with a ``::`` separator (``archive.tar::LICENSE``,
``archive.tar::*``, ``repo.git::HEAD``); ``sources.py`` expands them and
reads their members (``remote.py`` over http(s), ``loopback.py`` an
in-memory host for tests), ``verdict.py`` derives the container-level
verdict rows.

This ``__init__`` stays import-light: ``serve/featurize.py`` imports
:class:`SkippedBlob` for the skip-not-truncate read contract.
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
