"""Pure-Python git-style inline word diff.

The CLI's local ``diff`` command shells out to ``git diff --word-diff``
in a tempdir (commands/diff.rb:27-37 does the same); a serving worker
answering the ``{"op": "diff"}`` wire verb cannot spawn a subprocess
and build a throwaway repository per request, so this renders the same
``[-removed-]`` / ``{+added+}`` inline markers from a difflib opcode
walk over the normalized, wrapped text the featurizer already
computes.  Deterministic, dependency-free, newline-preserving.
"""

from __future__ import annotations

import re
from difflib import SequenceMatcher

# words and hard newlines; the normalized text is already wrapped, so
# newlines carry the layout and must survive the diff
_TOKEN_RE = re.compile(r"\n|[^\s]+")


def _tokens(text: str | None) -> list[str]:
    return _TOKEN_RE.findall(text or "")


def _render(tokens: list[str]) -> str:
    out: list[str] = []
    for tok in tokens:
        if tok == "\n":
            if out and out[-1] == " ":
                out.pop()
            out.append("\n")
        else:
            out.append(tok)
            out.append(" ")
    if out and out[-1] == " ":
        out.pop()
    return "".join(out)


def word_diff(expected: str | None, actual: str | None) -> str:
    """Inline word diff from ``expected`` to ``actual``.

    Removed runs render as ``[-...-]``, added runs as ``{+...+}`` —
    the ``git diff --word-diff`` inline format the reference's diff
    command prints, minus the hunk headers (the whole normalized text
    is one hunk)."""
    a, b = _tokens(expected), _tokens(actual)
    pieces: list[str] = []
    for op, a0, a1, b0, b1 in SequenceMatcher(
        a=a, b=b, autojunk=False
    ).get_opcodes():
        if op == "equal":
            pieces.extend(a[a0:a1])
            continue
        removed = _render(a[a0:a1]) if op in ("delete", "replace") else ""
        added = _render(b[b0:b1]) if op in ("insert", "replace") else ""
        if removed and added:
            # a replaced run renders as one adjacent pair, no joining
            # space — exactly git's inline form: [-old-]{+new+}
            pieces.append(f"[-{removed}-]{{+{added}+}}")
        elif removed:
            pieces.append(f"[-{removed}-]")
        elif added:
            pieces.append(f"{{+{added}+}}")
    return _render(pieces)
