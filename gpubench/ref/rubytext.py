"""Ruby-compatible string/regex primitives.

The reference implementation's normalization pipeline
(`lib/licensee/content_helper.rb`) is written against Ruby's regex and string
semantics.  Detection quality (and the SHA1 content-hash oracle in
`spec/fixtures/license-hashes.json`) depends on reproducing those semantics
exactly, so every translated regex in this package goes through these helpers:

* Ruby's ``^``/``$`` are always line anchors -> compile with ``re.M``.
* Ruby's ``\\w``/``\\s``/``\\d``/``\\b`` are ASCII-only -> compile with ``re.A``.
* Ruby's ``/m`` flag makes ``.`` match newlines -> ``re.S``.
* ``String#strip`` removes ASCII whitespace *and* NUL bytes.
* ``String#squeeze(' ')`` collapses runs of the space character only.
* ``String#split("\\n")`` drops trailing empty fields.
"""

from __future__ import annotations

import re

# Ruby String#strip also strips "\0"
_RUBY_STRIP_CHARS = " \t\n\r\f\v\x00"

_SQUEEZE_SPACES = re.compile(r" {2,}")


def ruby_strip(s: str) -> str:
    return s.strip(_RUBY_STRIP_CHARS)


def squeeze_spaces(s: str) -> str:
    return _SQUEEZE_SPACES.sub(" ", s)


def ruby_split_lines(s: str) -> list[str]:
    """Ruby ``String#split("\\n")``: trailing empty strings are removed."""
    parts = s.split("\n")
    while parts and parts[-1] == "":
        parts.pop()
    return parts


def rb(pattern: str, i: bool = False, m: bool = False, x: bool = False) -> re.Pattern:
    """Compile a regex with Ruby default semantics.

    ``i`` -> Ruby ``/i`` (case-insensitive), ``m`` -> Ruby ``/m`` (dot matches
    newline, Python ``re.S``), ``x`` -> extended mode.  ``re.M`` and ``re.A``
    are always on (Ruby line anchors / ASCII character classes).
    """
    flags = re.M | re.A
    if i:
        flags |= re.I
    if m:
        flags |= re.S
    if x:
        flags |= re.X
    return re.compile(pattern, flags)


def regexp_escape(s: str) -> str:
    """Ruby ``Regexp.escape`` equivalent (Python's re.escape is compatible
    for the character set that appears in license names/keys)."""
    return re.escape(s)


def union_patterns(parts: list[str | re.Pattern]) -> str:
    """Ruby ``Regexp.union`` equivalent, returning a pattern string.

    Compiled patterns are embedded with their own flags scoped (Ruby embeds
    subexpressions as ``(?i-mx:...)``); plain strings are escaped literals.
    """
    out = []
    for p in parts:
        if isinstance(p, re.Pattern):
            out.append(embed(p))
        else:
            out.append(regexp_escape(p))
    return "|".join(out) if len(out) > 1 else out[0]


def embed(p: re.Pattern) -> str:
    """Embed a compiled pattern in a larger pattern, preserving its flags the
    way Ruby's interpolation of a Regexp object does."""
    on = ""
    off = ""
    if p.flags & re.I:
        on += "i"
    else:
        off += "i"
    if p.flags & re.S:
        on += "s"
    else:
        off += "s"
    # re.M / re.A are globally applied by rb(); scoped group flags in Python
    # cannot toggle re.A, and re.M only affects ^/$ which all our patterns
    # want multiline anyway.
    flag = on + ("-" + off if off else "")
    return f"(?{flag}:{p.pattern})"


def gsub(pattern: re.Pattern, repl, s: str) -> str:
    """Ruby ``String#gsub``.  ``repl`` may be a plain string (inserted
    literally, no backslash processing) or a callable."""
    if callable(repl):
        return pattern.sub(repl, s)
    return pattern.sub(lambda m: m.expand(repl) if "\\" in repl else repl, s)


def gsub_literal(pattern: re.Pattern, repl: str, s: str) -> str:
    """gsub where the replacement is a literal string (no group refs)."""
    return pattern.sub(lambda _m: repl, s)
