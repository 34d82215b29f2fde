"""A reader for the small YAML subset of the vendored corpus metadata.

The JAX package reads the license front matter, `_data/fields.yml`,
`_data/rules.yml` and the fixtures' `fixtures.yml` with PyYAML; the port
runs where PyYAML is not installed, so it reads them here.  What those
files use, and what this reader takes:

* top-level ``key: value`` pairs with plain, single- or double-quoted
  scalars; a plain scalar may continue on more-indented lines (folded
  with one space, as YAML folds them) and may itself contain ``"``;
* ``true``/``false``/``yes``/``no``/``on``/``off``/``null``/``~``,
  decimal integers and decimal floats resolve as PyYAML's safe loader
  resolves them; dates, octal/hex/binary numbers and .inf/.nan raise;
  everything else stays a string;
* ``[]``/``{}`` empty flow collections, and block sequences of scalars;
* nested flat mappings of scalars (``using:`` in the front matter, each
  fixture's entry in fixtures.yml), whose keys may hold spaces;
* block sequences of flat mappings, under a top-level key (rules.yml,
  whose ``- `` items sit at the key's own indent) or as the whole
  document (``- name: ...`` in fields.yml);
* a leading ``---`` document marker and comments (`load_document`).

Anything else raises ValueError instead of guessing.  Tests hold this
reader against ``yaml.safe_load`` on every vendored file.
"""

from __future__ import annotations

import re

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?\Z")
# scalars YAML would read as something this reader does not build
_UNSUPPORTED = re.compile(
    r"(?:[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt ].*)?|[-+]?0[0-7]+|0x[0-9a-f]+"
    r"|0b[01]+|[-+]?\.(?:inf|nan))\Z",
    re.I,
)
_KEY = re.compile(r"([A-Za-z0-9_.-]+):(?:[ \t]+(.*))?\Z")
# a line of a nested mapping, whose keys may hold spaces and non-ASCII
_NESTED_KEY = re.compile(r"([^\s#\-\[{'\"][^:]*):(?:[ \t]+(.*))?\Z")


def _scalar(text: str):
    """One scalar, as YAML's safe loader resolves it."""
    text = text.strip()
    if not text:
        return None
    if text[0] == '"':
        if len(text) < 2 or text[-1] != '"':
            raise ValueError(f"unterminated double-quoted scalar: {text!r}")
        if re.search(r'\\[^"\\/]', text[1:-1]):
            raise ValueError(f"unsupported escape in {text!r}")
        return re.sub(r'\\(["\\/])', r"\1", text[1:-1])
    if text[0] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise ValueError(f"unterminated single-quoted scalar: {text!r}")
        return text[1:-1].replace("''", "'")
    if text == "[]":
        return []
    if text == "{}":
        return {}
    if text[0] in "[{&*!|>%@`":
        raise ValueError(f"unsupported YAML scalar: {text!r}")
    # a plain scalar ends at " #" (a comment)
    cut = text.find(" #")
    if cut >= 0:
        text = text[:cut].rstrip()
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~"):
        return None
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _UNSUPPORTED.match(text):
        raise ValueError(f"unsupported YAML scalar: {text!r}")
    return text


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


def _significant(lines: list[str]) -> list[tuple[int, str]]:
    """(indent, text) for every line that is not blank or a comment."""
    out = []
    for line in lines:
        stripped = line.strip()
        if stripped and not stripped.startswith("#"):
            out.append((_indent(line), stripped))
    return out


def load_mapping(text: str) -> dict:
    """The top-level mapping of one YAML document (no ``---`` markers)."""
    rows = _significant(text.split("\n"))
    out: dict = {}
    i = 0
    while i < len(rows):
        indent, line = rows[i]
        m = _KEY.match(line)
        if indent or m is None:
            raise ValueError(f"expected a top-level key, got {line!r}")
        key, value = m.group(1), m.group(2)
        i += 1
        # the block under the key: more-indented lines, and a sequence's
        # ``- `` items at the key's own indent (as rules.yml has them)
        body = []
        start = i
        while i < len(rows) and (
            rows[i][0] > 0 or rows[i][1] == "-" or rows[i][1].startswith("- ")
        ):
            body.append(rows[i][1])
            i += 1
        block = rows[start:i]
        if value is not None and value.strip():
            if body:
                # a plain scalar folded over more-indented lines
                if value.lstrip()[0] in "\"'[{":
                    raise ValueError(f"multi-line quoted scalar at {key!r}")
                value = " ".join([value.strip(), *body])
            out[key] = _scalar(value)
        elif not body:
            out[key] = None
        elif body[0].startswith("- ") and _KEY.match(body[0][2:].strip()):
            out[key] = _sequence_of_mappings(block)
        elif all(b.startswith("- ") or b == "-" for b in body):
            out[key] = [_scalar(b[1:]) for b in body]
        elif all(_NESTED_KEY.match(b) for b in body) and len(
            {ind for ind, _ in block}
        ) == 1:
            out[key] = _flat_mapping(body)
        else:
            raise ValueError(f"unsupported YAML block under {key!r}")
    return out


def _flat_mapping(lines: list[str]) -> dict:
    """``key: scalar`` lines of one indent; a key may hold spaces."""
    out = {}
    for line in lines:
        m = _NESTED_KEY.match(line)
        name = m.group(1).rstrip()
        if name in out:
            raise ValueError(f"duplicate key {name!r}")
        out[name] = _scalar(m.group(2) or "")
    return out


def _sequence_of_mappings(rows: list[tuple[int, str]]) -> list[dict]:
    """(indent, text) rows of a block sequence of flat mappings: each
    item a ``- key: value`` line, its other keys on the lines after it,
    indented past the dash."""
    out: list[dict] = []
    dash = None
    for indent, line in rows:
        if line.startswith("- "):
            if dash is not None and indent != dash:
                raise ValueError(f"misaligned sequence entry {line!r}")
            dash = indent
            out.append({})
            line = line[2:].strip()
        elif not out or indent <= dash:
            raise ValueError(f"expected a sequence entry, got {line!r}")
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"expected key: value, got {line!r}")
        out[-1][m.group(1)] = _scalar(m.group(2) or "")
    return out


def front_matter(raw: str | None) -> dict:
    """The mapping of a ``---``-delimited front-matter block; {} if none."""
    if not raw:
        return {}
    body = raw.split("\n")
    if body and body[0].strip() == "---":
        body = body[1:]
    if "---" in [b.strip() for b in body]:
        body = body[: [b.strip() for b in body].index("---")]
    return load_mapping("\n".join(body))


def load_document(text: str) -> dict:
    """A whole YAML file whose document is a mapping: comments and a
    leading ``---`` marker allowed (fixtures.yml, rules.yml)."""
    lines = text.split("\n")
    for i, line in enumerate(lines):
        stripped = line.strip()
        if stripped and not stripped.startswith("#"):
            if stripped == "---":
                lines = lines[i + 1 :]
            break
    return load_mapping("\n".join(lines))


def load_sequence_of_mappings(text: str) -> list[dict]:
    """A top-level block sequence of flat mappings (``- name: x``)."""
    return _sequence_of_mappings(_significant(text.split("\n")))
