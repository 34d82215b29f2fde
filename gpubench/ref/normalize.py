"""The license text normalization engine.

This is the host-side hot path of the framework: every candidate file and
every license template is folded through the same deterministic, ordered
pipeline before wordset extraction and Dice scoring.

Parity target: `lib/licensee/content_helper.rb` (the ContentHelper mixin).
The pipeline order is load-bearing — each pass sees the output of the
previous one — and the SHA1 of the normalized output of every vendored
template must reproduce `spec/fixtures/license-hashes.json` byte-for-byte.
That golden corpus is enforced by tests/test_normalize_hashes.py.

Stage 1 (`content_without_title_and_version`, reference content_helper.rb:144-151):
    html -> hrs -> comments -> markdown_headings -> link_markup -> title -> version
Stage 2 (`content_normalized`, reference content_helper.rb:153-168):
    downcase, then normalizations (lists, https, ampersands, dashes, quote,
    hyphenated, spelling, span_markup, bullets), then strip methods (bom,
    cc_optional, cc0_optional, unlicense_optional, borders, title, version,
    url, copyright, title, block_markup, developed_by, end_of_terms,
    whitespace, mit_optional).

The benchmark's frozen copy of the port's pipeline, held by the plain
reference: it runs the regex passes only (its ``_native()`` answers
None), where the port runs C++ twins of the hottest passes, so the
reference's wordsets come from a second implementation of every pass.
"""

from __future__ import annotations

import hashlib
import re

from gpubench.ref.rubytext import (
    rb,
    regexp_escape,
    ruby_split_lines,
    ruby_strip,
    squeeze_spaces,
)

START = r"\A\s*"

# reference: content_helper.rb:11-33
REGEXES = {
    "bom": rb(START + "﻿"),
    "hrs": rb(r"^\s*[=\-*]{3,}\s*$"),
    "all_rights_reserved": rb(START + r"all rights reserved\.?$", i=True),
    "whitespace": rb(r"\s+"),
    "markdown_headings": rb(r"^\s*#+"),
    "version": rb(START + r"version.*$", i=True),
    "span_markup": rb(r"[_*~]+(.*?)[_*~]+"),
    "link_markup": rb(r"\[(.+?)\]\(.+?\)"),
    "block_markup": rb(r"^\s*>"),
    "border_markup": rb(r"^[*-](.*?)[*-]$"),
    "comment_markup": rb(r"^\s*?[/*]{1,2}"),
    "url": rb(START + r"https?://[^ ]+\n"),
    "bullet": rb(r"\n\n\s*(?:[*-]|\(?[\da-z]{1,2}[).])\s+", i=True),
    "developed_by": rb(START + r"developed by:.*?\n\n", i=True, m=True),
    "cc_dedication": rb(
        r"The\s+text\s+of\s+the\s+Creative\s+Commons.*?Public\s+Domain\s+Dedication.",
        i=True,
        m=True,
    ),
    "cc_wiki": rb(r"wiki.creativecommons.org", i=True),
    "cc_legal_code": rb(r"^\s*Creative Commons Legal Code\s*$", i=True),
    "cc0_info": rb(r"For more information, please see\s*\S+zero\S+", i=True, m=True),
    "cc0_disclaimer": rb(r"CREATIVE COMMONS CORPORATION.*?\n\n", i=True, m=True),
    "unlicense_info": rb(r"For more information, please.*\S+unlicense\S+", i=True, m=True),
    "mit_optional": rb(r"\(including the next paragraph\)", i=True),
}

END_OF_TERMS = rb(r"^[\s#*_]*end of (the )?terms and conditions[\s#*_]*$", i=True)

# reference: content_helper.rb:45-88 — SPDX matching-guideline word folds.
# Insertion order is load-bearing: it is the regex alternation order.
VARIETAL_WORDS = {
    "acknowledgment": "acknowledgement",
    "analogue": "analog",
    "analyse": "analyze",
    "artefact": "artifact",
    "authorisation": "authorization",
    "authorised": "authorized",
    "calibre": "caliber",
    "cancelled": "canceled",
    "capitalisations": "capitalizations",
    "catalogue": "catalog",
    "categorise": "categorize",
    "centre": "center",
    "emphasised": "emphasized",
    "favour": "favor",
    "favourite": "favorite",
    "fulfil": "fulfill",
    "fulfilment": "fulfillment",
    "initialise": "initialize",
    "judgment": "judgement",
    "labelling": "labeling",
    "labour": "labor",
    "licence": "license",
    "maximise": "maximize",
    "modelled": "modeled",
    "modelling": "modeling",
    "offence": "offense",
    "optimise": "optimize",
    "organisation": "organization",
    "organise": "organize",
    "practise": "practice",
    "programme": "program",
    "realise": "realize",
    "recognise": "recognize",
    "signalling": "signaling",
    "sub-license": "sublicense",
    "sub license": "sublicense",
    "utilisation": "utilization",
    "whilst": "while",
    "wilful": "wilfull",
    "non-commercial": "noncommercial",
    "per cent": "percent",
    "copyright owner": "copyright holder",
}

_SPELLING = rb(
    r"\b(?:" + "|".join(regexp_escape(k) for k in VARIETAL_WORDS) + r")\b"
)

# reference: content_helper.rb:34-41 (applied in insertion order)
_LISTS = rb(r"^\s*(?:\d\.|[*-])(?: [*_]{0,2}\(?[\da-z]\)[*_]{0,2})?\s+([^\n])")
_HTTP = rb(r"http:")
_QUOTES = rb("[`'\"‘“’”]")
_HYPHENATED = rb(r"(\w+)-\s*\n\s*(\w+)")
_BULLET_JOIN = rb(r"\)\s+\(")

# Ruby's `(?<!^)…(?!$)` (not at line start / not at line end).  Python rejects
# zero-width anchors in lookbehind on some versions, so express the same
# predicate positionally: preceded by a non-newline char, followed by one.
_DASHES = rb(r"(?<=[^\n])([—–-]+)(?=[^\n])")

# reference: matchers/copyright.rb:8-11 — also used by strip_copyright
COPYRIGHT_SYMBOLS = r"(?:copyright|\(c\)|©)"
_MAIN_LINE = r"[_*\-\s]*" + COPYRIGHT_SYMBOLS + r".*$"
_OPTIONAL_LINE = r"[_*\-\s]*with Reserved Font Name.*$"
COPYRIGHT_PATTERN = START + r"((?:" + _MAIN_LINE + r")(?:" + _OPTIONAL_LINE + r")*)+$"
COPYRIGHT_REGEX = rb(COPYRIGHT_PATTERN, i=True)
# Copyright matcher full-content test: /#{REGEX}+\z/i (matchers/copyright.rb:13)
COPYRIGHT_FULL_REGEX = rb(r"(?:" + COPYRIGHT_PATTERN + r")+\Z", i=True)

_STRIP_COPYRIGHT = rb(
    r"(?:" + COPYRIGHT_PATTERN + r")|(?:" + START + r"all rights reserved\.?$)",
    i=True,
)

WORDSET_TOKEN = rb(r"(?:[\w/-](?:'s|(?<=s)')?)+")


def _get_title_regex():
    # Lazy: the global title regex is synthesized from the full license corpus
    # (content_helper.rb:199-215); importing here avoids a circular import.
    from gpubench.ref.license import global_title_regex

    return global_title_regex()


def _native():
    """The reference has no native passes: the regexes run."""
    return None


# [`'"‘“’”] -> "'" is a pure character map: str.translate runs it at C
# speed, byte-identically to _QUOTES.sub("'", ...)
_QUOTE_TABLE = str.maketrans({ch: "'" for ch in "`'\"‘“’”"})


_RUN3_MASK = None  # lazy: one 256-entry bool mask for [=\-*], built once


def _has_run3(c: str) -> bool:
    """Vectorized gate for the hrs pass: ^\\s*[=\\-*]{3,}\\s*$ cannot
    match without 3 consecutive bytes from the class — one numpy
    frombuffer + shift-AND answers that without a regex scan."""
    global _RUN3_MASK
    import numpy as np

    if _RUN3_MASK is None:
        mask = np.zeros(256, dtype=bool)
        mask[[ord(ch) for ch in "=-*"]] = True
        _RUN3_MASK = mask
    b = c.encode("utf-8", "surrogatepass")
    if len(b) < 3:
        return False
    m = _RUN3_MASK[np.frombuffer(b, dtype=np.uint8)]
    return bool((m[:-2] & m[1:-1] & m[2:]).any())


def _starts_after_ws(c: str, needle_lower: str) -> bool:
    """Gate for \\A\\s*<literal> heads (version/url/developed_by): skip
    the Ruby-\\s run, then a caseless literal compare — no regex."""
    i = 0
    n = len(c)
    while i < n and c[i] in " \t\n\v\f\r":
        i += 1
    return c[i : i + len(needle_lower)].lower() == needle_lower


def _plain_strip(content: str, regex: re.Pattern, might: bool = True) -> str:
    """Ruby ContentHelper#strip: gsub(regex, ' ').squeeze(' ').strip —
    the squeeze and strip apply even when the regex does not match.

    ``might=False`` means a literal gate proved the regex cannot match:
    the sub is skipped but the squeeze/strip contract still holds."""
    nat = _native()
    if nat is not None:
        if regex is REGEXES["whitespace"]:
            return nat.strip_whitespace(content)
        return nat.squeeze_strip(regex.sub(" ", content) if might else content)
    subbed = regex.sub(" ", content) if might else content
    return ruby_strip(squeeze_spaces(subbed))


class NormalizedContent:
    """Mixin providing the normalization pipeline, wordsets, and Dice
    similarity.  Subclasses provide ``content`` (str | None) and may provide
    ``filename`` and ``spdx_alt_segments``."""

    content: str | None = None

    # -- public surface (content_helper.rb:108-168) --

    @property
    def wordset(self) -> frozenset[str]:
        cached = self.__dict__.get("_wordset")
        if cached is None:
            cn = self.content_normalized()
            if cn is None:
                cached = None
            else:
                nat = _native()
                cached = (
                    nat.wordset(cn)
                    if nat is not None
                    else frozenset(WORDSET_TOKEN.findall(cn))
                )
            self.__dict__["_wordset"] = cached
        return cached

    @property
    def length(self) -> int:
        cn = self.content_normalized()
        return len(cn) if cn else 0

    def length_delta(self, other) -> int:
        return abs(self.length - other.length)

    def similarity(self, other) -> float:
        """Sørensen–Dice word-set similarity as a percentage, with the
        length-delta false-positive penalty (content_helper.rb:128-133).

        Note the asymmetry: ``self`` is normally the License — the field
        excision and the SPDX-alt-adjusted delta use self's metadata.  The
        delta divide is Ruby Integer division (floor)."""
        overlap = len(self.wordset_fieldless & other.wordset)
        total = (
            len(self.wordset_fieldless)
            + len(other.wordset)
            - len(self.fields_normalized_set)
        )
        return (overlap * 200.0) / (total + self._variation_adjusted_length_delta(other) // 4)

    @property
    def content_hash(self) -> str:
        cached = self.__dict__.get("_content_hash")
        if cached is None:
            cached = hashlib.sha1(
                self.content_normalized().encode("utf-8")
            ).hexdigest()
            self.__dict__["_content_hash"] = cached
        return cached

    @property
    def content_without_title_and_version(self) -> str:
        cached = self.__dict__.get("_cwtv")
        if cached is None:
            c = ruby_strip(self.content if self.content is not None else "")
            c = self._strip_html(c)
            # literal gates: a pass whose pattern requires a byte/substring
            # the text lacks cannot match — same rationale (and the same
            # gate set) as the native pipeline's plain_strip_gated
            c = _plain_strip(c, REGEXES["hrs"], might=_has_run3(c))
            c = self._strip_comments(c)
            c = _plain_strip(
                c, REGEXES["markdown_headings"], might="#" in c
            )
            if "[" in c:
                c = REGEXES["link_markup"].sub(lambda m: m.group(1), c)
            c = self._strip_title(c)
            c = _plain_strip(
                c, REGEXES["version"], might=_starts_after_ws(c, "version")
            )
            cached = c
            self.__dict__["_cwtv"] = cached
        return cached

    def content_normalized(self, wrap_at: int | None = None) -> str | None:
        cached = self.__dict__.get("_content_normalized")
        if cached is None:
            c = self.content_without_title_and_version.lower()

            # normalizations (gsub only — no squeeze/strip side effects);
            # the dash/quote/hyphenation/spelling passes run as native
            # scanners when built (bit-identical, tests/test_textops.py).
            # Each gated pass is a literal no-op when its required byte is
            # absent; _HTTP and the quote class are literal/char-class
            # transforms, so str.replace / str.translate run them at C
            # speed byte-identically on the fallback path.
            nat = _native()
            c = _LISTS.sub(lambda m: "- " + m.group(1), c)
            c = c.replace("http:", "https:")
            c = c.replace("&", "and")
            has_dashish = "-" in c or "–" in c or "—" in c
            if nat is not None:
                if has_dashish:
                    c = nat.dashes(c)
                c = nat.quotes(c)
                if "-" in c:
                    c = nat.hyphenated(c)
                c = nat.spelling(c)
            else:
                if has_dashish:
                    c = _DASHES.sub("-", c)
                c = c.translate(_QUOTE_TABLE)
                if "-" in c:
                    c = _HYPHENATED.sub(
                        lambda m: m.group(1) + "-" + m.group(2), c
                    )
                c = _SPELLING.sub(lambda m: VARIETAL_WORDS[m.group(0)], c)
            if "_" in c or "*" in c or "~" in c:
                c = REGEXES["span_markup"].sub(lambda m: m.group(1), c)
            if "\n\n" in c:
                c = REGEXES["bullet"].sub(lambda _m: "\n\n- ", c)
            if ")" in c:
                c = _BULLET_JOIN.sub(lambda _m: ")(", c)

            # strip methods (content_helper.rb:89-105), in order
            c = _plain_strip(c, REGEXES["bom"], might="﻿" in c)
            c = self._strip_cc_optional(c)
            c = self._strip_cc0_optional(c)
            c = self._strip_unlicense_optional(c)
            if "*" in c or "-" in c:
                c = REGEXES["border_markup"].sub(lambda m: m.group(1), c)
            c = self._strip_title(c)
            c = _plain_strip(
                c, REGEXES["version"], might=_starts_after_ws(c, "version")
            )
            c = _plain_strip(
                c, REGEXES["url"], might=_starts_after_ws(c, "http")
            )
            c = self._strip_copyright(c)
            c = self._strip_title(c)
            c = _plain_strip(c, REGEXES["block_markup"], might=">" in c)
            c = _plain_strip(
                c,
                REGEXES["developed_by"],
                might=_starts_after_ws(c, "developed by:"),
            )
            c = self._strip_end_of_terms(c)
            c = _plain_strip(c, REGEXES["whitespace"])
            c = _plain_strip(
                c, REGEXES["mit_optional"], might="(including" in c
            )

            cached = c
            self.__dict__["_content_normalized"] = cached
        if wrap_at is None:
            return cached
        return wrap(cached, wrap_at)

    # -- field excision (content_helper.rb:323-335) --

    @property
    def wordset_fieldless(self) -> frozenset[str]:
        cached = self.__dict__.get("_wordset_fieldless")
        if cached is None:
            cached = self.wordset - self.fields_normalized_set
            self.__dict__["_wordset_fieldless"] = cached
        return cached

    @property
    def fields_normalized(self) -> list[str]:
        """Substitutable-field names in normalized content, duplicates kept."""
        cached = self.__dict__.get("_fields_normalized")
        if cached is None:
            from gpubench.ref.fields import field_regex

            cached = [
                m.group(1) for m in field_regex().finditer(self.content_normalized())
            ]
            self.__dict__["_fields_normalized"] = cached
        return cached

    @property
    def fields_normalized_set(self) -> frozenset[str]:
        return frozenset(self.fields_normalized)

    def _variation_adjusted_length_delta(self, other) -> int:
        # content_helper.rb:337-347: Licenses get the SPDX-alt-segment
        # adjusted delta; plain files get the raw delta.
        delta = self.length_delta(other)
        alt = getattr(self, "spdx_alt_segments", None)
        if alt is None:
            return delta
        adjusted = delta - max(len(self.fields_normalized), alt) * 5
        return adjusted if adjusted > 0 else 0

    # -- strip helpers --

    def _strip_html(self, c: str) -> str:
        filename = getattr(self, "filename", None)
        if not filename:
            return c
        dot = filename.rfind(".")
        ext = filename[dot:] if dot >= 0 else ""
        if not re.match(r".*\.html?", ext, re.I):
            return c
        from gpubench.ref.html2md import html_to_markdown

        return html_to_markdown(c)

    def _strip_comments(self, c: str) -> str:
        # content_helper.rb:246-252: only strip when every line is a comment
        lines = ruby_split_lines(c)
        if len(lines) == 1:
            return c
        if not all(REGEXES["comment_markup"].search(line) for line in lines):
            return c
        return _plain_strip(c, REGEXES["comment_markup"])

    def _strip_title(self, c: str) -> str:
        # content_helper.rb:238-240: peel title lines from the front
        title_regex = _get_title_regex()
        while title_regex.search(c):
            c = _plain_strip(c, title_regex)
        return c

    def _strip_copyright(self, c: str) -> str:
        while _STRIP_COPYRIGHT.search(c):
            c = _plain_strip(c, _STRIP_COPYRIGHT)
        return c

    def _strip_cc_optional(self, c: str) -> str:
        if "creative commons" not in c:
            return c
        c = _plain_strip(c, REGEXES["cc_dedication"])
        return _plain_strip(c, REGEXES["cc_wiki"])

    def _strip_cc0_optional(self, c: str) -> str:
        if "associating cc0" not in c:
            return c
        c = _plain_strip(c, REGEXES["cc_legal_code"])
        c = _plain_strip(c, REGEXES["cc0_info"])
        return _plain_strip(c, REGEXES["cc0_disclaimer"])

    def _strip_unlicense_optional(self, c: str) -> str:
        if "unlicense" not in c:
            return c
        return _plain_strip(c, REGEXES["unlicense_info"])

    def _strip_end_of_terms(self, c: str) -> str:
        m = END_OF_TERMS.search(c)
        return c[: m.start()] if m else c


def wrap(text: str | None, line_width: int = 80) -> str | None:
    """Re-wrap normalized text (content_helper.rb:177-193), used by the diff
    command and the detection-quality specs."""
    if text is None:
        return None
    text = REGEXES["bullet"].sub(lambda m: "\n" + m.group(0) + "\n", text)
    text = rb(r"([^\n])\n([^\n])").sub(lambda m: m.group(1) + " " + m.group(2), text)

    fill = rb(r"(.{1," + str(line_width) + r"})(\s+|$)")
    lines = []
    for line in ruby_split_lines(text):
        if REGEXES["hrs"].search(line) or len(line) <= line_width:
            lines.append(line)
        else:
            lines.append(ruby_strip(fill.sub(lambda m: m.group(1) + "\n", line)))
    return ruby_strip("\n".join(lines))


def format_percent(value: float) -> str:
    return f"{value:.2f}%"
