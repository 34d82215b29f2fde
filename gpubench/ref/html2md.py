"""Minimal HTML -> Markdown conversion for .html license files.

Parity target: the reference converts HTML license files with the
`reverse_markdown` gem (`lib/licensee/content_helper.rb:293-299`,
`unknown_tags: :bypass`) before normalization.  This implements the subset of
that conversion the license corpus exercises (paragraphs, headings, inline
emphasis, links, lists, rules), with reverse_markdown's text-node whitespace
treatment: newlines/tabs inside text become spaces, runs of spaces collapse,
and border whitespace survives as a single space.
"""

from __future__ import annotations

import re
from html.parser import HTMLParser

_DROP = {"style", "script", "head", "title", "meta", "link"}
_BLANK_AROUND = {"p", "div", "table", "blockquote", "ul", "ol", "pre"}

_HEADING = {"h1": 1, "h2": 2, "h3": 3, "h4": 4, "h5": 5, "h6": 6}


def _treat_text(text: str) -> str:
    # reverse_markdown's Text converter: strip, fold \n/\t to spaces, squeeze
    # spaces, but preserve a single leading/trailing space if one was present.
    lead = " " if re.match(r"\A\s", text) else ""
    trail = " " if re.search(r"\s\Z", text) else ""
    core = re.sub(r" {2,}", " ", re.sub(r"[\n\t]", " ", text.strip()))
    if not core:
        return " " if (lead or trail) else ""
    return lead + core + trail


class _MarkdownBuilder(HTMLParser):
    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.out: list[str] = []
        self.drop_depth = 0
        self.list_stack: list[str] = []

    def handle_starttag(self, tag, attrs):
        if tag in _DROP:
            self.drop_depth += 1
            return
        if self.drop_depth:
            return
        if tag in _BLANK_AROUND:
            self.out.append("\n\n")
        elif tag in _HEADING:
            self.out.append("\n" + "#" * _HEADING[tag] + " ")
        elif tag in ("b", "strong"):
            self.out.append("**")
        elif tag in ("i", "em"):
            self.out.append("_")
        elif tag == "br":
            self.out.append("\n")
        elif tag == "hr":
            self.out.append("\n* * *\n")
        elif tag in ("ul", "ol"):
            self.list_stack.append(tag)
            self.out.append("\n")
        elif tag == "li":
            marker = "- " if (not self.list_stack or self.list_stack[-1] == "ul") else "1. "
            self.out.append("\n" + marker)
        elif tag == "a":
            self._href = dict(attrs).get("href")
            self.out.append("[")
        # unknown tags: bypass (children processed, tag dropped)

    def handle_startendtag(self, tag, attrs):
        if tag == "br":
            self.out.append("\n")
        elif tag == "hr":
            self.out.append("\n* * *\n")

    def handle_endtag(self, tag):
        if tag in _DROP:
            self.drop_depth = max(0, self.drop_depth - 1)
            return
        if self.drop_depth:
            return
        if tag in _BLANK_AROUND:
            self.out.append("\n\n")
        elif tag in _HEADING:
            self.out.append("\n")
        elif tag in ("b", "strong"):
            self.out.append("**")
        elif tag in ("i", "em"):
            self.out.append("_")
        elif tag in ("ul", "ol"):
            if self.list_stack:
                self.list_stack.pop()
            self.out.append("\n")
        elif tag == "a":
            href = getattr(self, "_href", None)
            self.out.append(f"]({href})" if href else "]")

    def handle_data(self, data):
        if self.drop_depth:
            return
        self.out.append(_treat_text(data))


def html_to_markdown(html: str) -> str:
    parser = _MarkdownBuilder()
    parser.feed(html)
    parser.close()
    text = "".join(parser.out)
    # reverse_markdown cleanup: drop whitespace-only lines between paragraphs,
    # collapse >2 consecutive newlines, trim the ends.
    text = re.sub(r"\n[ \t]+\n", "\n\n", text)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip()
