"""Extended corpus: compile SPDX license-list-XML templates directly.

The port's copy of `licensee_tpu/corpus/spdx.py`, on the port's own
normalization pipeline and corpus compiler.

The reference vendors only the 47 choosealicense-mirrored SPDX XMLs
(`script/vendor-spdx:4-8`), so the north-star "full ~600 SPDX set"
configs (BASELINE.md) require ingesting templates beyond what
choosealicense ships.  This module renders any SPDX license-list-XML
`src/` directory — e.g. a checkout of github.com/spdx/license-list-XML —
into License-like template objects and compiles them with the same
corpus compiler / Dice algebra as the vendored pool, so the whole device
path (the plain scorers, K1 and K2) works unchanged over an arbitrary
template count.

Rendering follows the SPDX matching guidelines the reference's
normalization already encodes: the canonical `<text>` is flattened with
`<p>` as paragraphs and `<list>/<item>` as bullet lines; `<alt>` falls
back to its canonical body; `<optional>` bodies are kept (the
normalization pipeline strips the optional/copyright/title content the
same way it does for the vendored txt templates); `<alt>` segments are
counted for the length-delta adjustment exactly like
`License#spdx_alt_segments` (license.rb:273-283).
"""

from __future__ import annotations

import functools
import os
import re
import xml.etree.ElementTree as ET

from licensee_tpu_torch.corpus.compiler import CompiledCorpus
from licensee_tpu_torch.normalize.pipeline import NormalizedContent

_NS = "{http://www.spdx.org/license}"


def _strip_ns(tag: str) -> str:
    return tag[len(_NS):] if tag.startswith(_NS) else tag


def _render(node, out: list[str]) -> None:
    """Flatten an SPDX <text> subtree into plain text blocks."""
    tag = _strip_ns(node.tag)
    if tag in ("p", "titleText", "copyrightText"):
        parts: list[str] = []
        _render_inline(node, parts)
        text = re.sub(r"\s+", " ", "".join(parts)).strip()
        if text:
            out.append(text)
    elif tag == "list":
        for child in node:
            _render(child, out)
    elif tag == "item":
        parts = []
        bullet = ""
        for child in node:
            if _strip_ns(child.tag) == "bullet":
                bullet = (child.text or "").strip()
        _render_inline(node, parts, skip=("bullet",))
        text = re.sub(r"\s+", " ", "".join(parts)).strip()
        out.append((bullet + " " + text).strip() if bullet else text)
    elif tag in ("standardLicenseHeader",):
        return  # not part of the license body proper
    else:
        # text / optional / alt and unknown containers: recurse block-wise
        if node.text and node.text.strip():
            out.append(re.sub(r"\s+", " ", node.text).strip())
        for child in node:
            _render(child, out)
            if child.tail and child.tail.strip():
                out.append(re.sub(r"\s+", " ", child.tail).strip())


def _render_inline(node, parts: list[str], skip: tuple[str, ...] = ()) -> None:
    """Inline flattening: text, <alt> canonical bodies, <br/> as newline."""
    if node.text:
        parts.append(node.text)
    for child in node:
        tag = _strip_ns(child.tag)
        if tag in skip:
            pass
        elif tag == "br":
            parts.append("\n")
        else:
            _render_inline(child, parts)
        if child.tail:
            parts.append(child.tail)


class SpdxTemplate(NormalizedContent):
    """A License-like template rendered from one SPDX license-list XML."""

    def __init__(self, path: str):
        self.path = path
        with open(path, encoding="utf-8") as f:
            raw = f.read()
        root = ET.fromstring(raw)
        lic = root.find(f"{_NS}license")
        if lic is None:
            lic = root.find(f"{_NS}exception")
        if lic is None:
            raise ValueError(f"no <license> element in {path}")
        self.key = (lic.get("licenseId") or "").lower()
        self.spdx_id = lic.get("licenseId")
        self.title = lic.get("name")
        text_node = lic.find(f"{_NS}text")
        blocks: list[str] = []
        if text_node is not None:
            _render(text_node, blocks)
        self.content = "\n\n".join(blocks)

        # alt-segment count per license.rb:273-283: on the raw XML with
        # copyright/title/optional blocks removed
        text = re.search(r"<text>(.*)</text>", raw, re.S)
        body = text.group(1) if text else ""
        body = re.sub(r"<copyrightText>.*?</copyrightText>", "", body, flags=re.S)
        body = re.sub(r"<titleText>.*?</titleText>", "", body, flags=re.S)
        body = re.sub(r"<optional.*?>.*?</optional>", "", body, flags=re.S)
        self.spdx_alt_segments = len(re.findall(r"<alt .*?>", body, re.S))

    @property
    def creative_commons_q(self) -> bool:
        return self.key.startswith("cc-")

    def __repr__(self) -> str:
        return f"<SpdxTemplate {self.spdx_id}>"


def load_spdx_dir(path: str) -> list[SpdxTemplate]:
    """Every parseable license XML under an SPDX `src/` directory."""
    templates = []
    for name in sorted(os.listdir(path)):
        if not name.endswith(".xml"):
            continue
        try:
            templates.append(SpdxTemplate(os.path.join(path, name)))
        except (ET.ParseError, ValueError):
            continue  # deprecated/malformed entries don't sink the corpus
    return templates


@functools.cache
def spdx_corpus(path: str | None = None) -> CompiledCorpus:
    """Compile an SPDX license-list-XML directory (default: the vendored
    47-license mirror) into device scoring constants."""
    from licensee_tpu_torch import vendor_paths

    if path is None:
        path = vendor_paths.SPDX_DIR
    return CompiledCorpus.compile(load_spdx_dir(path))
