"""Deterministic SPDX license-list-XML synthesizer for at-scale runs.

The port's copy of `licensee_tpu/corpus/spdx_synth.py`: the same files,
byte for byte, for the same (n_templates, seed).

The real license list (github.com/spdx/license-list-XML) holds ~600
entries; the reference vendors only the 47 choosealicense-mirrored XMLs
(`script/vendor-spdx:4-8`).  The full-width configs of BASELINE.md
("10M blobs vs full ~600 SPDX templates") therefore need a template pool
wider than anything shipped.  This module materializes one on disk:

- the vendored 47 XMLs, copied verbatim, plus
- N-47 synthetic licenses that are valid license-list-XML documents
  exercising the schema zoo (``<titleText>``, ``<copyrightText>``,
  ``<standardLicenseHeader>``, nested ``<list>``, ``<optional>``, inline
  ``<alt>``), with bodies derived from real templates by deterministic
  word perturbation — realistic token statistics, guaranteed-distinct
  wordsets.

Everything downstream (rendering, corpus compilation, device scoring)
then runs the SAME path real license-list XML would take
(`corpus/spdx.py`), so a bench over this pool measures the honest
full-SPDX-width configuration rather than synthetic bitset rows.
"""

from __future__ import annotations

import os
import random
import re
import shutil
from xml.sax.saxutils import escape


def _word_pool(contents: list[str]) -> list[str]:
    """A stable, sorted pool of replacement words drawn from real
    templates — substitutions stay inside realistic vocabulary."""
    pool = set()
    for content in contents:
        pool.update(re.findall(r"[a-z]{4,}", content.lower()))
    return sorted(pool)


def _perturb(body: str, rng: random.Random, pool: list[str], tag: str) -> str:
    """Replace ~8% of words and plant a unique marker token so every
    synthetic template has a distinct wordset (no exact-set collisions)."""
    words = body.split(" ")
    n_swap = max(1, len(words) // 12)
    for _ in range(n_swap):
        k = rng.randrange(len(words))
        if words[k].isalpha():
            words[k] = rng.choice(pool)
    out = " ".join(words)
    return (
        out
        + f"\n\nThis instrument is the {tag} revision of these terms "
        + f"and the term {tag} controls over any conflicting clause."
    )


def _synth_xml(key: str, name: str, body: str) -> str:
    """Wrap a plain-text body in a schema-exercising license-list XML."""
    blocks = [b.strip() for b in body.split("\n\n") if b.strip()]
    # middle block becomes a <list> with a nested sublist; one block is
    # marked <optional>; the rest are plain <p> paragraphs
    parts: list[str] = []
    for j, block in enumerate(blocks):
        text = escape(block)
        if j == 1 and len(blocks) > 3:
            sentences = [s for s in re.split(r"(?<=[.;:]) ", block) if s]
            items = "".join(
                f"\n        <item><bullet>{k + 1}.</bullet> "
                f"{escape(s)}</item>"
                for k, s in enumerate(sentences[:4])
            )
            rest = escape(" ".join(sentences[4:]))
            nested = (
                f"\n        <item><bullet>a.</bullet> <list>"
                f"<item><bullet>i.</bullet> {rest}</item>"
                f"</list></item>"
                if rest
                else ""
            )
            parts.append(f"      <list>{items}{nested}\n      </list>")
        elif j == 2:
            parts.append(f"      <optional><p>{text}</p></optional>")
        elif j == 3:
            # inline <alt> mid-paragraph, canonical body kept on render
            words = text.split(" ")
            mid = len(words) // 2
            head, alt, tail = (
                " ".join(words[:mid]),
                words[mid] if mid < len(words) else "terms",
                " ".join(words[mid + 1 :]),
            )
            parts.append(
                f'      <p>{head} <alt match="{alt}|conditions" '
                f'name="w{j}">{alt}</alt> {tail}</p>'
            )
        else:
            parts.append(f"      <p>{text}</p>")
    body_xml = "\n".join(parts)
    return f"""<?xml version="1.0" encoding="UTF-8"?>
<SPDXLicenseCollection xmlns="http://www.spdx.org/license">
  <license isOsiApproved="false" licenseId="{key}" name="{escape(name)}">
    <crossRefs>
      <crossRef>https://example.invalid/licenses/{key}</crossRef>
    </crossRefs>
    <standardLicenseHeader>
      <p>Include this header with an <alt match="notice|banner"
      name="hdr">notice</alt> in every <optional>covered</optional>
      source file of {escape(name)}.</p>
    </standardLicenseHeader>
    <text>
      <titleText>
        <p>{escape(name)}</p>
      </titleText>
      <copyrightText>
        <p>Copyright (c) 1999 Example Holder</p>
      </copyrightText>
{body_xml}
    </text>
  </license>
</SPDXLicenseCollection>
"""


def synth_spdx_dir(dest: str, n_templates: int = 608, seed: int = 0) -> str:
    """Write an ``n_templates``-entry license-list-XML directory: the
    vendored 47 verbatim + synthetic schema-valid licenses to width.

    Deterministic in (n_templates, seed); returns ``dest``."""
    from licensee_tpu_torch import vendor_paths
    from licensee_tpu_torch.corpus.spdx import SpdxTemplate

    os.makedirs(dest, exist_ok=True)
    src = vendor_paths.SPDX_DIR
    names = sorted(n for n in os.listdir(src) if n.endswith(".xml"))
    for name in names:
        shutil.copy(os.path.join(src, name), os.path.join(dest, name))
    bases = [SpdxTemplate(os.path.join(src, n)) for n in names]
    pool = _word_pool([b.content for b in bases])
    rng = random.Random(seed)
    for i in range(len(names), n_templates):
        base = bases[i % len(bases)]
        tag = f"synthrev{i:04d}"
        body = _perturb(base.content, rng, pool, tag)
        key = f"Synth-{i:04d}"
        name = f"Synthetic Derived License {i:04d}"
        with open(
            os.path.join(dest, f"{key}.xml"), "w", encoding="utf-8"
        ) as f:
            f.write(_synth_xml(key, name, body))
    return dest
