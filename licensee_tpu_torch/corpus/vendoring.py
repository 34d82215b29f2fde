"""Corpus refresh tooling: re-vendor data and regenerate goldens.

The reference keeps its vendored corpus refreshable with four scripts —
`script/vendor-licenses` (choosealicense _data + _licenses),
`script/vendor-spdx` (the license-list-XML sources for the vendored
spdx-ids), `script/hash-licenses` (spec/fixtures/license-hashes.json),
and `script/dump-fixture-licenses` (spec/fixtures/fixtures.yml)
(script/vendor-licenses:1-11, vendor-spdx:1-20, hash-licenses:1-14,
dump-fixture-licenses:1-25 of the reference).  This module is the
port's copy of `licensee_tpu/corpus/vendoring.py`, over the port's own
corpus and projects, with the JAX package's one deliberate difference
from the reference: the reference curls GitHub tarballs, and these
vendor functions take a local CHECKOUT path instead — clone the two
repositories anywhere, point the functions at them, and re-run the
golden generators.  Nothing here downloads.

The regenerated goldens equal the shipped ones (license-hashes.json,
fixtures.yml), and re-vendoring from a checkout shaped like the current
vendor tree is byte-identical, so the shipped corpus is what these
tools produce.
"""

from __future__ import annotations

import json
import os
import re
import shutil

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
VENDOR_LICENSES_DIR = os.path.join(REPO_ROOT, "vendor", "choosealicense.com")
VENDOR_SPDX_DIR = os.path.join(REPO_ROOT, "vendor", "license-list-XML")
FIXTURES_DIR = os.path.join(REPO_ROOT, "tests", "fixtures")


def vendor_licenses(checkout: str, vendor_dir: str | None = None) -> list[str]:
    """Re-vendor `_data/*` and `_licenses/*` from a local
    choosealicense.com checkout (script/vendor-licenses:1-8: rm -Rf then
    extract exactly those two trees).  Returns the copied paths."""
    vendor_dir = vendor_dir or VENDOR_LICENSES_DIR
    for sub in ("_data", "_licenses"):
        src = os.path.join(checkout, sub)
        if not os.path.isdir(src):
            raise FileNotFoundError(
                f"not a choosealicense.com checkout: {checkout!r} has no "
                f"{sub}/"
            )
    if os.path.isdir(vendor_dir):
        shutil.rmtree(vendor_dir)
    copied = []
    for sub in ("_data", "_licenses"):
        dst = os.path.join(vendor_dir, sub)
        shutil.copytree(os.path.join(checkout, sub), dst)
        copied.extend(
            os.path.join(dst, name) for name in sorted(os.listdir(dst))
        )
    return copied


def vendored_spdx_ids(vendor_dir: str | None = None) -> list[str]:
    """The spdx-id of every vendored license text — the include list the
    reference greps out of the frontmatter (script/vendor-spdx:4)."""
    licenses_dir = os.path.join(
        vendor_dir or VENDOR_LICENSES_DIR, "_licenses"
    )
    ids = []
    for name in sorted(os.listdir(licenses_dir)):
        if not name.endswith(".txt"):
            continue
        with open(
            os.path.join(licenses_dir, name), encoding="utf-8"
        ) as f:
            m = re.search(r"^spdx-id: (.+)$", f.read(), re.M)
        if m:
            ids.append(m.group(1).strip())
    return ids


def vendor_spdx(
    checkout: str,
    vendor_dir: str | None = None,
    licenses_vendor_dir: str | None = None,
) -> list[str]:
    """Re-vendor `src/<spdx-id>.xml` for every vendored license from a
    local spdx/license-list-XML checkout (script/vendor-spdx:1-9).
    Returns the copied paths; raises if any vendored id has no XML in
    the checkout (a partial vendor tree would silently shrink the
    corpus).

    ``licenses_vendor_dir``: where the include-list of spdx-ids comes
    from — pass the SAME alternate dir a prior vendor_licenses(...,
    vendor_dir=...) wrote, or the default repo tree is consulted (an
    alternate-dir refresh that greps the stale default tree would
    silently skip newly added licenses)."""
    vendor_dir = vendor_dir or VENDOR_SPDX_DIR
    src_dir = os.path.join(checkout, "src")
    if not os.path.isdir(src_dir):
        raise FileNotFoundError(
            f"not a license-list-XML checkout: {checkout!r} has no src/"
        )
    ids = vendored_spdx_ids(licenses_vendor_dir)
    missing = [
        i for i in ids
        if not os.path.isfile(os.path.join(src_dir, f"{i}.xml"))
    ]
    if missing:
        raise FileNotFoundError(
            f"checkout {checkout!r} lacks XML for vendored ids: "
            + ", ".join(missing)
        )
    if os.path.isdir(vendor_dir):
        shutil.rmtree(vendor_dir)
    dst_dir = os.path.join(vendor_dir, "src")
    os.makedirs(dst_dir)
    copied = []
    for i in ids:
        dst = os.path.join(dst_dir, f"{i}.xml")
        shutil.copy(os.path.join(src_dir, f"{i}.xml"), dst)
        copied.append(dst)
    return copied


def license_hashes_json() -> str:
    """The license-hashes.json golden, regenerated (script/hash-licenses:
    1-14: every non-pseudo license's normalized content hash, pretty
    JSON)."""
    from licensee_tpu_torch.corpus.license import License

    licenses = License.all(hidden=True, pseudo=False)
    hashes = {lic.key: lic.content_hash for lic in licenses}
    # no trailing newline: byte parity with the Ruby-written golden
    return json.dumps(hashes, indent=2)


# data-only fixture dirs (corpus inputs, not project trees) — excluded
# from fixtures.yml and from tests/test_fixtures.py alike
# ("analysis" is the static-analyzer rule corpus, tests/test_analysis.py)
NON_PROJECT_FIXTURES = frozenset({"spdx-adversarial", "analysis"})


def fixture_names() -> list[str]:
    """Every project fixture directory, sorted — the reference's
    `fixtures` helper (spec_helper.rb), minus the data-only dirs this
    repo adds."""
    return sorted(
        name
        for name in os.listdir(FIXTURES_DIR)
        if os.path.isdir(os.path.join(FIXTURES_DIR, name))
        and name not in NON_PROJECT_FIXTURES
    )


def fixtures_yml() -> str:
    """The fixtures.yml golden, regenerated: detect every fixture dir
    with packages+readme on and record key/matcher/hash
    (script/dump-fixture-licenses:1-25).  Emitted in the Ruby YAML.dump
    shape (bare `field:` for nil) with one deliberate simplification:
    always-plain scalars (Psych single-quotes the odd hash its scanner
    finds number-ish; the parsed value is identical, and the shipped
    golden is regenerated BY this function, so bytes match)."""
    import licensee_tpu_torch

    lines = [
        "# Map of fixtures to expectation as an added integration test",
        "---",
    ]
    for name in fixture_names():
        project = licensee_tpu_torch.project(
            os.path.join(FIXTURES_DIR, name),
            detect_packages=True,
            detect_readme=True,
        )
        key = project.license.key if project.license else None
        matcher = None
        hash_ = None
        if project.license_file:
            hash_ = project.license_file.content_hash
            m = project.license_file.matcher
            if m is not None and m.name:
                matcher = str(m.name)
        lines.append(f"{name}:")
        for field, value in (
            ("key", key), ("matcher", matcher), ("hash", hash_),
        ):
            lines.append(f"  {field}: {value}" if value else f"  {field}:")
    return "\n".join(lines) + "\n"
