"""Locations of the vendored license corpus data.

Mirrors the data layout consumed by the reference (see
`lib/licensee/license.rb:58-68` and `lib/licensee/rule.rb:40-43`):
choosealicense.com license templates + rules/fields metadata, and the SPDX
license-list-XML sources used for <alt> segment counting.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VENDOR_DIR = os.path.join(REPO_ROOT, "vendor")

LICENSE_DIR = os.path.join(VENDOR_DIR, "choosealicense.com", "_licenses")
DATA_DIR = os.path.join(VENDOR_DIR, "choosealicense.com", "_data")
SPDX_DIR = os.path.join(VENDOR_DIR, "license-list-XML", "src")

RULES_YML = os.path.join(DATA_DIR, "rules.yml")
FIELDS_YML = os.path.join(DATA_DIR, "fields.yml")
META_YML = os.path.join(DATA_DIR, "meta.yml")
