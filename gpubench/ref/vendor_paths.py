"""Locations of the vendored license data the reference reads: the
raw files the port reads too (`licensee_tpu_torch/vendor_paths.py`)."""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
VENDOR_DIR = os.path.join(REPO_ROOT, "vendor")

LICENSE_DIR = os.path.join(VENDOR_DIR, "choosealicense.com", "_licenses")
DATA_DIR = os.path.join(VENDOR_DIR, "choosealicense.com", "_data")
SPDX_DIR = os.path.join(VENDOR_DIR, "license-list-XML", "src")

FIELDS_YML = os.path.join(DATA_DIR, "fields.yml")
META_YML = os.path.join(DATA_DIR, "meta.yml")
