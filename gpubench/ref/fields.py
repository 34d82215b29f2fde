"""Substitutable license fields ([year], [fullname], ...).

Parity target: `lib/licensee/license_field.rb`.  Fields are loaded from the
vendored `fields.yml`; ``FIELD_REGEX`` is used both to enumerate fields in a
license body and to excise field tokens from similarity scoring
(`lib/licensee/content_helper.rb:328-331`).
"""

from __future__ import annotations

import functools

from gpubench.ref import vendor_paths
from gpubench.ref import yamlite
from gpubench.ref.rubytext import rb, union_patterns


class LicenseField:
    def __init__(self, name: str, description: str | None = None):
        self.name = name
        self.description = description

    @property
    def key(self) -> str:
        return self.name

    @property
    def label(self) -> str:
        # reference: license_field.rb:56-58
        return self.key.replace("fullname", "full name", 1).capitalize()

    def __str__(self) -> str:
        return self.label

    def __repr__(self) -> str:
        return f"<LicenseField name={self.name}>"

    def __eq__(self, other) -> bool:
        return isinstance(other, LicenseField) and other.name == self.name

    def __hash__(self) -> int:
        return hash(("LicenseField", self.name))

    @property
    def raw_text(self) -> str:
        return f"[{self.key}]"

    @staticmethod
    @functools.cache
    def all() -> tuple["LicenseField", ...]:
        with open(vendor_paths.FIELDS_YML, encoding="utf-8") as f:
            raw = yamlite.load_sequence_of_mappings(f.read())
        return tuple(
            LicenseField(entry["name"], entry.get("description")) for entry in raw
        )

    @staticmethod
    @functools.cache
    def keys() -> tuple[str, ...]:
        return tuple(f.key for f in LicenseField.all())

    @staticmethod
    def find(key: str) -> "LicenseField | None":
        for f in LicenseField.all():
            if f.key == key:
                return f
        return None

    @staticmethod
    def from_array(keys) -> list["LicenseField"]:
        return [LicenseField.find(k) for k in keys]

    @staticmethod
    def from_content(content: str | None) -> list["LicenseField"]:
        """All fields referenced in a license body, with duplicates, in order
        of appearance (reference: license_field.rb:44-48)."""
        if not content:
            return []
        return LicenseField.from_array(
            m.group(1) for m in field_regex().finditer(content)
        )


@functools.cache
def field_regex():
    """``/\\[(year|fullname|...)\\]/`` (reference: license_field.rb:53)."""
    return rb(r"\[(" + union_patterns(list(LicenseField.keys())) + r")\]")
