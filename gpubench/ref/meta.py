"""License metadata parsed from template YAML front matter.

Parity target: `lib/licensee/license_meta.rb`.  Defaults match
choosealicense.com's collection defaults (featured: false, hidden: true).
The front matter is read by the port's own YAML-subset reader
(`corpus/yamlite.py`), not PyYAML.
"""

from __future__ import annotations

from gpubench.ref import yamlite

MEMBERS = (
    "title",
    "spdx_id",
    "source",
    "description",
    "how",
    "conditions",
    "permissions",
    "limitations",
    "using",
    "featured",
    "hidden",
    "nickname",
    "note",
)

DEFAULTS = {"featured": False, "hidden": True}


class LicenseMeta:
    def __init__(self, values: dict):
        for member in MEMBERS:
            setattr(self, member, values.get(member))

    @classmethod
    def from_yaml(cls, raw_yaml: str | None) -> "LicenseMeta":
        # Front matter arrives with its `---` document markers; the
        # reader takes the first document like Ruby's YAML.safe_load does.
        return cls.from_hash(yamlite.front_matter(raw_yaml))

    @classmethod
    def from_hash(cls, data: dict) -> "LicenseMeta":
        merged = dict(DEFAULTS)
        merged.update(data or {})
        merged["spdx_id"] = merged.pop("spdx-id", None)
        return cls(merged)

    @property
    def source(self):
        """The canonical source URL is derived from the SPDX id (reference:
        license_meta.rb:61-63 overrides the YAML `source` field)."""
        if self.spdx_id:
            return f"https://spdx.org/licenses/{self.spdx_id}.html"
        return None

    @source.setter
    def source(self, value):
        self._raw_source = value

    @property
    def featured_q(self) -> bool:
        return bool(self.featured)

    @property
    def hidden_q(self) -> bool:
        return bool(self.hidden)

    def __getitem__(self, key):
        if key == "spdx-id":
            key = "spdx_id"
        return getattr(self, key, None)

    def get(self, key, default=None):
        value = self[key]
        return default if value is None else value

    def to_h(self) -> dict:
        # reference: license_meta.rb HASH_METHODS = members - excluded
        excluded = {"conditions", "permissions", "limitations", "spdx_id"}
        return {m: getattr(self, m) for m in MEMBERS if m not in excluded}
