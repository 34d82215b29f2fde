"""License rules (permissions / conditions / limitations).

Parity target: `lib/licensee/rule.rb` and `lib/licensee/license_rules.rb`.
Rules are loaded from the vendored `rules.yml` (read by the port's
`corpus/yamlite.py`) and resolved against a license's meta tags.
"""

from __future__ import annotations

import functools

from licensee_tpu_torch import vendor_paths
from licensee_tpu_torch.corpus import yamlite


class Rule:
    def __init__(self, tag=None, label=None, description=None, group=None):
        self.tag = tag
        self.label = label
        self.description = description
        self.group = group

    def __repr__(self) -> str:
        return f'<Rule @tag="{self.tag}">'

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Rule)
            and other.tag == self.tag
            and other.group == self.group
        )

    def __hash__(self) -> int:
        return hash(("Rule", self.tag, self.group))

    def to_h(self) -> dict:
        return {"tag": self.tag, "label": self.label, "description": self.description}

    @staticmethod
    @functools.cache
    def raw_rules() -> dict:
        with open(vendor_paths.RULES_YML, encoding="utf-8") as f:
            return yamlite.load_document(f.read())

    @staticmethod
    @functools.cache
    def all() -> tuple["Rule", ...]:
        out = []
        for group, rules in Rule.raw_rules().items():
            for rule in rules:
                out.append(
                    Rule(
                        tag=rule.get("tag"),
                        label=rule.get("label"),
                        description=rule.get("description"),
                        group=group,
                    )
                )
        return tuple(out)

    @staticmethod
    def find_by_tag_and_group(tag: str, group: str | None = None) -> "Rule | None":
        for rule in Rule.all():
            if rule.tag == tag and (group is None or rule.group == group):
                return rule
        return None

    find_by_tag = find_by_tag_and_group

    @staticmethod
    def groups() -> list[str]:
        return list(Rule.raw_rules().keys())


class LicenseRules:
    def __init__(self, mapping: dict[str, list[Rule]]):
        self._mapping = {group: list(rules) for group, rules in mapping.items()}

    @classmethod
    def from_license(cls, license) -> "LicenseRules":
        return cls.from_meta(license.meta)

    @classmethod
    def from_meta(cls, meta) -> "LicenseRules":
        rules = {}
        for group in Rule.groups():
            tags = meta[group] or []
            rules[group] = [Rule.find_by_tag_and_group(tag, group) for tag in tags]
        return cls(rules)

    def __getitem__(self, group):
        return self._mapping.get(group)

    def __getattr__(self, name):
        mapping = object.__getattribute__(self, "_mapping")
        if name in mapping:
            return mapping[name]
        raise AttributeError(name)

    def flatten(self) -> list[Rule]:
        out = []
        for group in self._mapping.values():
            out.extend(group)
        return out

    def key_q(self, key: str) -> bool:
        return key in self._mapping

    has_key = key_q
    __contains__ = key_q

    def to_h(self) -> dict:
        return {
            group: [r.to_h() for r in rules] for group, rules in self._mapping.items()
        }
