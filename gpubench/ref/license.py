"""The License model: vendored templates + pseudo-licenses.

Parity target: `lib/licensee/license.rb`.  Loads the 47 vendored
choosealicense templates plus the `other` / `no-license` pseudo-licenses
(49 keys total), synthesizes per-license title regexes, and exposes
the corpus-wide title regex used by the normalization engine's title strip.

The benchmark's frozen copy of the port's `corpus/license.py`, cut to
what the plain reference reads: the templates, their metadata and the
corpus-wide title regex of the normalization's title strip.
"""

from __future__ import annotations

import functools
import glob
import os
import re

from gpubench.ref import vendor_paths
from gpubench.ref.meta import LicenseMeta
from gpubench.ref.normalize import NormalizedContent
from gpubench.ref.rubytext import rb, regexp_escape

DOMAIN = "http://choosealicense.com"


class InvalidLicense(ValueError):
    pass


# license.rb:92: placeholders with no content
PSEUDO_LICENSES = ("other", "no-license")

# license.rb:95-99
DEFAULT_OPTIONS = {"hidden": False, "featured": None, "pseudo": True}

# license.rb:101-104: the http(s)/www prefix and the suffixes a source URL
# may carry in a README
SOURCE_PREFIX = r"https?://(?:www\.)?"
SOURCE_SUFFIX = r"(?:\.html?|\.txt|/)(?:\?[^\s]*)?"

_FRONT_MATTER = re.compile(r"\A(---\n.*\n---\n+)?(.*)", re.S)


class License(NormalizedContent):
    def __init__(self, key: str):
        self.key = key.lower()

    # -- class-level corpus access (license.rb:20-78) --

    @staticmethod
    def license_dir() -> str:
        return vendor_paths.LICENSE_DIR

    @staticmethod
    def spdx_dir() -> str:
        return vendor_paths.SPDX_DIR

    @staticmethod
    @functools.cache
    def license_files() -> tuple[str, ...]:
        return tuple(sorted(glob.glob(os.path.join(License.license_dir(), "*.txt"))))

    @staticmethod
    @functools.cache
    def keys() -> tuple[str, ...]:
        return tuple(
            os.path.basename(f)[: -len(".txt")].lower() for f in License.license_files()
        ) + PSEUDO_LICENSES

    @staticmethod
    @functools.cache
    def _licenses() -> tuple["License", ...]:
        return tuple(License(key) for key in License.keys())

    @staticmethod
    def all(hidden: bool = False, featured: bool | None = None, pseudo: bool | None = None, psuedo: bool | None = None) -> list["License"]:
        """All licenses, filtered (license.rb:20-36).  ``psuedo`` is the
        reference's historical misspelling, honored for parity."""
        if pseudo is None:
            pseudo = psuedo if psuedo is not None else DEFAULT_OPTIONS["pseudo"]
        out = [lic for lic in License._licenses() if hidden or not lic.hidden_q]
        if not pseudo:
            out = [lic for lic in out if not lic.pseudo_license]
        out.sort(key=lambda lic: lic.key)
        if featured is not None:
            out = [lic for lic in out if lic.featured_q == featured]
        return out

    @staticmethod
    def find(key: str, hidden: bool = True, **options) -> "License | None":
        options["hidden"] = hidden
        for lic in License.all(**options):
            if lic.key == key.lower():
                return lic
        return None

    find_by_key = find

    @staticmethod
    def find_by_title(title: str) -> "License | None":
        for lic in License.all(hidden=True, pseudo=False):
            pattern = rb(
                r"\A(the )?(?:" + lic.title_regex_pattern + r")( license)?\Z", i=True
            )
            if pattern.match(title):
                return lic
        return None

    # -- metadata --

    @property
    def path(self) -> str:
        return os.path.join(License.license_dir(), f"{self.key}.txt")

    @property
    def meta(self) -> LicenseMeta:
        cached = self.__dict__.get("_meta")
        if cached is None:
            cached = LicenseMeta.from_yaml(self._yaml())
            self.__dict__["_meta"] = cached
        return cached

    @property
    def spdx_id(self) -> str | None:
        if self.meta.spdx_id:
            return self.meta.spdx_id
        if self.key == "other":
            return "NOASSERTION"
        if self.key == "no-license":
            return "NONE"
        return None

    @property
    def title(self):
        return self.meta.title

    @property
    def nickname(self):
        return self.meta.nickname

    @property
    def description(self):
        return self.meta.description

    @property
    def conditions(self):
        return self.meta.conditions

    @property
    def permissions(self):
        return self.meta.permissions

    @property
    def limitations(self):
        return self.meta.limitations

    @property
    def featured_q(self) -> bool:
        return self.meta.featured_q

    @property
    def hidden_q(self) -> bool:
        return self.meta.hidden_q

    @property
    def name(self) -> str:
        # license.rb:134-138
        if self.pseudo_license:
            return self.key.replace("-", " ").capitalize()
        return self.title or self.spdx_id

    @property
    def name_without_version(self) -> str:
        return re.match(r"(.+?)(( v?\d\.\d)|$)", self.name).group(1)

    # -- regex synthesis (license.rb:144-194) --

    @property
    def title_regex_pattern(self) -> str:
        """Pattern string matching this license's title and key variants.

        Reproduces license.rb:144-175: a union of (1) the raw lowercase name,
        (2) the escaped name with optional 'the'/'license'/version spellings,
        (3) the key with flexible separator, and (4) the nickname (the only
        case-sensitive member, per Regexp.new without /i)."""
        cached = self.__dict__.get("_title_regex_pattern")
        if cached is not None:
            return cached

        string = self.name.lower().replace("*", "u", 1)
        simple = string

        string = re.sub(r"\Athe ", "", string, count=1, flags=re.I)
        string = re.sub(r",? version ", " ", string, count=1)
        string = re.sub(r"v(\d+\.\d+)", r"\1", string, count=1)
        string = regexp_escape(string)
        string = re.sub(
            r"\\ licen[sc]e",
            lambda _m: r"(?:\ licen[sc]e)?",
            string,
            count=1,
            flags=re.I,
        )
        version_match = re.search(r"\d+\\.(\d+)", string)
        if version_match:
            minor_is_zero = version_match.group(1) == "0"

            def _vsub(m):
                prefix = r",?\s+(?:version\ |v(?:\. )?)?"
                if minor_is_zero:
                    return prefix + m.group(1) + "(" + m.group(2) + ")?"
                return prefix + m.group(1) + m.group(2)

            string = re.sub(r"\\ (\d+)(\\\.\d+)", _vsub, string, count=1)
        string = re.sub(r"\bgnu\\ ", "(?:GNU )?", string, count=1)
        title = string

        key = self.key.replace("-", "[- ]", 1)
        key = key.replace(".", r"\.", 1)
        key += r"(?:\ licen[sc]e)?"

        parts = [f"(?i:{simple})", f"(?i:{title})", f"(?i:{key})"]
        if self.meta.nickname:
            nick = re.sub(r"\bGNU ", "(?:GNU )?", self.meta.nickname, count=1, flags=re.I)
            parts.append(f"(?:{nick})")
        cached = "|".join(parts)
        self.__dict__["_title_regex_pattern"] = cached
        return cached

    @property
    def title_regex(self) -> re.Pattern:
        return rb(self.title_regex_pattern)

    @property
    def source_regex_pattern(self) -> str | None:
        """Pattern matching the license source URL with http(s)/www/suffix
        variations (license.rb:185-194)."""
        if not self.meta.source:
            return None
        source = re.sub(r"\A" + SOURCE_PREFIX, "", self.meta.source, count=1, flags=re.I)
        source = re.sub(SOURCE_SUFFIX + r"\Z", "", source, count=1, flags=re.I)
        return f"(?i:{SOURCE_PREFIX}{regexp_escape(source)}(?:{SOURCE_SUFFIX})?)"

    @property
    def source_regex(self) -> re.Pattern | None:
        pattern = self.source_regex_pattern
        return rb(pattern) if pattern else None

    @property
    def reference_regex(self) -> re.Pattern:
        """The compiled title|source union the Reference matcher scans a
        README section with (reference.rb:9-13), compiled once per
        License."""
        cached = self.__dict__.get("_reference_regex")
        if cached is None:
            parts = [self.title_regex_pattern]
            source = self.source_regex_pattern
            if source:
                parts.append(source)
            cached = rb(r"\b(?:" + "|".join(parts) + r")\b")
            self.__dict__["_reference_regex"] = cached
        return cached

    # -- predicates (license.rb:196-231) --

    @property
    def other_q(self) -> bool:
        return self.key == "other"

    @property
    def gpl_q(self) -> bool:
        return self.key in ("gpl-2.0", "gpl-3.0")

    @property
    def lgpl_q(self) -> bool:
        return self.key in ("lgpl-2.1", "lgpl-3.0")

    @property
    def creative_commons_q(self) -> bool:
        return self.key.startswith("cc-")

    cc_q = creative_commons_q

    @property
    def pseudo_license(self) -> bool:
        return self.key in PSEUDO_LICENSES

    # -- content (license.rb:215-283) --

    @property
    def content(self) -> str | None:
        parts = self._parts()
        return parts[1] if parts and parts[1] else None

    @property
    def url(self) -> str:
        return f"{DOMAIN}/licenses/{self.key}/"

    @property
    def spdx_alt_segments(self) -> int:
        """Count of <alt> substitution segments in the vendored SPDX XML for
        this license, after removing copyright/title/optional blocks
        (license.rb:273-283).  Feeds the length-delta adjustment."""
        cached = self.__dict__.get("_spdx_alt_segments")
        if cached is None:
            path = os.path.join(License.spdx_dir(), f"{self.spdx_id}.xml")
            with open(path, encoding="utf-8") as f:
                raw_xml = f.read()
            text = re.search(r"<text>(.*)</text>", raw_xml, re.S).group(1)
            text = re.sub(r"<copyrightText>.*?</copyrightText>", "", text, flags=re.S)
            text = re.sub(r"<titleText>.*?</titleText>", "", text, flags=re.S)
            text = re.sub(r"<optional.*?>.*?</optional>", "", text, flags=re.S)
            cached = len(re.findall(r"<alt .*?>", text, re.S))
            self.__dict__["_spdx_alt_segments"] = cached
        return cached

    def _raw_content(self) -> str | None:
        if self.pseudo_license:
            return None
        cached = self.__dict__.get("_raw")
        if cached is None:
            if not os.path.exists(self.path):
                raise InvalidLicense(f"'{self.key}' is not a valid license key")
            with open(self.path, encoding="utf-8") as f:
                cached = f.read()
            self.__dict__["_raw"] = cached
        return cached

    def _parts(self) -> tuple[str | None, str | None] | None:
        raw = self._raw_content()
        if raw is None:
            return None
        m = _FRONT_MATTER.match(raw)
        return (m.group(1), m.group(2))

    def _yaml(self) -> str | None:
        parts = self._parts()
        return parts[0] if parts else None

    # -- dunder / serialization --

    def __eq__(self, other) -> bool:
        return isinstance(other, License) and self.key == other.key

    def __hash__(self) -> int:
        return hash(("License", self.key))

    def __repr__(self) -> str:
        return f"<License key={self.key}>"

    def __str__(self) -> str:
        return self.content or ""



@functools.cache
def global_title_parts() -> tuple[str, ...]:
    """The alternatives of the corpus-wide title union, in union order.

    Used by :func:`global_title_regex`."""
    licenses = License.all(hidden=True, pseudo=False)
    parts = [lic.title_regex_pattern for lic in licenses]
    for lic in licenses:
        if lic.title != lic.name_without_version:
            parts.append(f"(?i:{regexp_escape(lic.name_without_version)})")
    return tuple(parts)


@functools.cache
def global_title_regex() -> re.Pattern:
    """The corpus-wide title-strip regex (content_helper.rb:199-215):
    any license title (or unversioned name), optionally parenthesized or
    preceded by 'the', through end of line."""
    union = "|".join(global_title_parts())
    return rb(r"\A\s*\(?(?:the )?(?:" + union + r").*?$", i=True)
