"""Package-manager metadata matchers.

Parity targets: `lib/licensee/matchers/{package,gemspec,npm_bower,cabal,
cargo,cran,dist_zilla,nuget,spdx}.rb`.  Each extracts a declared license
key from package metadata with a lenient regex (the reference deliberately
prefers regexes over full parsers "for speed and security") and maps it to
a License, falling back to `other` for declared-but-unknown licenses.
"""

from __future__ import annotations

import re

from licensee_tpu_torch.matchers.base import Matcher
from licensee_tpu_torch.rubytext import rb

_UNSET = object()


class Package(Matcher):
    @property
    def match(self):
        cached = self.__dict__.get("_match", _UNSET)
        if cached is _UNSET:
            from licensee_tpu_torch.corpus.license import License

            cached = None
            prop = self.license_property
            if prop:
                for lic in License.all(hidden=True):
                    if lic.key == prop:
                        cached = lic
                        break
                else:
                    cached = License.find("other")
            self.__dict__["_match"] = cached
        return cached

    @property
    def confidence(self) -> float:
        return 90

    @property
    def license_property(self) -> str | None:
        raise NotImplementedError


class Gemspec(Package):
    # gemspec.rb:6-18
    _VALUE = r"\s*['\"]([a-z\-0-9.]+)['\"](?:\.freeze)?\s*"
    _ARRAY = r"\s*\[" + _VALUE + r"(?:," + _VALUE + r")*\]\s*"
    LICENSE_REGEX = rb(r"^\s*[a-z0-9_]+\.license\s*=" + _VALUE + r"$", i=True)
    LICENSE_ARRAY_REGEX = rb(r"^\s*[a-z0-9_]+\.licenses\s*=" + _ARRAY + r"$", i=True)

    @property
    def license_property(self) -> str | None:
        m = self.LICENSE_REGEX.search(self.file.content)
        if m and m.group(1):
            return m.group(1).lower()
        licenses = self._license_array_property()
        if licenses is None:
            return None
        if len(licenses) != 1:
            return "other"
        return licenses[0]

    def _license_array_property(self) -> list[str] | None:
        m = self.LICENSE_ARRAY_REGEX.search(self.file.content)
        if not m:
            return None
        return [g.lower() for g in m.groups() if g is not None]


class NpmBower(Package):
    # npm_bower.rb:7-11
    LICENSE_REGEX = rb(r"\s*[\"']license[\"']\s*:\s*['\"]([a-z\-0-9.+ ()]+)['\"],?\s*", i=True)

    @property
    def license_property(self) -> str | None:
        m = self.LICENSE_REGEX.search(self.file.content)
        if not (m and m.group(1)):
            return None
        if m.group(1) == "UNLICENSED":
            return "no-license"
        return m.group(1).lower()


class Cabal(Package):
    # cabal.rb:6-16
    LICENSE_REGEX = rb(r"^\s*license\s*:\s*([a-z\-0-9.]+)\s*$", i=True)
    LICENSE_CONVERSIONS = {
        "GPL-2": "GPL-2.0",
        "GPL-3": "GPL-3.0",
        "LGPL-3": "LGPL-3.0",
        "AGPL-3": "AGPL-3.0",
        "BSD2": "BSD-2-Clause",
        "BSD3": "BSD-3-Clause",
    }

    @property
    def license_property(self) -> str | None:
        m = self.LICENSE_REGEX.search(self.file.content)
        if not (m and m.group(1)):
            return None
        name = self.LICENSE_CONVERSIONS.get(m.group(1), m.group(1))
        return name.lower()


class Cargo(Package):
    # cargo.rb:5-8
    LICENSE_REGEX = rb(r"^\s*['\"]?license['\"]?\s*=\s*['\"]([a-z\-0-9. +()/]+)['\"]\s*", i=True)

    @property
    def license_property(self) -> str | None:
        m = self.LICENSE_REGEX.search(self.file.content)
        return m.group(1).lower() if m and m.group(1) else None


class Cran(Package):
    # cran.rb:8-12
    LICENSE_FIELD_REGEX = rb(r"^license:\s*(.+)", i=True)
    PLUS_FILE_LICENSE_REGEX = rb(r"\s*\+\s*file\s+LICENSE$", i=True)
    GPL_VERSION_REGEX = rb(r"^GPL(?:-([23])|\s*\(\s*>=\s*([23])\s*\))$", i=True)

    @property
    def license_property(self) -> str | None:
        m = self.LICENSE_FIELD_REGEX.search(self.file.content)
        if not m:
            return None
        field = m.group(1).lower()
        key = self.PLUS_FILE_LICENSE_REGEX.sub("", field, count=1)
        gpl = self.GPL_VERSION_REGEX.search(key)
        if gpl:
            return f"gpl-{gpl.group(1) or gpl.group(2)}.0"
        return key


class DistZilla(Package):
    # dist_zilla.rb:8
    LICENSE_REGEX = rb(r"^license\s*=\s*([a-z\-0-9._]+)", i=True)

    @property
    def license_property(self) -> str | None:
        m = self.LICENSE_REGEX.search(self.file.content)
        if not (m and m.group(1)):
            return None
        # Perl module name -> SPDX munging (dist_zilla.rb:17-24)
        name = m.group(1)
        name = name.replace("_", "-", 1)
        name = name.replace("_", ".", 1)
        name = name.replace("Mozilla", "MPL", 1)
        name = re.sub(r"^GPL-(\d)$", r"GPL-\1.0", name, count=1)
        name = re.sub(r"^AGPL-(\d)$", r"AGPL-\1.0", name, count=1)
        return name.lower()


class NuGet(Package):
    # nuget.rb:8-16
    LICENSE_REGEX = rb(
        r"<license\s*type\s*=\s*[\"']expression[\"']\s*>([a-z\-0-9. +()]+)</license\s*>",
        i=True,
    )
    LICENSE_URL_REGEX = rb(r"<licenseUrl>\s*(.*)\s*</licenseUrl>", i=True)
    NUGET_REGEX = rb(r"https?://licenses.nuget.org/(.*)", i=True)
    OPENSOURCE_REGEX = rb(r"https?://(?:www\.)?opensource.org/licenses/(.*)", i=True)
    SPDX_REGEX = rb(r"https?://(?:www\.)?spdx.org/licenses/(.*?)(?:\.html|\.txt)?$", i=True)
    APACHE_REGEX = rb(r"https?://(?:www\.)?apache.org/licenses/(.*?)(?:\.html|\.txt)?$", i=True)

    def _from_capture(self, url: str, pattern) -> str | None:
        m = pattern.search(url)
        return m.group(1).lower() if m and m.group(1) else None

    def _license_from_url(self, url: str) -> str | None:
        for pattern in (self.NUGET_REGEX, self.OPENSOURCE_REGEX, self.SPDX_REGEX):
            found = self._from_capture(url, pattern)
            if found:
                return found
        found = self._from_capture(url, self.APACHE_REGEX)
        return found.replace("license", "apache") if found else None

    @property
    def license_property(self) -> str | None:
        m = self.LICENSE_REGEX.search(self.file.content)
        if m and m.group(1):
            return m.group(1).lower()
        url_match = self.LICENSE_URL_REGEX.search(self.file.content)
        if url_match and url_match.group(1):
            return self._license_from_url(url_match.group(1))
        return None


class Spdx(Package):
    # spdx.rb:8
    LICENSE_REGEX = rb(r"PackageLicenseDeclared:\s*([a-z\-0-9. +()]+)\s*", i=True)

    @property
    def license_property(self) -> str | None:
        m = self.LICENSE_REGEX.search(self.file.content)
        return m.group(1).lower() if m and m.group(1) else None
