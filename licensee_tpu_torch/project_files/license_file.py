"""LICENSE-style files: filename scoring + Copyright/Exact/Dice chain.

Parity target: `lib/licensee/project_files/license_file.rb`, as
`licensee_tpu/project_files/license_file.py` carries it: the 19-entry
ordered filename score table (what ``--mode auto`` routes by), the CC
false-positive guard, the copyright? filename gate, attribution
extraction, and the unmatched-but-scored -> `other` fallback.
"""

from __future__ import annotations

from licensee_tpu_torch.normalize.pipeline import COPYRIGHT_REGEX, NormalizedContent
from licensee_tpu_torch.project_files.project_file import ProjectFile
from licensee_tpu_torch.rubytext import rb, ruby_strip

# license_file.rb:8-30 filename building blocks
PREFERRED_EXT = ("md", "markdown", "txt", "html")
PREFERRED_EXT_REGEX = r"\.(?:" + "|".join(PREFERRED_EXT) + r")\Z"
LICENSE_EXT_REGEX = r"\.(?!spdx|header)(?:[^./]|\.\d)+\Z"
OTHER_EXT_REGEX = r"\.(?!xml|go|gemspec)(?:[^./]|\.\d)+\Z"
ANY_EXT_REGEX = r"\.(?:[^./]|\.\d)+\Z"
LICENSE_REGEX = r"(?:un)?licen[sc]e"
COPYING_REGEX = r"copying"
COPYRIGHT_FILE_REGEX = r"copyright"
OFL_REGEX = r"ofl"
PATENTS_REGEX = r"patents"

# license_file.rb:38-59: ordered filename -> score table (first match wins)
FILENAME_SCORES = [
    (rb(r"\A" + LICENSE_REGEX + r"\Z", i=True), 1.00),                              # LICENSE
    (rb(r"\A" + LICENSE_REGEX + PREFERRED_EXT_REGEX, i=True), 0.95),                # LICENSE.md
    (rb(r"\A" + COPYING_REGEX + r"\Z", i=True), 0.90),                              # COPYING
    (rb(r"\A" + COPYING_REGEX + PREFERRED_EXT_REGEX, i=True), 0.85),                # COPYING.md
    (rb(r"\A" + LICENSE_REGEX + LICENSE_EXT_REGEX, i=True), 0.80),                  # LICENSE.textile
    (rb(r"\A" + COPYING_REGEX + ANY_EXT_REGEX, i=True), 0.75),                      # COPYING.textile
    (rb(r"\A" + LICENSE_REGEX + r"[-_][^.]*(?:" + OTHER_EXT_REGEX + r")?\Z", i=True), 0.70),  # LICENSE-MIT
    (rb(r"\A" + COPYING_REGEX + r"[-_][^.]*(?:" + OTHER_EXT_REGEX + r")?\Z", i=True), 0.65),  # COPYING-MIT
    (rb(r"\A\w+[-_]" + LICENSE_REGEX + r"[^.]*(?:" + OTHER_EXT_REGEX + r")?\Z", i=True), 0.60),  # MIT-LICENSE-MIT
    (rb(r"\A\w+[-_]" + COPYING_REGEX + r"[^.]*(?:" + OTHER_EXT_REGEX + r")?\Z", i=True), 0.55),  # MIT-COPYING
    (rb(r"\A" + OFL_REGEX + PREFERRED_EXT_REGEX, i=True), 0.50),                    # OFL.md
    (rb(r"\A" + OFL_REGEX + OTHER_EXT_REGEX, i=True), 0.45),                        # OFL.textile
    (rb(r"\A" + OFL_REGEX + r"\Z", i=True), 0.40),                                  # OFL
    (rb(r"\A" + COPYRIGHT_FILE_REGEX + r"\Z", i=True), 0.35),                       # COPYRIGHT
    (rb(r"\A" + COPYRIGHT_FILE_REGEX + PREFERRED_EXT_REGEX, i=True), 0.30),         # COPYRIGHT.txt
    (rb(r"\A" + COPYRIGHT_FILE_REGEX + OTHER_EXT_REGEX, i=True), 0.25),             # COPYRIGHT.textile
    (rb(r"\A" + COPYRIGHT_FILE_REGEX + r"[-_][^.]*(?:" + OTHER_EXT_REGEX + r")?\Z", i=True), 0.20),  # COPYRIGHT-MIT
    (rb(r"\A" + PATENTS_REGEX + r"\Z", i=True), 0.15),                              # PATENTS
    (rb(r"\A" + PATENTS_REGEX + OTHER_EXT_REGEX, i=True), 0.10),                    # PATENTS.txt
    (rb(r""), 0.00),                                                               # catch-all
]

# the copyright? filename test (project_file.rb:94): a COPYRIGHT(.ext)
# file — ProjectFile.is_copyright, the batch attribution gate and the
# dedupe key use it
COPYRIGHT_NAME_REGEX = rb(
    r"\Acopyright(?:" + OTHER_EXT_REGEX + r")?\Z", i=True
)

# license_file.rb:61-65: CC-NC / CC-ND must not be detected as CC-BY(-SA)
CC_FALSE_POSITIVE_REGEX = rb(
    r"^(creative\ commons\ )?Attribution-(NonCommercial|NoDerivatives)", i=True, x=True
)


class LicenseFile(NormalizedContent, ProjectFile):
    @property
    def possible_matchers(self) -> list:
        from licensee_tpu_torch.matchers import Copyright, Dice, Exact

        return [Copyright, Exact, Dice]

    @property
    def attribution(self) -> str | None:
        """The copyright/attribution line, when the matched license carries a
        [fullname] field (license_file.rb:71-77)."""
        cached = self.__dict__.get("_attribution")
        if cached is None:
            cached = None
            license = self.license
            applicable = self.is_copyright or (
                license is not None
                and license.content is not None
                and "[fullname]" in license.content
            )
            if applicable:
                m = COPYRIGHT_REGEX.search(self.content_without_title_and_version)
                cached = m.group(0) if m else None
            self.__dict__["_attribution"] = cached
        return cached

    @property
    def potential_false_positive(self) -> bool:
        return bool(CC_FALSE_POSITIVE_REGEX.search(ruby_strip(self.content or "")))

    @property
    def is_lgpl(self) -> bool:
        return LicenseFile.lesser_gpl_score(self.filename) == 1 and bool(
            self.license and self.license.lgpl_q
        )

    @property
    def is_gpl(self) -> bool:
        return bool(self.license and self.license.gpl_q)

    @property
    def license(self):
        """A scored license file that fails all matchers is still 'other' —
        it looked like a license but we couldn't identify it
        (license_file.rb:92-98)."""
        from licensee_tpu_torch.corpus.license import License

        if self.matcher and self.matcher.match:
            return self.matcher.match
        return License.find("other")

    def _serialized_content_normalized(self):
        return self.content_normalized()

    @staticmethod
    def name_score(filename: str) -> float:
        for regex, score in FILENAME_SCORES:
            if regex.search(filename):
                return score
        return 0.0

    @staticmethod
    def lesser_gpl_score(filename: str | None) -> int:
        """COPYING.lesser gets LGPL priority (license_file.rb:105-107)."""
        return 1 if filename is not None and filename.lower() == "copying.lesser" else 0
