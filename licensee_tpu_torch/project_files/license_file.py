"""LICENSE-style file regexes and filename scores the batch chain needs.

Parity target: `lib/licensee/project_files/license_file.rb`, as
`licensee_tpu/project_files/license_file.py` carries it: the 19-entry
ordered filename score table (what ``--mode auto`` routes by), the CC
false-positive guard and the copyright? filename gate.  The per-file
matcher chain of `LicenseFile` waits for the `detect` slice (ROADMAP A).
"""

from __future__ import annotations

from licensee_tpu_torch.rubytext import rb

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
# file — the batch attribution gate and the dedupe key use it
COPYRIGHT_NAME_REGEX = rb(
    r"\Acopyright(?:" + OTHER_EXT_REGEX + r")?\Z", i=True
)

# license_file.rb:61-65: CC-NC / CC-ND must not be detected as CC-BY(-SA)
CC_FALSE_POSITIVE_REGEX = rb(
    r"^(creative\ commons\ )?Attribution-(NonCommercial|NoDerivatives)", i=True, x=True
)


class LicenseFile:
    """The LICENSE-file class of the reference, as far as the batch path
    reads it: its filename score."""

    @staticmethod
    def name_score(filename: str) -> float:
        for regex, score in FILENAME_SCORES:
            if regex.search(filename):
                return score
        return 0.0
