"""README files: extract the "## License" section and match it.

Parity target: `lib/licensee/project_files/readme_file.rb`, as
`licensee_tpu/project_files/readme_file.py` carries it: filename scores
and the header lookbehind/lookahead content regex (markdown `#`, rdoc
`=`, and underlined headers).  `license_content` runs the regex's two
halves as two linear scans behind a `licen` substring check, which gives
the one-shot `CONTENT_REGEX`'s section (the JAX package's tests pin the
two forms to each other).  `ReadmeFile`'s chain is the license file's
with the Reference matcher appended; the batch path runs that fallback
in `kernels/batch.py` after Dice.
"""

from __future__ import annotations

from licensee_tpu_torch.project_files.license_file import LicenseFile
from licensee_tpu_torch.rubytext import rb, ruby_strip

EXTENSIONS = ("md", "markdown", "mdown", "txt", "rdoc", "rst")

_SCORES = [
    (rb(r"\AREADME\Z", i=True), 1.0),
    (rb(r"\AREADME\.(?:" + "|".join(EXTENSIONS) + r")\Z", i=True), 0.9),
]

_TITLE = r"licen[sc]e:?"
_UNDERLINE = r"\n[-=]+"

# the two halves of the section extraction, shared by the one-shot
# CONTENT_REGEX (the Ruby-parity form) and the staged scans below
_HEADING_SRC = (
    r"(?:[\#=]+\s" + _TITLE + r"\s*[\#=]*|" + _TITLE + _UNDERLINE + r")"
)
_NEXT_SRC = r"(?:[\#=]+|[^\n]+" + _UNDERLINE + r")"

CONTENT_REGEX = rb(
    r"^" + _HEADING_SRC + r"$"
    r"(.*?)"
    r"(?=^" + _NEXT_SRC + r"|\Z)",
    i=True,
    m=True,
)

# re.search stops at the FIRST heading, where `(.*?)(?=NEXT|\Z)` always
# succeeds and stops at the first NEXT after it (or the end): the section
# is content[heading.end() : next.start() or len]
_HEADING_REGEX = rb(r"^" + _HEADING_SRC + r"$", i=True)
_NEXT_SECTION_REGEX = rb(r"^" + _NEXT_SRC, i=True)


class ReadmeFile(LicenseFile):
    @property
    def possible_matchers(self) -> list:
        from licensee_tpu_torch.matchers import Reference

        return super().possible_matchers + [Reference]

    @staticmethod
    def name_score(filename: str) -> float:
        for pattern, score in _SCORES:
            if pattern.search(filename):
                return score
        return 0.0

    @staticmethod
    def license_content(content: str | None) -> str | None:
        if content is None:
            return None
        if "licen" not in content.lower():
            # every heading the regex accepts contains licen[sc]e
            return None
        m = _HEADING_REGEX.search(content)
        if m is None:
            return None
        nxt = _NEXT_SECTION_REGEX.search(content, m.end())
        section = content[m.end() : nxt.start() if nxt else len(content)]
        return ruby_strip(section)
