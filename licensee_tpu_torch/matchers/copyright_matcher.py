"""Copyright-only file matcher (parity: `lib/licensee/matchers/copyright.rb`).

A file whose entire content is copyright notice lines (optionally with
"Reserved Font Name" continuation lines) is classified as `no-license`.
Operates on raw content, not normalized content.
"""

from __future__ import annotations

from licensee_tpu_torch.matchers.base import Matcher
from licensee_tpu_torch.normalize.pipeline import COPYRIGHT_FULL_REGEX, COPYRIGHT_REGEX
from licensee_tpu_torch.rubytext import ruby_strip

# Re-exported for the attribution extractor (license_file) and the
# normalization engine's strip_copyright pass.
REGEX = COPYRIGHT_REGEX


class Copyright(Matcher):
    @property
    def match(self):
        from licensee_tpu_torch.corpus.license import License

        content = self.file.content
        if content is None:
            return None
        if COPYRIGHT_FULL_REGEX.search(ruby_strip(content)):
            return License.find("no-license")
        return None

    @property
    def confidence(self) -> float:
        return 100
