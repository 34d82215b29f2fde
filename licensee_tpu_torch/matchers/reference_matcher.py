"""README license-by-reference matcher
(parity: `lib/licensee/matchers/reference.rb`).

Matches a README body that mentions a license by title or by source URL.
"""

from __future__ import annotations

from licensee_tpu_torch.matchers.base import Matcher


class Reference(Matcher):
    @property
    def match(self):
        content = self.file.content
        if content is None:
            return None
        for lic in self.potential_matches:
            # compiled once per License and memoized there; the License
            # pool itself is process-global, so a batch readme scan pays
            # zero re.compile after the first file
            if lic.reference_regex.search(content):
                return lic
        return None

    @property
    def confidence(self) -> float:
        return 90
