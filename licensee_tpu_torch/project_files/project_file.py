"""Candidate-file classification unit.

Parity target: `lib/licensee/project_files/project_file.rb`, as
`licensee_tpu/project_files/project_file.py` carries it.  Owns content
and metadata; sanitizes encoding (UTF-8 with invalid sequences dropped,
universal newlines); runs the first-match-wins matcher chain.
"""

from __future__ import annotations

import os
import re

_UNSET = object()


def sanitize_content(content: str | bytes) -> str:
    """UTF-8 coercion with invalid bytes dropped + universal newlines
    (project_file.rb:37-45)."""
    if isinstance(content, bytes):
        content = content.decode("utf-8", errors="ignore")
    else:
        # Round-trip to drop lone surrogates from earlier lossy decodes
        content = content.encode("utf-8", errors="ignore").decode("utf-8", errors="ignore")
    return content.replace("\r\n", "\n").replace("\r", "\n")


class ProjectFile:
    def __init__(self, content: str | bytes | None, metadata=None):
        self.content = sanitize_content(content) if content is not None else None
        if isinstance(metadata, str):
            metadata = {"name": metadata}
        self.data = metadata or {}

    @property
    def filename(self) -> str | None:
        return self.data.get("name")

    path = filename

    @property
    def directory(self) -> str:
        return self.data.get("dir") or "."

    dir = directory

    @property
    def path_relative_to_root(self) -> str:
        return os.path.join(self.directory, self.filename)

    relative_path = path_relative_to_root

    @property
    def possible_matchers(self) -> list:
        raise NotImplementedError

    @property
    def matcher(self):
        """First matcher in the chain that produces a match
        (project_file.rb:65-71)."""
        cached = self.__dict__.get("_matcher", _UNSET)
        if cached is _UNSET:
            cached = None
            for matcher_cls in self.possible_matchers:
                candidate = matcher_cls(self)
                if candidate.match:
                    cached = candidate
                    break
            self.__dict__["_matcher"] = cached
        return cached

    @property
    def confidence(self):
        return self.matcher.confidence if self.matcher else None

    @property
    def license(self):
        return self.matcher.match if self.matcher else None

    match = license

    @property
    def matched_license(self) -> str | None:
        return self.license.spdx_id if self.license else None

    @property
    def is_copyright(self) -> bool:
        """COPYRIGHT file holding only a copyright statement — excluded when
        deciding if a project is multi-licensed (project_file.rb:90-95)."""
        from licensee_tpu_torch.matchers.copyright_matcher import Copyright
        from licensee_tpu_torch.project_files.license_file import (
            COPYRIGHT_NAME_REGEX,
            LicenseFile,
        )

        if not isinstance(self, LicenseFile):
            return False
        if not isinstance(self.matcher, Copyright):
            return False
        return bool(COPYRIGHT_NAME_REGEX.search(self.filename or ""))

    @property
    def content_hash(self):
        return None

    @property
    def attribution(self):
        return None

    def _serialized_content_normalized(self):
        return None

    def to_h(self) -> dict:
        # project_file.rb:16-19 HASH_METHODS
        return {
            "filename": self.filename,
            "content": self.content,
            "content_hash": self.content_hash,
            "content_normalized": self._serialized_content_normalized(),
            "matcher": self.matcher.to_h() if self.matcher else None,
            "matched_license": self.matched_license,
            "attribution": self.attribution,
        }
