"""Candidate-file content sanitation.

Parity target: `lib/licensee/project_files/project_file.rb:37-45`, as
`licensee_tpu/project_files/project_file.py` carries it.  The port needs
only the encoding and newline sanitation in this slice; the matcher
chain of `ProjectFile` waits for the `detect` slice (ROADMAP A).
"""

from __future__ import annotations


def sanitize_content(content: str | bytes) -> str:
    """UTF-8 coercion with invalid bytes dropped + universal newlines
    (project_file.rb:37-45)."""
    if isinstance(content, bytes):
        content = content.decode("utf-8", errors="ignore")
    else:
        # Round-trip to drop lone surrogates from earlier lossy decodes
        content = content.encode("utf-8", errors="ignore").decode("utf-8", errors="ignore")
    return content.replace("\r\n", "\n").replace("\r", "\n")
