"""The ``{"op": "diff"}`` wire verb: normalized blob vs closest (or
named) template, rendered as an inline word diff.

Re-platforms the reference's ``licensee diff`` semantics
(commands/diff.rb) onto the serving tier: the blob normalizes through
the SAME pipeline the featurizer uses (normalize/pipeline.py — one
normalization, so the diff can never disagree with the verdict about
what the text "is"), the comparison target is either the caller-named
license key or the top Dice-similarity candidate (the effective pool
of commands/detect.rb:97-102), and the rendered diff is the
``[-removed-]{+added+}`` inline word-diff format over 80-column
wrapped normalized text (normalize/worddiff.py)."""

from __future__ import annotations


class UnknownLicenseError(ValueError):
    """The request named a license key the corpus does not know."""


def diff_payload(
    content,
    filename: str | None = None,
    license_key: str | None = None,
    wrap_at: int = 80,
    corpus=None,
) -> dict:
    """The ``"diff"`` response object for one blob.

    ``corpus`` is the worker's LIVE CompiledCorpus (the blue/green
    epoch its verdicts come from): the template pool is fenced to
    licenses whose normalized content is IN that corpus (matched by
    ``content_hashes``, the same evidence the corpus fingerprint
    folds), so a reloaded worker can never render a diff against a
    template its verdicts no longer score — the diff and the verdict
    name the same corpus or the verb refuses.  For the vendored corpus
    the fence is a no-op (every template has local text); templates a
    custom corpus adds have no renderable local text and are simply
    not in the pool.

    Raises :class:`UnknownLicenseError` for a ``license_key`` that is
    unknown (or outside the serving corpus); with no key, diffs
    against the closest in-pool candidate by Dice similarity and
    reports which."""
    from licensee_tpu_torch.corpus.license import License
    from licensee_tpu_torch.matchers.dice import Dice
    from licensee_tpu_torch.normalize.worddiff import word_diff
    from licensee_tpu_torch.project_files.license_file import LicenseFile

    if isinstance(content, bytes):
        content = content.decode("utf-8", errors="replace")
    file = LicenseFile(content, filename or "LICENSE")
    hashes = corpus.content_hashes if corpus is not None else None

    def in_pool(lic) -> bool:
        return hashes is None or hashes.get(lic.content_hash) == lic.key

    if license_key:
        expected = License.find(license_key)
        if expected is None or not in_pool(expected):
            raise UnknownLicenseError(license_key)
    else:
        ranked = Dice(file).matches_by_similarity
        expected = next(
            (lic for lic, _sim in ranked if in_pool(lic)), None
        )
        if expected is None:
            # nothing to compare against (e.g. an empty wordset blob)
            return {
                "key": None,
                "similarity": 0.0,
                "identical": False,
                "diff": None,
            }
    left = expected.content_normalized(wrap_at=wrap_at) or ""
    right = file.content_normalized(wrap_at=wrap_at) or ""
    return {
        "key": expected.key,
        "spdx_id": expected.spdx_id,
        "similarity": round(float(expected.similarity(file)), 4),
        "identical": left == right,
        "input_length": file.length,
        "license_length": expected.length,
        "diff": "" if left == right else word_diff(left, right),
    }
