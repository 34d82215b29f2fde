"""The plain reference of the license chain, as the benchmark judges it.

Licensee's license-mode verdict for one blob (`project_file.rb`,
`matchers/copyright.rb`, `matchers/exact.rb`, `matchers/dice.rb`,
`content_helper.rb:128-133, 337-347`), worked out from the raw bytes
with NumPy and the frozen normalization beside this file: sanitize,
the Copyright prefilter, the Exact prefilter (wordset equality), then
Dice over every template: the overlap of 0/1 word vectors, the integer
score algebra, the exact first-max over templates and the threshold,
and the confidence finished in float64.  It imports nothing of the
port and takes nothing the port made: the templates come from the raw
vendored files (or an SPDX directory) through the frozen copies here.

``precision`` is the control's knob: ``np.float32`` finishes the
confidence one precision below the configuration's float64.
"""

from __future__ import annotations

import numpy as np

from gpubench.ref.normalize import COPYRIGHT_FULL_REGEX, NormalizedContent
from gpubench.ref.rubytext import rb, ruby_strip

# license_file.rb:56-58 (the CC false-positive guard of the Dice matcher)
CC_FALSE_POSITIVE_REGEX = rb(
    r"^(creative\ commons\ )?Attribution-(NonCommercial|NoDerivatives)",
    i=True,
    x=True,
)

# git_project.rb:53: blobs past 64 KiB are skipped, never scored
MAX_LICENSE_SIZE = 64 * 1024


def sanitize(raw: bytes | str) -> str:
    """UTF-8 with invalid bytes dropped, universal newlines
    (project_file.rb:37-45)."""
    if isinstance(raw, bytes):
        text = raw.decode("utf-8", errors="ignore")
    else:
        text = raw.encode("utf-8", errors="ignore").decode(
            "utf-8", errors="ignore"
        )
    return text.replace("\r\n", "\n").replace("\r", "\n")


class Blob(NormalizedContent):
    """A candidate file's content through the frozen normalization; a
    name ending in .html or .htm converts it to markdown first
    (content_helper.rb:293-299)."""

    def __init__(self, content: str, filename: str | None = None):
        self.content = content
        self.filename = filename


class Verdict(tuple):
    """(key, matcher, confidence, error) of one row."""

    __slots__ = ()

    def __new__(cls, key, matcher, confidence, error=None):
        return super().__new__(cls, (key, matcher, confidence, error))


NO_MATCH = Verdict(None, None, 0.0)


class Reference:
    """The license chain over one template pool.

    ``templates``: License-like objects in the pool's order (key,
    wordset, wordset_fieldless, fields_normalized, length,
    spdx_alt_segments, creative_commons_q)."""

    def __init__(self, templates, threshold: float = 98.0,
                 precision=np.float64):
        pool = [t for t in templates if t.wordset is not None]
        self.keys = [t.key for t in pool]
        self.threshold = threshold
        self.precision = precision
        words = sorted({w for t in pool for w in t.wordset_fieldless})
        self.vocab = {w: i for i, w in enumerate(words)}
        T, V = len(pool), len(words)
        self.tpl = np.zeros((T, V), dtype=np.float64)
        for t, lic in enumerate(pool):
            self.tpl[t, [self.vocab[w] for w in lic.wordset_fieldless]] = 1.0
        self.n_wf = np.array([len(t.wordset_fieldless) for t in pool],
                             dtype=np.int64)
        self.n_fieldset = np.array(
            [len(t.fields_normalized_set) for t in pool], dtype=np.int64)
        self.slack = np.array(
            [5 * max(len(t.fields_normalized), t.spdx_alt_segments)
             for t in pool], dtype=np.int64)
        self.length = np.array([t.length for t in pool], dtype=np.int64)
        self.cc = np.array([t.creative_commons_q for t in pool], dtype=bool)
        # matchers/exact.rb: the first template (in pool order) whose full
        # wordset equals the blob's
        self.exact: dict = {}
        for lic in pool:
            self.exact.setdefault(frozenset(lic.wordset), lic.key)

    def verdicts(self, raws: list, filenames: list) -> list[Verdict]:
        """The verdict of each raw blob (bytes, or None for a path that
        could not be read) under its file name."""
        out: list = [None] * len(raws)
        dice_rows, feats = [], []
        for i, (raw, filename) in enumerate(zip(raws, filenames)):
            if raw is None:
                out[i] = Verdict(None, None, 0.0, "read_error")
                continue
            if len(raw) > MAX_LICENSE_SIZE:
                out[i] = Verdict(None, None, 0.0, "oversized")
                continue
            content = sanitize(raw)
            stripped = ruby_strip(content)
            if COPYRIGHT_FULL_REGEX.search(stripped):
                out[i] = Verdict("no-license", "copyright", 100.0)
                continue
            blob = Blob(content, filename)
            wordset = blob.wordset or frozenset()
            key = self.exact.get(wordset)
            if key is not None:
                out[i] = Verdict(key, "exact", 100.0)
                continue
            dice_rows.append(i)
            feats.append((wordset, blob.length,
                          bool(CC_FALSE_POSITIVE_REGEX.search(stripped))))
        for i, verdict in zip(dice_rows, self._dice(feats)):
            out[i] = verdict
        return out

    def _dice(self, feats: list) -> list[Verdict]:
        """The Dice matcher over every template, in blocks of rows."""
        verdicts: list = []
        for s in range(0, len(feats), 256):
            block = feats[s:s + 256]
            vec = np.zeros((len(block), self.tpl.shape[1]), dtype=np.float64)
            for r, (wordset, _length, _cc) in enumerate(block):
                ids = [self.vocab[w] for w in wordset if w in self.vocab]
                vec[r, ids] = 1.0
            # exact: every sum is an integer far below 2^53
            overlap = (vec @ self.tpl.T).astype(np.int64)
            n_words = np.array([len(f[0]) for f in block], dtype=np.int64)
            length = np.array([f[1] for f in block], dtype=np.int64)
            cc_fp = np.array([f[2] for f in block], dtype=bool)
            delta = np.abs(self.length[None, :] - length[:, None])
            adj = np.maximum(delta - self.slack[None, :], 0)
            denom = (self.n_wf[None, :] + n_words[:, None]
                     - self.n_fieldset[None, :] + adj // 4)
            excluded = self.cc[None, :] & cc_fp[:, None]
            num = np.where(excluded, -1, overlap)
            den = np.where(excluded | (denom <= 0), 1, denom)
            for r in range(len(block)):
                verdicts.append(self._best(num[r], den[r]))
        return verdicts

    def _best(self, num, den) -> Verdict:
        """The exact first-max of num/den over the templates, then the
        float finish and the threshold (dice.rb:57-59)."""
        best = 0
        for t in range(1, len(num)):
            if int(num[t]) * int(den[best]) > int(num[best]) * int(den[t]):
                best = t
        n, d = int(num[best]), int(den[best])
        if n < 0:
            return NO_MATCH
        f = self.precision
        score = float(f(n) * f(200.0) / f(d))
        if score < self.threshold:
            return NO_MATCH
        return Verdict(self.keys[best], "dice", score)
