"""Corpus compiler: templates -> device-resident scoring constants.

The TPU analog of the reference's lazy `License.all` init
(license.rb:20-36 + content_helper memoization): eagerly normalize and
tokenize every template, build the global vocabulary, and emit the T×W
packed bit-matrix plus per-template score constants as arrays.

Per-template constants (see the similarity algebra in
content_helper.rb:128-133 and 337-347):
  bits        uint32[T, W]  — fieldless wordset as a bit-vector over vocab
  n_wf        int32[T]      — |wordset_fieldless|
  n_fieldset  int32[T]      — |fields_normalized_set|
  field_count int32[T]      — len(fields_normalized)  (duplicates counted)
  alt_count   int32[T]      — SPDX <alt> segments (license.rb:273-283)
  length      int32[T]      — normalized content length
  cc_flag     bool[T]       — Creative Commons (for the false-positive mask)
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

LANE = 32  # bits per packed word


def pack_ids(ids: np.ndarray, n_lanes: int) -> np.ndarray:
    """Pack a list of vocab ids into a uint32 bit-vector of n_lanes words.

    Vectorized via a boolean scatter + packbits instead of the former
    ``np.bitwise_or.at`` (a slow per-element ufunc loop): packbits with
    ``bitorder='little'`` viewed as little-endian uint32 puts id k at
    bit ``k & 31`` of word ``k >> 5`` — exactly the device layout."""
    if not len(ids):
        return np.zeros(n_lanes, dtype=np.uint32)
    flags = np.zeros(n_lanes * LANE, dtype=bool)
    flags[np.asarray(ids, dtype=np.int64)] = True
    return np.packbits(flags, bitorder="little").view("<u4").astype(
        np.uint32, copy=False
    )


@dataclass(frozen=True)
class CompiledCorpus:
    """Immutable scoring constants for a template pool."""

    keys: tuple[str, ...]
    vocab: dict[str, int]
    bits: np.ndarray         # uint32[T, W]
    n_wf: np.ndarray         # int32[T]
    n_fieldset: np.ndarray   # int32[T]
    field_count: np.ndarray  # int32[T]
    alt_count: np.ndarray    # int32[T]
    length: np.ndarray       # int32[T]
    cc_flag: np.ndarray      # bool[T]
    content_hashes: dict[str, str] = field(default_factory=dict)
    # full (fields included) template wordsets keyed for the Exact matcher's
    # set-equality test (matchers/exact.rb:6-13); first key wins on collision,
    # matching the reference's first-match license order
    exact_sets: dict[frozenset, str] = field(default_factory=dict)

    @property
    def n_templates(self) -> int:
        return len(self.keys)

    @property
    def n_lanes(self) -> int:
        return self.bits.shape[1]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def file_features(self, normalized_file) -> tuple[np.ndarray, int, int]:
        """Extract (packed bits, |wordset|, length) for a candidate file.

        Out-of-vocabulary words cannot overlap any template, so only the
        in-vocab projection is packed — but the full wordset size still
        counts in the score denominator."""
        wordset = normalized_file.wordset or frozenset()
        # one dict probe per word (map + filter) instead of the former
        # membership-then-index double lookup
        ids = [i for i in map(self.vocab.get, wordset) if i is not None]
        return pack_ids(ids, self.n_lanes), len(wordset), normalized_file.length

    @staticmethod
    def compile(licenses, lane_align: int = 4) -> "CompiledCorpus":
        """Build scoring constants from License-like objects (anything with
        wordset_fieldless / fields_normalized / length / spdx_alt_segments /
        creative_commons_q)."""
        pool = [lic for lic in licenses if lic.wordset is not None]
        vocab: dict[str, int] = {}
        for lic in pool:
            for word in sorted(lic.wordset_fieldless):
                if word not in vocab:
                    vocab[word] = len(vocab)
        # Also cover every template's FULL wordset (field words included),
        # appended after the scoring words so template bit rows are
        # unchanged (field-word columns stay 0 in every row — they can
        # never contribute to an overlap).  This makes the batch Exact
        # check exact by construction: a blob whose in-vocab projection
        # equals a template's full-wordset bits AND whose |wordset| equals
        # the template's has zero out-of-vocab words, hence wordset
        # equality (matchers/exact.rb:6-13) — no hash trust needed.
        for lic in pool:
            for word in sorted(lic.wordset - lic.wordset_fieldless):
                if word not in vocab:
                    vocab[word] = len(vocab)

        n_lanes = -(-len(vocab) // LANE)
        n_lanes = -(-n_lanes // lane_align) * lane_align

        T = len(pool)
        bits = np.zeros((T, n_lanes), dtype=np.uint32)
        n_wf = np.zeros(T, dtype=np.int32)
        n_fieldset = np.zeros(T, dtype=np.int32)
        field_count = np.zeros(T, dtype=np.int32)
        alt_count = np.zeros(T, dtype=np.int32)
        length = np.zeros(T, dtype=np.int32)
        cc_flag = np.zeros(T, dtype=bool)
        hashes: dict[str, str] = {}
        exact_sets: dict[frozenset, str] = {}

        for t, lic in enumerate(pool):
            ids = [vocab[w] for w in lic.wordset_fieldless]
            bits[t] = pack_ids(ids, n_lanes)
            n_wf[t] = len(lic.wordset_fieldless)
            n_fieldset[t] = len(lic.fields_normalized_set)
            field_count[t] = len(lic.fields_normalized)
            alt_count[t] = getattr(lic, "spdx_alt_segments", 0)
            length[t] = lic.length
            cc_flag[t] = getattr(lic, "creative_commons_q", False)
            hashes[lic.content_hash] = lic.key
            exact_sets.setdefault(frozenset(lic.wordset), lic.key)

        return CompiledCorpus(
            keys=tuple(lic.key for lic in pool),
            vocab=vocab,
            bits=bits,
            n_wf=n_wf,
            n_fieldset=n_fieldset,
            field_count=field_count,
            alt_count=alt_count,
            length=length,
            cc_flag=cc_flag,
            content_hashes=hashes,
            exact_sets=exact_sets,
        )


@functools.cache
def default_corpus() -> CompiledCorpus:
    """The compiled vendored corpus (Dice's default candidate pool:
    hidden included, pseudo excluded — matcher.rb:29-31)."""
    from licensee_tpu_torch.corpus.license import License

    return CompiledCorpus.compile(License.all(hidden=True, pseudo=False))
