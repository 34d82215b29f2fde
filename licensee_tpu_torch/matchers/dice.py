"""Scalar Sørensen–Dice matcher (parity: `lib/licensee/matchers/dice.rb`).

This is the reference-semantics scalar path, the one `detect`'s chain
runs; the batch path (`kernels/batch.py` over K1 or K2) reproduces
exactly these scores and is held against this implementation.
"""

from __future__ import annotations

import licensee_tpu_torch
from licensee_tpu_torch.matchers.base import Matcher


class Dice(Matcher):
    @property
    def match(self):
        matches = self.matches
        return matches[0][0] if matches else None

    @property
    def potential_matches(self) -> list:
        """Candidate pool with the CC false-positive guard (dice.rb:16-31):
        CC licenses are excluded when the file starts with a non-open-source
        CC variant title."""
        cached = self.__dict__.get("_dice_potential_matches")
        if cached is None:
            cached = []
            for lic in super().potential_matches:
                if lic.creative_commons_q and self.file.potential_false_positive:
                    continue
                if lic.wordset is not None:
                    cached.append(lic)
            self.__dict__["_dice_potential_matches"] = cached
        return cached

    potential_licenses = potential_matches

    @property
    def matches_by_similarity(self) -> list:
        cached = self.__dict__.get("_matches_by_similarity")
        if cached is None:
            scored = [(lic, lic.similarity(self.file)) for lic in self.potential_matches]
            # Ruby sort_by(similarity).reverse: stable sort then reverse, so
            # equal scores end up in reverse candidate order.
            scored = sorted(scored, key=lambda pair: pair[1])
            scored.reverse()
            cached = scored
            self.__dict__["_matches_by_similarity"] = cached
        return cached

    licenses_by_similarity = matches_by_similarity

    @property
    def matches(self) -> list:
        threshold = licensee_tpu_torch.confidence_threshold()
        return [
            (lic, sim) for lic, sim in self.matches_by_similarity if sim >= threshold
        ]

    @property
    def confidence(self) -> float:
        match = self.match
        return match.similarity(self.file) if match else 0
