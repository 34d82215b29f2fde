"""Exact wordset-equality matcher (parity: `lib/licensee/matchers/exact.rb`).

Stays on host in the batch path: content-hash / wordset equality is the
cheap pre-filter that routes blobs away from the device Dice kernel.
"""

from __future__ import annotations

from licensee_tpu_torch.matchers.base import Matcher

_UNSET = object()


class Exact(Matcher):
    @property
    def match(self):
        cached = self.__dict__.get("_match", _UNSET)
        if cached is _UNSET:
            cached = None
            for candidate in self.potential_matches:
                if candidate.wordset == self.file.wordset:
                    cached = candidate
                    break
            self.__dict__["_match"] = cached
        return cached

    @property
    def confidence(self) -> float:
        return 100
