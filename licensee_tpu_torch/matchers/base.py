"""Matcher base class (parity: `lib/licensee/matchers/matcher.rb`)."""

from __future__ import annotations


class Matcher:
    def __init__(self, file):
        self.file = file

    @property
    def name(self) -> str:
        return type(self).__name__.lower()

    @property
    def match(self):
        raise NotImplementedError

    @property
    def confidence(self) -> float:
        raise NotImplementedError

    @property
    def potential_matches(self) -> list:
        """Default candidate pool: every non-pseudo license, hidden included
        (matcher.rb:29-31)."""
        cached = self.__dict__.get("_potential_matches")
        if cached is None:
            from licensee_tpu_torch.corpus.license import License

            cached = License.all(hidden=True, pseudo=False)
            self.__dict__["_potential_matches"] = cached
        return cached

    def to_h(self) -> dict:
        return {"name": self.name, "confidence": self.confidence}
