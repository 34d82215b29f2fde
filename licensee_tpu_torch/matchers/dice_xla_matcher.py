"""DiceXLA as a registry matcher: a drop-in for the scalar Dice matcher
that scores through the batch path's `BatchClassifier`, one file at a
time (`Matchers::DiceXLA`, the JAX package's name for it), and so
through K1's fused first-max (`best_match_fused`) on the card.

The shared classifier is built on the CUDA device; `use_device("cpu")`
asks for the plain PyTorch scorers instead.  Without a card and without
that call, the first match raises: nothing falls back to the CPU."""

from __future__ import annotations

import licensee_tpu_torch
from licensee_tpu_torch.matchers.base import Matcher

_UNSET = object()

_device = "cuda"
_classifier = None


def use_device(device) -> None:
    """The device the shared classifier runs on from now on ("cuda", the
    default, or "cpu"); a classifier built for another is dropped."""
    global _device, _classifier
    if device != _device:
        _device, _classifier = device, None


def _shared_classifier():
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    global _classifier
    if _classifier is None:
        _classifier = BatchClassifier(pad_batch_to=8, device=_device)
    return _classifier


class DiceXLA(Matcher):
    @property
    def match(self):
        cached = self.__dict__.get("_match", _UNSET)
        if cached is _UNSET:
            from licensee_tpu_torch.corpus.license import License

            result = self._result()
            cached = License.find(result.key) if result.key else None
            self.__dict__["_match"] = cached
        return cached

    @property
    def confidence(self) -> float:
        result = self._result()
        return result.confidence if result.key else 0

    def _result(self):
        cached = self.__dict__.get("_xla_result")
        if cached is None:
            classifier = _shared_classifier()
            content = self.file.content
            # prefilter=False: this matcher is a drop-in for Dice inside
            # the first-match-wins chain, where Copyright and Exact have
            # already had their turn (license_file.rb:67-69) — the batch
            # prefilters would change its answer on copyright-only files
            cached = classifier.classify_blobs(
                [content if content is not None else ""],
                threshold=licensee_tpu_torch.confidence_threshold(),
                prefilter=False,
                filenames=[getattr(self.file, "filename", None)],
            )[0]
            self.__dict__["_xla_result"] = cached
        return cached
