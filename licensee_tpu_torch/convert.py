"""Carry a compiled corpus across from the JAX package.

The corpus plays the part weights play for a model: `CompiledCorpus`'s
arrays are the constants every score is computed from.  The port
compiles its own from `vendor/` (`corpus/compiler.py`); these helpers let
a caller hand it the JAX package's instead, as numpy arrays and plain
Python containers, so both packages score against the very same
constants, and put a corpus's constants on a device.
"""

from __future__ import annotations

import numpy as np

from licensee_tpu_torch.corpus.compiler import CompiledCorpus
from licensee_tpu_torch.kernels.dice_ref import CorpusTensors

ARRAY_FIELDS = {
    "bits": np.uint32,
    "n_wf": np.int32,
    "n_fieldset": np.int32,
    "field_count": np.int32,
    "alt_count": np.int32,
    "length": np.int32,
    "cc_flag": bool,
}


def corpus_from_numpy(keys, vocab, arrays, content_hashes=None,
                      exact_sets=None) -> CompiledCorpus:
    """A port `CompiledCorpus` from another corpus's fields: ``keys`` and
    ``vocab`` (word -> id, in id order), ``arrays`` a mapping with the
    seven arrays of `ARRAY_FIELDS`, and the optional content-hash and
    exact-wordset maps.  Shapes are checked; the arrays are copied."""
    keys = tuple(keys)
    T = len(keys)
    out = {}
    for name, dtype in ARRAY_FIELDS.items():
        a = np.array(arrays[name], dtype=dtype, copy=True)
        want_ndim = 2 if name == "bits" else 1
        if a.ndim != want_ndim or a.shape[0] != T:
            raise ValueError(
                f"{name} has shape {a.shape}; expected {T} template rows"
            )
        out[name] = a
    if out["bits"].shape[1] * 32 < len(vocab):
        raise ValueError(
            f"{out['bits'].shape[1]} lanes cannot hold a vocabulary of "
            f"{len(vocab)} words"
        )
    return CompiledCorpus(
        keys=keys,
        vocab=dict(vocab),
        content_hashes=dict(content_hashes or {}),
        exact_sets={frozenset(k): v for k, v in (exact_sets or {}).items()},
        **out,
    )


def corpus_tensors(corpus: CompiledCorpus, device) -> CorpusTensors:
    """The corpus's scoring constants as tensors on ``device``."""
    return CorpusTensors.from_compiled(corpus, device)
