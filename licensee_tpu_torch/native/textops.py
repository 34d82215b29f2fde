"""ctypes bindings for the native normalization scanners (native/textops.cpp).

The port's copy of `licensee_tpu/native/textops.py`: str -> str twins of
the hottest passes of `normalize/pipeline.py`, which the pure-Python
path runs (the featurizer's per-blob failover after a
NativeResourceError, and every blob where the whole-pipeline library is
unavailable).  ``load()`` returns a ``TextOps`` instance or ``None``
(toolchain missing or LICENSEE_TPU_NO_NATIVE set), in which case
`normalize/pipeline.py` keeps its regexes.  The outputs are
bit-identical to the regexes (the JAX package's tests/test_textops.py
holds the same library to them; tests/test_torch_native.py holds the
port's featurizer to the JAX package's).
"""

from __future__ import annotations

import ctypes

from licensee_tpu_torch.native.build import NativeUnavailable, build_and_load

_instance = None
_failed = False


class TextOps:
    def __init__(self):
        lib = build_and_load("textops")
        self._lib = lib
        lib.top_free.argtypes = [ctypes.c_void_p]
        out_len = ctypes.POINTER(ctypes.c_size_t)
        for fname in (
            "top_squeeze_strip",
            "top_strip_whitespace",
            "top_dashes",
            "top_quotes",
            "top_hyphenated",
            "top_wordset",
        ):
            fn = getattr(lib, fname)
            fn.restype = ctypes.c_void_p
            fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, out_len]
        lib.top_spelling_new.restype = ctypes.c_void_p
        lib.top_spelling_new.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.top_spelling_del.argtypes = [ctypes.c_void_p]
        lib.top_spelling.restype = ctypes.c_void_p
        lib.top_spelling.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, out_len,
        ]

        from licensee_tpu_torch.normalize.pipeline import VARIETAL_WORDS

        table = b"".join(
            k.encode() + b"\0" + v.encode() + b"\0"
            for k, v in VARIETAL_WORDS.items()
        )
        self._spelling = lib.top_spelling_new(table, len(table))

    def _call(self, fname: str, s: str, *pre) -> str:
        data = s.encode("utf-8")
        n = ctypes.c_size_t()
        ptr = getattr(self._lib, fname)(*pre, data, len(data), ctypes.byref(n))
        try:
            return ctypes.string_at(ptr, n.value).decode("utf-8")
        finally:
            self._lib.top_free(ptr)

    def squeeze_strip(self, s: str) -> str:
        return self._call("top_squeeze_strip", s)

    def strip_whitespace(self, s: str) -> str:
        return self._call("top_strip_whitespace", s)

    def dashes(self, s: str) -> str:
        return self._call("top_dashes", s)

    def quotes(self, s: str) -> str:
        return self._call("top_quotes", s)

    def hyphenated(self, s: str) -> str:
        return self._call("top_hyphenated", s)

    def spelling(self, s: str) -> str:
        return self._call("top_spelling", s, self._spelling)

    def wordset(self, s: str) -> frozenset[str]:
        """Unique wordset tokens of normalized content (the
        WORDSET_TOKEN findall + frozenset, one native scan)."""
        joined = self._call("top_wordset", s)
        return frozenset(joined.split("\0")) if joined else frozenset()


def load() -> TextOps | None:
    """The shared TextOps instance, or None when native is unavailable."""
    global _instance, _failed
    if _instance is None and not _failed:
        try:
            _instance = TextOps()
        except NativeUnavailable:
            _failed = True
    return _instance
