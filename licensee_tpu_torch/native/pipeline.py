"""ctypes bindings for the whole-pipeline native featurizer
(native/pipeline.cpp).

The port's copy of `licensee_tpu/native/pipeline.py`: the entire
stage-1/stage-2 normalization (PCRE2 for the complex patterns, the
shared hand-coded scanners for the rest), wordset extraction,
vocabulary projection and the Exact-matcher wordset hash, in at most two
crossings per blob, or one crossing for a whole batch
(`featurize_batch`, which drops the GIL).  Ruby String#downcase is
full-Unicode, so the downcase between the stages stays in Python
(str.lower).

Every pattern string is shipped to C++ from the port's own copies
(`normalize/pipeline.py`, `corpus/license.py`,
`project_files/license_file.py`); the only translation is Python's
``\\Z`` (end of string) to PCRE2's ``\\z``.  ``load()`` returns a
``NativePipeline`` or ``None`` (no toolchain, no libpcre2, or
LICENSEE_TPU_NO_NATIVE set), in which case callers keep the pure-Python
path.  The library is built from the repo's ``native/`` sources by
`native/build.py`.  The Reference-matcher scan (``refscan_*``) serves
the readme chain's fallback (`kernels/batch.py:_reference_match`).  The
library's stage.*/count.* profile counters come out through the
module-level `profile_dump` / `profile_reset`, merged with the rows the
pure-Python path adds (`py_profile_add`), for the obs registry
(`obs/export.py:NativeProfileSource`).
"""

from __future__ import annotations

import ctypes
import re
import threading

import numpy as np

from licensee_tpu_torch.native.build import NativeUnavailable, build_and_load

_instance = None
_failed = False


class NativeResourceError(RuntimeError):
    """PCRE2 hit a resource limit (MATCHLIMIT/DEPTHLIMIT) on this blob.

    Python `re` has no such limits, so treating this as "no match" would
    silently diverge from the fallback path on adversarial inputs
    (nested-quantifier patterns vs pathological text).  Callers catch
    this and re-run the single blob through the pure-Python pipeline."""


def _flags_str(pattern: re.Pattern) -> str:
    flags = ""
    if pattern.flags & re.I:
        flags += "i"
    if pattern.flags & re.S:
        flags += "s"
    if pattern.flags & re.X:
        flags += "x"
    return flags


def _pcre_pattern(pattern: re.Pattern) -> bytes:
    # Python \Z (end of string) == PCRE2 \z; PCRE2's \Z allows a final
    # newline, which Python's does not.
    return pattern.pattern.replace("\\Z", "\\z").encode("utf-8")


_TITLE_PREFIX_LEN = 6


def _title_prefixes_for(part: str, k: int = _TITLE_PREFIX_LEN) -> set[str] | None:
    """Lowercase literal prefixes covering every caseless match of one
    title-union alternative, or None when underivable.

    A conservative mini-parser over the pattern strings
    ``License.title_regex_pattern`` actually constructs (literals,
    escapes, ``(?i:``/``(?:...)?`` groups, small char classes): each
    returned prefix is a run of characters every match MUST start with,
    so a text matching none of them provably cannot match the
    alternative.  Anything the parser cannot bound returns the prefix
    accumulated so far (still sound — those characters are mandatory)
    or None when no character is guaranteed at all; the caller disables
    the native gate entirely on any None."""
    out: set[str] = set()
    budget = [256]

    def lc(ch: str) -> str:
        # ASCII-only fold: PCRE2 runs the union caseless in 8-bit byte
        # mode, where non-ASCII bytes never case-fold
        return ch.lower() if "A" <= ch <= "Z" else ch

    def stop(acc: str) -> bool:
        if not acc:
            return False
        out.add(acc)
        return True

    def group_end(s: str, i: int) -> int | None:
        depth = 0
        while i < len(s):
            c = s[i]
            if c == "\\":
                i += 2
                continue
            if c == "[":
                j = s.find("]", i + 1)
                if j < 0:
                    return None
                i = j + 1
                continue
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
                if depth == 0:
                    return i + 1
            i += 1
        return None

    def split_alts(s: str) -> list[str] | None:
        parts, depth, cur, i = [], 0, "", 0
        while i < len(s):
            c = s[i]
            if c == "\\":
                cur += s[i:i + 2]
                i += 2
                continue
            if c == "[":
                j = s.find("]", i + 1)
                if j < 0:
                    return None
                cur += s[i:j + 1]
                i = j + 1
                continue
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
            elif c == "|" and depth == 0:
                parts.append(cur)
                cur = ""
                i += 1
                continue
            cur += c
            i += 1
        parts.append(cur)
        return parts

    def lit_step(ch: str, rest: str, acc: str) -> bool:
        quant = rest[0] if rest else ""
        if quant == "?":
            return walk(rest[1:], acc + lc(ch)) and walk(rest[1:], acc)
        if quant == "+":
            # at least one occurrence is guaranteed, then repetition is
            # unbounded: stop extending here
            return stop(acc + lc(ch))
        if quant and quant in "*{":
            return stop(acc)
        return walk(rest, acc + lc(ch))

    def walk(s: str, acc: str) -> bool:
        budget[0] -= 1
        if budget[0] < 0:
            return False
        if len(acc) >= k:
            out.add(acc[:k])
            return True
        if not s:
            return stop(acc)
        c = s[0]
        if c == "(":
            if s.startswith("(?:"):
                body_start = 3
            elif s.startswith("(?i:"):
                body_start = 4
            elif s.startswith("(?"):
                return stop(acc)  # lookaround/flags: out of scope
            else:
                body_start = 1
            e = group_end(s, 0)
            if e is None:
                return stop(acc)
            body = s[body_start:e - 1]
            rest = s[e:]
            quant = rest[0] if rest else ""
            alts = split_alts(body)
            if alts is None:
                return stop(acc)
            if quant == "?":
                rest = rest[1:]
                if not walk(rest, acc):
                    return False
                return all(walk(a + rest, acc) for a in alts)
            if quant and quant in "*+{":
                return stop(acc)
            return all(walk(a + rest, acc) for a in alts)
        if c == "[":
            j = s.find("]")
            if j <= 1:
                return stop(acc)
            body = s[1:j]
            rest = s[j + 1:]
            if body.startswith("^"):
                return stop(acc)
            chars: list[str] = []
            t = 0
            while t < len(body):
                bc = body[t]
                if bc == "\\":
                    if t + 1 < len(body) and not body[t + 1].isalnum():
                        chars.append(body[t + 1])
                        t += 2
                        continue
                    return stop(acc)  # \d/\s/... class inside: unbounded
                if bc == "-" and 0 < t < len(body) - 1:
                    return stop(acc)  # range: out of scope
                chars.append(bc)
                t += 1
            if not chars or len(chars) > 6:
                return stop(acc)
            quant = rest[0] if rest else ""
            if quant == "?":
                rest = rest[1:]
                if not walk(rest, acc):
                    return False
                return all(walk(rest, acc + lc(bc)) for bc in chars)
            if quant and quant in "*+{":
                return stop(acc)
            return all(walk(rest, acc + lc(bc)) for bc in chars)
        if c == "\\":
            if len(s) < 2 or s[1].isalnum():
                return stop(acc)  # \d \s \w \b ...: classes/anchors
            return lit_step(s[1], s[2:], acc)
        if c == "|":
            # a bare alternation reached mid-walk can't be folded into a
            # single mandatory prefix; top-level '|' is pre-split below,
            # so hitting one here means the pattern is out of scope
            return False
        if c in ".^$?*+{)":
            return stop(acc)
        return lit_step(c, s[1:], acc)

    top_alts = split_alts(part)
    if top_alts is None:
        return None
    if not all(walk(a, "") for a in top_alts):
        return None
    return out


def _derive_title_prefixes() -> list[str] | None:
    """The '\\n'-joined payload of the ``title_prefixes`` config record:
    minimal lowercase literal prefixes for the whole title union, or
    None (record omitted, native gate disabled) when any alternative is
    underivable."""
    from licensee_tpu_torch.corpus.license import global_title_parts

    all_prefixes: set[str] = set()
    for part in global_title_parts():
        got = _title_prefixes_for(part)
        if not got:
            return None
        all_prefixes.update(got)
    if any("\n" in p or "\0" in p or not p for p in all_prefixes):
        return None
    # minimality: a prefix subsumed by a shorter one never changes the
    # gate's answer, so drop it
    keep = [
        p for p in all_prefixes
        if not any(p != q and p.startswith(q) for q in all_prefixes)
    ]
    if not keep or len(keep) > 1024:
        return None
    return sorted(keep)


def _build_config() -> bytes:
    from licensee_tpu_torch.corpus.license import global_title_regex
    from licensee_tpu_torch.normalize import pipeline as pl
    from licensee_tpu_torch.project_files.license_file import (
        CC_FALSE_POSITIVE_REGEX,
    )

    named: dict[str, re.Pattern] = {
        "hrs": pl.REGEXES["hrs"],
        "comment_markup": pl.REGEXES["comment_markup"],
        "markdown_headings": pl.REGEXES["markdown_headings"],
        "link_markup": pl.REGEXES["link_markup"],
        "title": global_title_regex(),
        "version": pl.REGEXES["version"],
        "lists": pl._LISTS,
        "span_markup": pl.REGEXES["span_markup"],
        "bullet": pl.REGEXES["bullet"],
        "bullet_join": pl._BULLET_JOIN,
        "bom": pl.REGEXES["bom"],
        "cc_dedication": pl.REGEXES["cc_dedication"],
        "cc_wiki": pl.REGEXES["cc_wiki"],
        "cc_legal_code": pl.REGEXES["cc_legal_code"],
        "cc0_info": pl.REGEXES["cc0_info"],
        "cc0_disclaimer": pl.REGEXES["cc0_disclaimer"],
        "unlicense_info": pl.REGEXES["unlicense_info"],
        "border_markup": pl.REGEXES["border_markup"],
        "url": pl.REGEXES["url"],
        "strip_copyright": pl._STRIP_COPYRIGHT,
        "block_markup": pl.REGEXES["block_markup"],
        "developed_by": pl.REGEXES["developed_by"],
        "end_of_terms": pl.END_OF_TERMS,
        "mit_optional": pl.REGEXES["mit_optional"],
        "copyright_full": pl.COPYRIGHT_FULL_REGEX,
        "cc_false_positive": CC_FALSE_POSITIVE_REGEX,
    }
    records = b"".join(
        name.encode() + b"\0" + _flags_str(p).encode() + b"\0"
        + _pcre_pattern(p) + b"\0"
        for name, p in named.items()
    )
    # optional title-union gate record (before spelling_table, which
    # must stay last); omitted when the derivation declines
    prefixes = _derive_title_prefixes()
    gate = b""
    if prefixes:
        gate = (
            b"title_prefixes\0\0"
            + "\n".join(prefixes).encode("utf-8") + b"\0"
        )
    # spelling_table must be last: its payload contains '\0' separators
    table = b"".join(
        k.encode() + b"\0" + v.encode() + b"\0"
        for k, v in pl.VARIETAL_WORDS.items()
    )
    return records + gate + b"spelling_table\0\0" + table


class VocabHandle:
    """Token -> id map resident in the native library (per corpus)."""

    def __init__(self, lib, words: list[str], n_lanes: int):
        self._lib = lib
        blob = "\0".join(words).encode("utf-8")
        self.n_lanes = n_lanes
        self._handle = lib.pipe_vocab_new(blob, len(blob), n_lanes)

    def close(self) -> None:
        if self._handle:
            self._lib.pipe_vocab_del(self._handle)
            self._handle = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass


class NativePipeline:
    def __init__(self):
        lib = build_and_load("pipeline", (":libpcre2-8.so.0",))
        self._lib = lib
        lib.pipe_free.argtypes = [ctypes.c_void_p]
        lib.pipe_new.restype = ctypes.c_void_p
        lib.pipe_new.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.pipe_error.restype = ctypes.c_char_p
        lib.pipe_error.argtypes = [ctypes.c_void_p]
        lib.pipe_del.argtypes = [ctypes.c_void_p]
        out_len = ctypes.POINTER(ctypes.c_size_t)
        lib.pipe_stage1.restype = ctypes.c_void_p
        lib.pipe_stage1.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, out_len,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pipe_stage2.restype = ctypes.c_void_p
        lib.pipe_stage2.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, out_len,
        ]
        lib.pipe_vocab_new.restype = ctypes.c_void_p
        lib.pipe_vocab_new.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32,
        ]
        lib.pipe_vocab_del.argtypes = [ctypes.c_void_p]
        lib.pipe_featurize.restype = ctypes.c_int
        lib.pipe_featurize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.pipe_exact_hash.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.pipe_featurize_raw.restype = ctypes.c_int
        lib.pipe_featurize_raw.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.pipe_featurize_batch.restype = None
        lib.pipe_featurize_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int8),
        ]
        lib.pipe_refscan_new.restype = ctypes.c_void_p
        lib.pipe_refscan_new.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ]
        lib.pipe_refscan_del.argtypes = [ctypes.c_void_p]
        lib.pipe_refscan_min.restype = ctypes.c_int
        lib.pipe_refscan_min.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.pipe_refscan_set_singles.restype = ctypes.c_int
        lib.pipe_refscan_set_singles.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.pipe_refscan_resolve.restype = ctypes.c_int
        lib.pipe_refscan_resolve.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.pipe_profile_dump.restype = ctypes.c_void_p
        lib.pipe_profile_dump.argtypes = [ctypes.POINTER(ctypes.c_size_t)]
        lib.pipe_profile_reset.restype = None
        lib.pipe_profile_reset.argtypes = []

        config = _build_config()
        self._handle = lib.pipe_new(config, len(config))
        err = lib.pipe_error(self._handle)
        if err:
            msg = err.decode("utf-8", errors="replace")
            lib.pipe_del(self._handle)
            raise NativeUnavailable(f"pipeline init failed: {msg}")

    # -- per-blob API --

    def stage1(self, text: str) -> tuple[str, int]:
        """content_without_title_and_version (minus html/strip, which the
        caller does) + prefilter flags (bit0 copyright-only, bit1 cc-fp)."""
        data = text.encode("utf-8")
        n = ctypes.c_size_t()
        flags = ctypes.c_int32()
        ptr = self._lib.pipe_stage1(
            self._handle, data, len(data), ctypes.byref(n), ctypes.byref(flags)
        )
        if not ptr:
            raise NativeResourceError("pipe_stage1: PCRE2 resource limit")
        try:
            out = ctypes.string_at(ptr, n.value).decode("utf-8")
        finally:
            self._lib.pipe_free(ptr)
        return out, flags.value

    def stage2(self, lowered_stage1: str) -> str:
        data = lowered_stage1.encode("utf-8")
        n = ctypes.c_size_t()
        ptr = self._lib.pipe_stage2(self._handle, data, len(data), ctypes.byref(n))
        if not ptr:
            raise NativeResourceError("pipe_stage2: PCRE2 resource limit")
        try:
            return ctypes.string_at(ptr, n.value).decode("utf-8")
        finally:
            self._lib.pipe_free(ptr)

    def vocab(self, words: list[str], n_lanes: int) -> VocabHandle:
        return VocabHandle(self._lib, words, n_lanes)

    def featurize(
        self,
        vocab: VocabHandle,
        lowered_stage1: str,
        bits_out: np.ndarray | None = None,
    ) -> tuple[np.ndarray, int, int, bytes]:
        """(packed vocab bits, |wordset|, normalized char length,
        16-byte wordset hash) for one blob.  ``bits_out`` may be a
        caller-provided uint32[n_lanes] row (e.g. a slice of the batch
        matrix) to avoid a copy."""
        if bits_out is None:
            bits_out = np.zeros(vocab.n_lanes, dtype=np.uint32)
        assert bits_out.dtype == np.uint32 and bits_out.size == vocab.n_lanes
        data = lowered_stage1.encode("utf-8")
        scalars = (ctypes.c_int32 * 2)()
        hash16 = (ctypes.c_uint8 * 16)()
        rc = self._lib.pipe_featurize(
            self._handle,
            vocab._handle,
            data,
            len(data),
            bits_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            scalars,
            hash16,
        )
        if rc == 3:
            raise NativeResourceError("pipe_featurize: PCRE2 resource limit")
        if rc != 0:
            raise RuntimeError(f"pipe_featurize rc={rc}")
        return bits_out, int(scalars[0]), int(scalars[1]), bytes(hash16)

    def featurize_raw(
        self,
        vocab: VocabHandle,
        stripped_content: str,
        bits_out: np.ndarray | None = None,
    ) -> tuple[np.ndarray, int, int, int, bytes] | None:
        """One-crossing featurize of String#strip'd content: (bits,
        |wordset|, char length, prefilter flags, wordset hash).  Returns
        None when the content has non-ASCII bytes — the caller must use
        the two-crossing stage1 -> str.lower() -> featurize path so the
        downcase is full-Unicode."""
        if bits_out is None:
            bits_out = np.zeros(vocab.n_lanes, dtype=np.uint32)
        try:
            data = stripped_content.encode("ascii")
        except UnicodeEncodeError:
            return None
        scalars = (ctypes.c_int32 * 3)()
        hash16 = (ctypes.c_uint8 * 16)()
        rc = self._lib.pipe_featurize_raw(
            self._handle,
            vocab._handle,
            data,
            len(data),
            bits_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            scalars,
            hash16,
        )
        if rc == 2:
            return None
        if rc == 3:
            raise NativeResourceError("pipe_featurize_raw: PCRE2 resource limit")
        if rc != 0:
            raise RuntimeError(f"pipe_featurize_raw rc={rc}")
        return (
            bits_out,
            int(scalars[0]),
            int(scalars[1]),
            int(scalars[2]),
            bytes(hash16),
        )

    def featurize_batch(
        self,
        vocab: VocabHandle,
        contents: list[bytes],
        bits_out: np.ndarray,
        meta_out: np.ndarray,
        hash_out: np.ndarray,
        rows: np.ndarray | None = None,
    ) -> np.ndarray:
        """One ctypes crossing for a whole batch of RAW byte blobs.

        The native side also performs the per-blob preamble the scalar
        path does in Python — universal newlines (sanitize_content) and
        Ruby String#strip — so callers hand over file bytes untouched.
        Writes row i of ``bits_out`` (n, n_lanes) uint32, ``meta_out``
        (n, 3) int32 [|wordset|, length, prefilter flags], ``hash_out``
        (n, 16) uint8.  Returns a status array: 0 ok, 2 non-ASCII, 3
        PCRE2 resource limit — non-zero rows must be redone on the
        Unicode-safe Python path.  The GIL is dropped for the whole
        batch, so featurization worker threads scale across cores.

        ``rows`` (optional int64[n]) maps blob i to its ROW of a larger
        ``bits_out`` matrix: when the native-eligible blobs are a sparse
        subset of a batch (preset/dedupe rows interleaved), the token
        bits are still written zero-copy into the caller-owned final row
        — no staging matrix, no per-blob copy-out.  ``meta_out`` and
        ``hash_out`` stay compact (indexed by blob, not row)."""
        n = len(contents)
        status = np.zeros(n, dtype=np.int8)
        if n == 0:
            return status
        bits_rows = None
        if rows is not None:
            rows = np.ascontiguousarray(rows, dtype=np.int64)
            if rows.shape != (n,):
                raise ValueError(
                    f"rows: need int64 shape ({n},), got {rows.shape}"
                )
            if len(rows) and (
                rows.min() < 0 or rows.max() >= bits_out.shape[0]
            ):
                raise ValueError(
                    f"rows: values out of range for bits_out with "
                    f"{bits_out.shape[0]} rows"
                )
            bits_rows = rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        # the native side writes through raw row-strided pointers — the
        # layout contract must hold even under python -O, so raise, don't
        # assert
        n_bits_rows = bits_out.shape[0] if rows is not None else n
        for name, arr, dtype, shape in (
            ("bits_out", bits_out, np.uint32, (n_bits_rows, vocab.n_lanes)),
            ("meta_out", meta_out, np.int32, (n, 3)),
            ("hash_out", hash_out, np.uint8, (n, 16)),
        ):
            if (
                arr.dtype != dtype
                or not arr.flags.c_contiguous
                or arr.shape != shape
            ):
                raise ValueError(
                    f"{name}: need C-contiguous {np.dtype(dtype).name}"
                    f"{shape}, got {arr.dtype}{arr.shape}"
                )
        datas = (ctypes.c_char_p * n)(*contents)
        lens = (ctypes.c_int64 * n)(*[len(c) for c in contents])
        self._lib.pipe_featurize_batch(
            self._handle,
            vocab._handle,
            datas,
            lens,
            n,
            bits_rows,
            bits_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            meta_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hash_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        )
        return status

    # -- the Reference matcher's scan --

    def refscan_new(self, pattern: re.Pattern, extra_flags: str = ""):
        """Compile a scan union (named groups ``g<i>``) with PCRE2+JIT.

        Byte mode is the faithful twin of the repo's rb() patterns (re.A:
        ASCII-only \\b/\\w/case folding; in UTF-8 every non-ASCII byte is
        a non-word byte, as re.A treats non-ASCII characters).  ``'u'`` in
        ``extra_flags`` switches to PCRE2_UTF|PCRE2_UCP, which rb()
        patterns do not mean.  Returns an opaque handle, or None if PCRE2
        rejects the pattern (the caller keeps the Python scan)."""
        data = _pcre_pattern(pattern)
        flags = (_flags_str(pattern) + extra_flags).encode()
        return self._lib.pipe_refscan_new(data, len(data), flags) or None

    def refscan_min(self, handle, section: str) -> int:
        """Min named-group pool index over every scan hit; -1 no hit,
        -2 PCRE2 resource failure (the caller falls back to Python)."""
        data = section.encode("utf-8")
        return self._lib.pipe_refscan_min(handle, data, len(data))

    def refscan_set_singles(
        self, handle, patterns: list[re.Pattern], extra_flags: str = "",
    ) -> bool:
        """Attach the per-pool-index patterns the exact resolver needs
        (all must share one flag set); False if PCRE2 rejects any."""
        if not patterns:
            return False
        flags = {_flags_str(p) for p in patterns}
        if len(flags) != 1:
            return False
        blob = b"\0".join(_pcre_pattern(p) for p in patterns)
        # the expected count makes an index shift (an embedded NUL
        # splitting one pattern in two) a hard failure
        n = self._lib.pipe_refscan_set_singles(
            handle, blob, len(blob),
            (flags.pop() + extra_flags).encode(), len(patterns),
        )
        return n == len(patterns)

    def refscan_resolve(self, handle, section: str) -> int:
        """The exact first-matching pool index (the union's floor and the
        per-index shadow re-checks, all in C); -1 no match, -2 fall back
        to the Python chain."""
        data = section.encode("utf-8")
        return self._lib.pipe_refscan_resolve(handle, data, len(data))

    def profile_dump(self) -> dict[str, float]:
        """The library's cumulative stage.*/count.* rows (and, with
        LICENSEE_TPU_PIPE_PROFILE=1 set at process start, its per-pass
        seconds)."""
        n = ctypes.c_size_t()
        ptr = self._lib.pipe_profile_dump(ctypes.byref(n))
        if not ptr:
            return {}
        try:
            text = ctypes.string_at(ptr, n.value).decode()
        finally:
            self._lib.pipe_free(ptr)
        out = {}
        for line in text.splitlines():
            name, _, secs = line.partition("=")
            if secs:
                out[name] = float(secs)
        return out

    def profile_reset(self) -> bool:
        """Zero every counter `profile_dump` reports."""
        self._lib.pipe_profile_reset()
        return True

    def exact_hash(self, wordset) -> bytes:
        """The 16-byte hash pipe_featurize computes, for a Python-side
        wordset (e.g. a compiled template's).  The hash is an
        order-independent multiset sum, so no sorting on either side."""
        blob = "\0".join(wordset).encode("utf-8")
        hash16 = (ctypes.c_uint8 * 16)()
        self._lib.pipe_exact_hash(blob, len(blob), hash16)
        return bytes(hash16)


def load() -> NativePipeline | None:
    """The shared NativePipeline instance, or None when unavailable."""
    global _instance, _failed
    if _instance is None and not _failed:
        try:
            _instance = NativePipeline()
        except NativeUnavailable:
            _failed = True
    return _instance


# -- the profile surface, native and pure-Python merged ------------------------
#
# One call pair that works whether or not the native library loaded:
# with it, the library's stage.*/count.* counters; without it, the rows
# the pure-Python featurize path adds under the same names, so the obs
# registry never cares which path served the traffic.

_py_profile: dict[str, float] = {}
_py_profile_lock = threading.Lock()


def py_profile_add(**rows: float) -> None:
    """Accumulate pure-Python-path rows, e.g. ``py_profile_add(**{
    "count.blobs": 1, "stage.normalize_s": dt})``."""
    with _py_profile_lock:
        for name, v in rows.items():
            _py_profile[name] = _py_profile.get(name, 0.0) + v


def profile_dump() -> dict[str, float]:
    """Cumulative stage.*/count.* rows, native and Python-side merged
    (the key names are the same either way).  Never builds the library:
    a metrics scrape reads only what is already loaded."""
    pipe = _instance
    native = pipe.profile_dump() if pipe is not None else {}
    with _py_profile_lock:
        py = dict(_py_profile)
    for name, v in py.items():
        native[name] = native.get(name, 0.0) + v
    return native


def profile_reset() -> bool:
    """Zero the cumulative profile surface (both sides)."""
    with _py_profile_lock:
        _py_profile.clear()
    pipe = _instance
    return pipe.profile_reset() if pipe is not None else True
