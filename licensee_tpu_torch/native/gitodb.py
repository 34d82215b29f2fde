"""ctypes bindings for the native git object-database reader.

The port's counterpart of `licensee_tpu/native/gitodb.py`, over the same
source, the repo's ``native/gitodb.cpp`` (loose objects, packfiles v2
with deltas, ref resolution), which `native/build.py` compiles with g++
and zlib into ``build/licensee_tpu_torch/native/``.  Where the library
cannot be built or loaded, `_load` raises NativeUnavailable and the git
backends (`projects/git_project.py`) use git's plumbing commands
instead, so importing this module never fails.
"""

from __future__ import annotations

import ctypes
import os

from licensee_tpu_torch.native.build import NativeUnavailable, build_and_load

__all__ = ["GitODB", "GitODBError", "NativeUnavailable"]

_lib = None
_lib_error: str | None = None


def _load():
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise NativeUnavailable(_lib_error)
    try:
        lib = build_and_load("gitodb", ("z",))
    except NativeUnavailable as exc:
        _lib_error = str(exc)
        raise

    lib.godb_last_error.restype = ctypes.c_char_p
    lib.godb_open.restype = ctypes.c_void_p
    lib.godb_open.argtypes = [ctypes.c_char_p]
    lib.godb_close.argtypes = [ctypes.c_void_p]
    lib.godb_resolve.restype = ctypes.c_int
    lib.godb_resolve.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.godb_root_entries.restype = ctypes.c_void_p
    lib.godb_root_entries.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.godb_read_blob.restype = ctypes.c_void_p
    lib.godb_read_blob.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.godb_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


class GitODBError(ValueError):
    pass


class GitODB:
    """A repository handle over the native object-database reader."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._handle = lib.godb_open(os.fsencode(path))
        if not self._handle:
            raise GitODBError(self._error())

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.godb_close(self._handle)
            self._handle = None

    def __del__(self):  # best effort; close() is the API
        try:
            self.close()
        except Exception:
            pass

    def _error(self) -> str:
        return self._lib.godb_last_error().decode("utf-8", "replace")

    def resolve(self, revision: str | None = None) -> str:
        """The commit sha a revision (branch, tag, sha, HEAD) names."""
        out = ctypes.create_string_buffer(41)
        rc = self._lib.godb_resolve(
            self._handle, (revision or "HEAD").encode("utf-8"), out
        )
        if rc != 0:
            raise GitODBError(self._error())
        return out.value.decode("ascii")

    def root_entries(self, commit_sha: str) -> list[dict]:
        """The commit's root-tree entries: [{'mode', 'oid', 'type',
        'name'}, ...].  Records are NUL-separated: git forbids NUL in a
        tree entry's name, not newlines."""
        n = ctypes.c_size_t()
        ptr = self._lib.godb_root_entries(
            self._handle, commit_sha.encode("ascii"), ctypes.byref(n)
        )
        if not ptr:
            raise GitODBError(self._error())
        try:
            text = ctypes.string_at(ptr, n.value).decode("utf-8", "replace")
        finally:
            self._lib.godb_free(ptr)
        entries = []
        for record in text.split("\0"):
            if not record:
                continue
            mode, oid, otype, name = record.split(" ", 3)
            entries.append(
                {"mode": mode, "oid": oid, "type": otype, "name": name}
            )
        return entries

    def read_blob(self, sha: str, max_len: int = 64 * 1024) -> bytes:
        """At most ``max_len`` bytes of a blob."""
        n = ctypes.c_size_t()
        ptr = self._lib.godb_read_blob(
            self._handle, sha.encode("ascii"), max_len, ctypes.byref(n)
        )
        if not ptr:
            raise GitODBError(self._error())
        try:
            return ctypes.string_at(ptr, n.value)
        finally:
            self._lib.godb_free(ptr)
