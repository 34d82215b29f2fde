"""Build and load the native host components (g++ and system libraries
only).

The port's counterpart of `licensee_tpu/native/build.py`: compile
``native/<name>.cpp`` at the checkout's root into
``build/licensee_tpu_torch/native/_<name>.so`` (``build/`` is
git-ignored), rebuilding when the source or any shared header is newer,
and load it with ctypes.  It never loads the library the JAX package
builds inside its own directory.  Callers catch NativeUnavailable and
keep the pure-Python path; ``LICENSEE_TPU_NO_NATIVE`` set to anything
non-empty disables the native components, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
NATIVE_SRC_DIR = os.path.join(_REPO, "native")
LIB_DIR = os.path.join(_REPO, "build", "licensee_tpu_torch", "native")

_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def library_path(name: str) -> str:
    return os.path.join(LIB_DIR, f"_{name}.so")


def build_and_load(name: str, extra_libs: tuple[str, ...] = ()):
    """Compile native/<name>.cpp -> _<name>.so (cached) and ctypes-load it."""
    if os.environ.get("LICENSEE_TPU_NO_NATIVE"):
        raise NativeUnavailable("disabled by LICENSEE_TPU_NO_NATIVE")
    src = os.path.join(NATIVE_SRC_DIR, f"{name}.cpp")
    lib = library_path(name)
    if not os.path.exists(src):
        raise NativeUnavailable(f"missing source {src}")
    # staleness covers the shared headers (scanners.h) too
    newest_src = max(
        os.path.getmtime(os.path.join(NATIVE_SRC_DIR, entry))
        for entry in os.listdir(NATIVE_SRC_DIR)
        if entry == f"{name}.cpp" or entry.endswith(".h")
    )
    with _lock:
        if not os.path.exists(lib) or os.path.getmtime(lib) < newest_src:
            os.makedirs(LIB_DIR, exist_ok=True)
            # a temp file per process: processes that build at once (test
            # workers, spawned featurize processes) never interleave g++
            # output in one file, and os.replace of a whole library is
            # atomic
            fd, tmp = tempfile.mkstemp(
                prefix=f"_{name}.", suffix=".so.tmp", dir=LIB_DIR
            )
            os.close(fd)
            try:
                cmd = [
                    "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-o", tmp, src, *[f"-l{lib_}" for lib_ in extra_libs],
                ]
                try:
                    result = subprocess.run(
                        cmd, capture_output=True, text=True
                    )
                except OSError as exc:  # no g++ on this host
                    raise NativeUnavailable(
                        f"{name} build failed: {exc}"
                    ) from exc
                if result.returncode != 0:
                    raise NativeUnavailable(
                        f"{name} build failed: {result.stderr[:500]}"
                    )
                os.replace(tmp, lib)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        try:
            return ctypes.CDLL(lib)
        except OSError as exc:
            raise NativeUnavailable(f"{name} load failed: {exc}") from exc
