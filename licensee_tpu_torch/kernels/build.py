"""Build and load the port's CUDA kernels (`licensee_tpu_torch/csrc/*.cu`).

The kernels have a plain ``extern "C"`` interface and are bound with
ctypes, so the build needs only ``nvcc`` (no PyTorch headers, no ninja):
each source compiles to an object on its own ``nvcc`` process, all of
them at once, and one more ``nvcc`` links them into one shared library.
The build happens at first use, into ``build/licensee_tpu_torch/`` at
the checkout's root (``build/`` is git-ignored), and again whenever a
source is newer than the library.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(PACKAGE_DIR), "build", "licensee_tpu_torch"
)
LIBRARY = os.path.join(BUILD_DIR, "libdice_kernels.so")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# argtypes of each C entry point: every pointer and the stream as
# c_void_p (a bare int would be cut to 32 bits), every size as c_int
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # meta, tpl, file, n_words, lengths, cc_fp, num, den, B, T, W,
    # per_split, tc, stream
    "dice_score_fused": [_P] * 8 + [_I] * 5 + [_P],
    # meta, tpl, file, n_words, lengths, cc_fp, idx, num, den, partial,
    # tickets, B, T, W, per_split, tc, stream
    "dice_best_fused": [_P] * 11 + [_I] * 5 + [_P],
    # tpl, file, out, B, T, W, t_pad, bn, splits, stream
    "dice_overlap_mma": [_P] * 3 + [_I] * 6 + [_P],
    # meta, tpl, file, n_words, lengths, cc_fp, idx, num, den, partial,
    # tickets, B, T, W, per_split, tc, k, stream
    "dice_topk_fused": [_P] * 11 + [_I] * 6 + [_P],
    # num, den, out, B, T, k, lanes, P, R, stream
    "dice_topk_exact": [_P] * 3 + [_I] * 6 + [_P],
}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and $PATH): the CUDA kernels cannot be built"
        )
    return found


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith(".cu")
    )


def _stale(srcs: list[str]) -> bool:
    if not os.path.exists(LIBRARY):
        return True
    built = os.path.getmtime(LIBRARY)
    return any(os.path.getmtime(s) > built for s in srcs)


def build(verbose: bool = False) -> str:
    """Compile every source in parallel and link the library; returns
    what nvcc printed.  ``verbose`` adds ``-Xptxas -v``: registers,
    shared memory and spills per kernel."""
    nvcc = find_nvcc()
    srcs = sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    # objects and the library are named per process until the atomic
    # rename, so two processes building at once never share a file
    pid = os.getpid()
    objs, procs = [], []
    for src in srcs:
        obj = os.path.join(
            BUILD_DIR,
            f"{os.path.splitext(os.path.basename(src))[0]}.{pid}.o",
        )
        objs.append(obj)
        procs.append(
            subprocess.Popen(
                [nvcc, *CFLAGS, *extra, "-c", src, "-o", obj],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    try:
        reports = []
        failed = []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            reports.append(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out}")
        if failed:
            raise BuildError("nvcc failed:\n" + "\n".join(failed))
        tmp = LIBRARY + f".tmp{pid}"
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        if link.returncode != 0:
            raise BuildError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp, LIBRARY)  # atomic: a reader never sees half a library
    finally:
        for proc in procs:
            proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(reports)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale, with the
    argtypes/restype of every entry point set."""
    if _stale(sources()):
        build()
    lib = ctypes.CDLL(LIBRARY)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
