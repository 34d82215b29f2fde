"""The card: its identity, its peaks, its trace, and the score step's
least time.

The peaks and the way the score step's work is counted are copied from
`chip_smoke.py` (`HBM_BYTES_PER_S`, `INT_OPS_PER_CLK_SM`,
`B1_PAIR_WORDS_PER_CLK_SM`, `K1_PAIR_OPS`, `k1_bound`), recast as the
work of the score step whatever kernel implements it, so that K1, K2 or
a later kernel read against the same work.  The trace is
`torch.profiler`'s Chrome trace of the measured window, read for the
device's busy intervals (kernels, copies and fills), the scoring
kernels' time and the longest idle gaps.
"""

from __future__ import annotations

import json
import os
import subprocess

# published peaks of one H100 SXM (dense, 700 W): the HBM rate
HBM_BYTES_PER_S = 3.35e12
# per SM and clock (times the SM count and the card's maximum SM clock):
# 64 results of 32-bit logic or integer add on the CUDA cores (the CUDA
# C++ Programming Guide's throughput table, compute capability 9.0), and
# 1024 pair-words (32-bit AND-then-popcount products) on the single-bit
# tensor cores: 8x the int8 rate of 4096 multiply-adds a clock, the
# binary-to-int8 ratio NVIDIA published for the A100
INT_OPS_PER_CLK_SM = 64
B1_PAIR_WORDS_PER_CLK_SM = 1024
# integer operations per (blob, template) pair besides the overlap: the
# score algebra 10, and the first-max's exact compare 4 more
PAIR_OPS = 14
# the kernels that implement the score step (K1, K2, K4's top-k)
SCORE_KERNELS = ("dice_k1_kernel", "dice_overlap_wgmma", "topk_group",
                 "topk_sort")
# what the module names a process must not hold (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "licensee_tpu")


def forbidden_modules(modules) -> list[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN:
    ``licensee_tpu_torch`` is a name of its own, not ``licensee_tpu``."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def cpu_seconds() -> float:
    """This process's CPU seconds (user and system), read at both ends of
    a window: the cores the run kept busy."""
    t = os.times()
    return t.user + t.system


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clocks_per_s(torch) -> float:
    """The card's SM count times its maximum SM clock."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_sms * float(smi("clocks.max.sm").split()[0]) * 1e6


def score_least_s(rows: float, launches: int, T: int, W: int,
                  sm_clocks: float) -> float:
    """The least time of scoring ``rows`` blobs against ``T`` templates
    of ``W`` packed words in ``launches`` launches: the larger of the
    B·T·W pair-words on the single-bit tensor cores, the pair algebra
    and first-max on the CUDA cores, and the bytes (each blob's words,
    columns and result once, the templates and their meta rows once a
    launch) at the HBM rate."""
    tensor_s = rows * T * W / (B1_PAIR_WORDS_PER_CLK_SM * sm_clocks)
    alu_s = rows * T * PAIR_OPS / (INT_OPS_PER_CLK_SM * sm_clocks)
    n_bytes = rows * (W * 4 + 9 + 12) + launches * (T * W * 4 + T * 8 * 4)
    return max(tensor_s, alu_s, n_bytes / HBM_BYTES_PER_S)


def prime_profiler(torch) -> None:
    """Profile nothing once: the first profiler of a process loads and
    starts the card's tracing library, which takes seconds, and that
    belongs to set-up, not to the traced window."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


class Trace:
    """The device side of a traced window, from a Chrome trace file."""

    def __init__(self, path: str | None = None, ops: list | None = None):
        if path is not None:
            with open(path, encoding="utf-8") as fh:
                events = json.load(fh)
            if isinstance(events, dict):
                events = events.get("traceEvents", [])
            ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                    e.get("name", "?"))
                   for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        self.ops = sorted(ops)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union
        of the operations' intervals."""
        busy, end = 0.0, None
        for t0, t1, _name in self.ops:
            if end is None or t0 > end:
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy / 1e6

    def score_kernels(self) -> tuple[int, float]:
        """(launches, summed seconds) of the score step's kernels."""
        picked = [t1 - t0 for t0, t1, name in self.ops
                  if any(k in name for k in SCORE_KERNELS)]
        return len(picked), sum(picked) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        gaps between operations, named by the operations around them."""
        by_name: dict = {}
        for t0, t1, name in self.ops:
            by_name[short(name)] = (by_name.get(short(name), 0.0)
                                    + (t1 - t0) / 1e6)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        end, last = None, None
        for t0, t1, name in self.ops:
            if end is not None and t0 > end:
                gaps.append((f"after {short(last)} before {short(name)}",
                             (t0 - end) / 1e6))
            if end is None or t1 > end:
                end, last = t1, name
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def short(name: str | None) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``void (anonymous namespace)::k<3>(P)`` -> ``k``."""
    if not name:
        return "?"
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    for stop in ("<", "("):
        cut = name.find(stop)
        if cut > 0:
            name = name[:cut]
    return name.strip()[:80] or "?"
