"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA card.  Phases:

1. device: the card's name and power limit (nvidia-smi), its torch name,
   the device count, its SM count and maximum SM clock;
2. build: the three kernel sources of `licensee_tpu_torch/csrc/` (five
   entry points) compiled by nvcc for sm_90a, with ptxas's
   register/shared-memory report, and,
   meanwhile, the native featurizer (`native/pipeline.cpp`,
   `native/textops.cpp`) by g++ against libpcre2; the run fails if the
   native featurizer does not load (a Python fallback would hide it);
3. kernels: K1 and K2 on seeded random features at the main paths'
   shapes (one 4096-row batch at the vendored width T=47, W=112 and at
   the synthetic-SPDX width T=608, W=132) and at B=262144 at both
   widths: K1 as the fused first-max the batch path runs
   (`best_match_fused`) and as the [B, T] planes (`score_pairs_fused`),
   K2 as `overlap_pairs_mma`.  Each is held bit for bit against its
   plain PyTorch version on the card, then timed with CUDA events beside
   its plain version, the library call that computes the same function
   (K2: ``torch._int_mm`` on the unpacked operands) and the least time
   the card could take (its bound).  ``ms`` is the eager call as the
   batch path makes it; ``device_ms`` the same call replayed from a CUDA
   graph, without the host's launch overhead (the library call is timed
   both ways too: ``library_ms``, ``library_device_ms``).  The fused K1
   also runs at B=512 at both widths (the size of the slices' real
   Dice-bound chunks) and on a case of exact ties across the kernel's
   template splits and all-excluded rows.  Then the whole score step per
   4096-row batch, the argmax included, at both widths (K1 fused against
   K2 plus the score algebra and the argmax in PyTorch, K1's planes plus
   `topk_exact`, and K1 with the top-k fused, `topk_fused`, which the
   --closest path runs): the times `resolve_method`'s crossover rests
   on.  `topk_fused` (K1's third epilogue) is held bit for bit against
   its plain version at the four shapes above and on the ties case with
   k = 4 (--closest 3) and k = `K_FUSED_MAX`.  The fused K1 is also held
   bit for bit at the small batches `detect` gives it (B in `DETECT_B`,
   1 to 65, at both widths, random and ties) and timed at B=1, the
   DiceXLA matcher's launch, and at the flush sizes of `serve` (B in
   `SERVE_B`, 127 to 256, around its schedule's changes), timed at
   B=256, a full flush; K4's top-k (`topk_exact`,
   csrc/dice_topk.cu) on K1's planes at the four shapes with k = 4 and
   k = T, and on the ties case, whose all-excluded rows must give
   template 0 at (-1, 1) in every round.  Each is timed beside its bound
   (the bytes, or the exact compares that selecting k of T needs,
   `topk_compares`);
4. slice: `batch-detect` through the port's CLI on a ~2000-file manifest
   (the vendored templates rendered with field values, the test
   fixtures, and seeded word-level mutations of both), once through K1
   (--method pallas) and once through K2 (--method pallas-mxu); then
   the wide slice, `batch-detect --corpus DIR` over a 608-template
   synthetic SPDX directory (`corpus/spdx_synth.py`) on a ~1000-file
   manifest of its rendered templates and their mutations, through both
   kernels.  Each output must be byte-identical to the same run with
   --device cpu, each kernel must have launched during its run, and the
   K1 runs must have run neither the planes kernel nor an argmax on the
   card.  The native vendored run's first 600 rows must also be
   byte-identical to the same rows with LICENSEE_TPU_NO_NATIVE=1 (the
   pure-Python featurizer, in a child process);
5. default flags: `batch-detect` as a user types it (`auto` -> K1, the
   native featurizer, workers = the host's CPU count, --pipeline-depth
   2, --coalesce-batches 32, resume on) over a seeded manifest of 50,001
   vendored rows over 12,000 distinct files, most rows verbatim repeats
   of a few hundred texts, as in real license corpora; then the same
   over the T=608 manifest of phase 4.  Each output must be
   byte-identical to --device cpu and to --pipeline-depth 1 --workers 1
   (for the vendored run, over its first 12,001 rows).
   The vendored run's first 4,001 rows are also run with
   --featurize-procs (one spawned worker process per CPU) and must give
   the same bytes; its output is
   then cut mid-line and resumed: the sha256 must equal the full run's
   and the sidecar must not change.  A last run over the first 12,001
   rows under torch.profiler gives the card's busy and idle share.
   Every run prints rows/s, its stage seconds, the pipeline lanes'
   occupancy and the dispatch set-up split;
6. modes: the rest of `batch-detect`'s verdict surface at default flags
   over a seeded ~10,000-row mixed manifest laid out as crawls list
   repositories (LICENSE-likes, READMEs in markdown and HTML, package
   manifests, an unrouted source file per repo): --mode auto --closest 3
   --attribution, --mode readme and --mode package, each byte-identical
   to --device cpu and to --pipeline-depth 1 --workers 1, with the auto
   run's resume drill and torch.profiler runs of auto and readme; then
   --closest 3 over the T=608 manifest through K1 (`topk_fused`) and K2
   (--method matmul, then `topk_exact`) against --device cpu, and a
   `corpus-build` artifact of the SPDX directory through --corpus ART,
   byte-identical to --corpus DIR.  A --closest run through K1 fails
   unless it launched `topk_fused` and never `score_pairs_fused`,
   `topk_exact` or `best_match_fused`; one through K2 unless it launched
   `topk_exact`; neither may run the argmax on the card;
7. containers: the mixed manifest's 2,400 repositories packed as 800
   .tar, 600 .tar.gz, 600 .zip and 400 git repositories (git objects
   written in Python where git is missing) and listed as container
   entries, ~10,000 expanded rows, under --mode auto --closest 3
   --attribution and --mode license at default flags, each against
   --device cpu and --pipeline-depth 1 --workers 1 (the JSONL and
   OUT.containers.jsonl byte for byte) and, over the first 300 entries,
   --featurize-procs 4, and the resume drill, which must give both
   files' sha256 again;
8. detect: `detect` and `detect --json` over every fixture directory
   against fixtures.yml (read by the port's `corpus/yamlite.py`) and
   detect.json, four fixtures as git repositories (written in Python,
   read by the native object-store backend) against their directories,
   `license-path`, `version`, `help`, the bare-path default and `diff`'s
   exact-match and invalid-license branches (its word diff needs git);
   the DiceXLA matcher on the card against the scalar Dice on every
   fixture's license file, one `best_match_fused` launch a file; and
   `batch-detect` without --output over phase 4's vendored manifest,
   whose stdout rows must equal its --output rows and the --device cpu
   stdout rows.  A timing line gives the wall time of `detect` per
   fixture and DiceXLA's per file, eager and K1's graph replay, beside
   the card's name and power limit;
9. serve: the micro-batcher (`serve/scheduler.py`) at the CLI's
   defaults (warm start, --max-batch 256, --max-delay-ms 5,
   --pipeline-depth 2) on the card: in process through `serve_session`,
   a license session over vendored files of phase 4's kind and an auto
   session over a mixed crawl manifest, each with repeats; over a Unix
   socket (`UnixServer`, `serve_unix`'s server, in a thread) 64
   closed-loop clients in a child process, each keeping 8 requests in
   flight, send 5,000 requests (2,500 at T=608), mostly distinct
   Dice-bound variants
   (a test of K1 at every flush size up to 256, not a users' traffic
   mix), and one client sends one request at a time (every flush a
   deadline flush at B=1), at T=47 and with the 608-template corpus;
   each socket run is sent again, the same way, to a device='cpu'
   batcher, whose rows are the reference and whose timing stands
   beside the card's.  Every run's
   rows equal a device='cpu' batcher's, trace ID and cache flag aside,
   and the sessions' verdicts equal `batch-detect`'s over the same
   files.  Two more 64-client runs at T=47, at the interpreter's
   default switch interval and at a tenth of it, sample where the
   batcher's scheduler and completion threads stand (a stack sampler)
   and read their on-CPU seconds, to split the device stage's host
   time.  A reload to a `corpus-build` artifact of the T=608 directory
   runs in the middle of a 64-client run (its clients in this process,
   paced around the swap): no request errors, each row
   under the old or the new fingerprint and equal to the CPU verdict of
   its corpus, the cache fenced, a corrupt artifact refused.  Child
   processes of the port's CLI run `serve --selftest`, `serve
   --selftest-reload`, a piped `serve --stats` session and `diff
   --socket` against the in-process worker.  Every run must have had
   no fallback and no completion error, each bucket set up once before
   any live flush, and `best_match_fused` launched exactly once per
   flush, warm-up probe and reload validation, and no other kernel.  A
   `serve timing:` line gives each run's requests/s, the p50 and p99 of
   its total, queue_wait and device stages, its flush reasons and its
   flushes per bucket, the host batcher's beside each socket run, the
   two threads' split, and the card's busy share over a profiled
   64-client run, beside the card's name and power limit;
10. scale: K5 (`parallel/mesh.py:make_sharded_scorer`) on meshes that
   repeat the card, (1,1), (2,1), (1,2) and (2,2) at B=4096, T=47 and
   T=608, top-1 and top-3, bit-identical to the plain scorer with one K1
   launch a data shard or one K2 launch a (data, model) block, the
   (2,2) mesh timed beside its bound; then, reusing phases 4, 5 and 7's
   manifests and outputs: `batch-detect --mesh 1,1` and `--device-lanes
   1` against the default run at both widths; a `serve --mesh 1,1`
   session against a device='cpu' batcher; phase 7's 2,000 archives
   served over HTTP by a loopback blob host in a child process (the git
   checkouts stay local) under both of phase 7's modes, against
   --device cpu, --pipeline-depth 1 --workers 1 and phase 7's local run
   (entry paths aside; the two twins over the first 600 entries), and a
   remote git repository refused; --stripes
   1, 2 and 4 over the first 10,001 rows of phase 5's manifest, each
   merged output byte-identical to phase 5's first rows, with --stats-file (the merged stats
   must reconcile), --prom-file (each exposition must pass
   `check_exposition`, each stripe must have launched K1) and
   --progress; a stripe SIGKILLed mid-run (over the same rows)
   whose restart the runner counts and whose merge reaches the same
   sha256; --stripes elastic
   over phase 4's manifest; --stripes 2 over 200 remote containers; an
   archive republished between a cut and the resume, which must be
   refused; and `batch-detect --selftest`, `--selftest-remote` and
   `--selftest-autoscale` as child processes on the card, beside the
   whole phase.  A `stripes
   timing:` line gives each striped run's rows/s, summed read seconds
   and the card's utilization (nvidia-smi) beside its name and power
   limit;
11. fleet: `fleet --workers 2 --socket FRONT --http HOST:PORT` through
   the port's CLI, its two `serve` workers on the card at the CLI's
   defaults: phase 9's 5,000 T=47 variants from 64 front clients, 8 in
   flight each, then 4,000 of them from 16 keep-alive clients through
   the HTTP edge; worker w0 SIGKILLed a quarter into 2,000 more (zero
   client errors, one restart counted with its signal, the respawned
   worker answering and launching K1 again); a rolling reload through
   the front door to a `corpus-build` artifact of the T=608 directory a
   quarter into 2,000 more (each row under the old or the new corpus
   and equal to the CPU verdict under it, both workers' fingerprints
   moved); phase 9's 2,500 T=608 variants from 64 front clients and
   2,000 through the edge; 16 open-loop edge clients
   (`faults.open_loop_http_client`).  Every row equals a device='cpu'
   batcher's (phase 9's references), trace ID, cache flag and worker
   aside.  Then the verbs against the live fleet as child processes:
   `stats --format prometheus` (the merged exposition must pass
   `check_exposition`), the per-worker `stats` table, `traces`, `slo`
   (its exit code must be its verdict, availability must hold), `top`
   (one frame) and, once the watchdog has nothing firing, `alerts`;
   each worker must report `fallbacks` 0 and launch K1 and nothing
   else (its `device_kernel_launches` gauge); beside them, `fleet
   --selftest`, `--selftest-reload` and `--selftest-tcp` with real
   workers on the card, their `--stub` twins and `stats --selftest` as
   child processes.  The fleet must stop on SIGTERM with exit 0.  A
   `fleet timing:` line gives requests/s and total p50/p99 through the
   front and the edge at both widths, each worker's flushes and K1
   launches, restarts, seconds to boot the workers, to respawn one and
   to roll, the SLO burns, nvidia-smi's utilization and per-process
   memory, beside the card's name and power limit;
12. tenancy and jobs: `fleet --tenants REG --workers 1 --socket FRONT
   --http HOST:PORT --jobs-dir DIR --jobs-concurrency 2` through the
   port's CLI on the card, tenant acme's pool on the vendored corpus
   (T=47), tenant beta's on phase 5's synthetic SPDX directory (T=608):
   2,000 of phase 9's variants a tenant, tagged with the tenant's name
   under its bearer token through the edge from 8 keep-alive clients,
   each row equal to phase 9's device='cpu' reference, answered by the
   tenant's own worker and stamping its fingerprint (zero cross-tenant
   rows); acme's `POST /corpus` of a `corpus-build` artifact of the
   vendored SPDX mirror a quarter into 1,000 of beta's requests (beta's
   rows unaffected), then 1,000 of acme's under the new fingerprint
   against the CPU verdicts under it, and the registry file naming the
   rolled corpus; two jobs through the `jobs` verb: (a) phase 7's
   container manifest with `stripes: 2` at default options (K1 at
   T=47) and (b) phase 5's T=608 manifest with `{"corpus": DIR,
   "method": "matmul"}` (K2), each job's results and `.containers.jsonl`
   fetched by the verb byte-identical to the same spec on a
   `JobExecutor(device="cpu")` (job (a) also to phase 7's `--mode
   license` run), its stripes' merged exposition showing the kernel its
   options route to and no other; the pools' workers with no fallback
   and K1 alone; and beside them `fleet --selftest-tenant` and
   `--selftest-jobs` with real workers and stripes on the card and
   their `--stub` twins as child processes, and the native featurizer's
   parity selftest (`native/selftest.py`; its ``SKIP``, no native
   library, is a failure).  The fleet must stop on SIGTERM with exit 0.  A `jobs timing:` line gives each job's rows/s
   over submit to completed, the jobs drill's resume seconds, the roll's
   seconds, each tenant run's requests/s and p50/p99 and each selftest's
   seconds, beside the card's name and power limit.

A row's ``launches`` counts its kernel over its width's card runs of
phases 4 to 8 and 10 to 12, each run between a reset of the counts and
a read (the B=1 row at T=47: phase 8's DiceXLA run; the B=256 rows:
phase 9's runs at their width, the reload's at T=47, phase 11's
workers' gauges, read before the kill, before the roll (T=47) and at the
end, and phase 12's tenant workers' (acme's at T=47 on both of its
corpora, beta's at T=608); the main rows also phase 12's jobs' stripes,
job (a)'s K1 at T=47 and job (b)'s K2 at T=608; K5's rows: phase 10's
`--mesh 1,1` runs); the planes kernel (`score_pairs_fused`) launches on
no main path.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it the JSON of every kernel's numbers.  Any failure exits
non-zero before those lines are printed.  Before it exits, whatever the
outcome, the script ends and reaps every process it started that is
still there (`stop_children`: multiprocessing's resource tracker, which
--featurize-procs' pool leaves running, and any orphan it adopted).
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# published peaks of one H100 SXM (dense, 700 W): the HBM rate and the
# int8 tensor cores (K2)
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# K1's units, per SM and clock (times the SM count and the card's maximum
# SM clock, `nvidia-smi --query-gpu=clocks.max.sm`): 64 results of 32-bit
# logic or integer add on the CUDA cores (the CUDA C++ Programming
# Guide's throughput table, compute capability 9.0; population counts
# get 16), and 1024 pair-words (32-bit AND-then-popcount products) on the
# single-bit tensor cores: 8x the int8 rate of 4096 multiply-adds a clock,
# the binary-to-int8 ratio NVIDIA published for the A100 (it publishes no
# binary rate for Hopper)
INT_OPS_PER_CLK_SM = 64
B1_PAIR_WORDS_PER_CLK_SM = 1024
# K1's integer operations per (blob, template) pair besides the overlap:
# the score algebra (|len_t - len_b| - slack: sub, abs, sub; the clamp;
# shift and two adds; the exclusion test; num's select; denom <= 0 and
# den's select) 10, and for the first-max the exact compare (two int64
# products, a compare, the update) 4 more
K1_PAIR_OPS = {"planes": 10, "best": 14}
# the top-k's integer operations per exact compare (two int64 products, a
# compare, the update), as in K1's first-max.  The bound counts the
# compares the function needs, not the kernel's k rounds over T: a
# tournament over a row takes T - 1 compares for its winner and
# ceil(log2 T) more for each later one (`topk_compares`)
TOPK_COMPARE_OPS = 4
# the --closest path's k at the CLI's --closest 3 (k = closest + 1)
CLOSEST = 3

MAIN_B = 4096  # batch-detect's default --batch-size: the main path's chunk
SPDX_T = 608   # the synthetic SPDX directory's template count (W=132)
SHAPES = [
    # (label, B, T, W, the slice run whose launches the row reports)
    ("main", MAIN_B, 47, 112, "vendored"),
    ("main608", MAIN_B, SPDX_T, 132, "spdx"),
    ("B262144,T47,W112", 262144, 47, 112, "vendored"),
    ("B262144,T608,W132", 262144, SPDX_T, 132, "spdx"),
]
# the fused K1 also at the size of the slices' real Dice-bound chunks
# (347 to 1565 rows), and on a case of exact ties and excluded rows
SMALL_SHAPES = [
    ("B512,T47,W112", 512, 47, 112, "vendored"),
    ("B512,T608,W132", 512, SPDX_T, 132, "spdx"),
]
TIES_SHAPE = ("ties,B347,T608,W132", 347, SPDX_T, 132, "spdx")
# the fused K1 at the batches `detect`'s DiceXLA matcher (one file a call)
# and small stdout batch-detect runs give it, held at both widths; B=1 is
# also timed (the matcher's launch: its row counts phase 8's launches)
DETECT_B = (1, 2, 7, 8, 9, 16, 17, 63, 64, 65)
DETECT_SHAPES = [
    ("B1,T47,W112", 1, 47, 112, "detect"),
    ("B1,T608,W132", 1, SPDX_T, 132, "spdx"),
]
# the fused K1 at the flush sizes of `serve` (its real row count, 1 to
# 256) around its schedule's changes at T=608: a 64-row tile more at 128,
# 192 and 256, 76 splits of 8 templates up to B=192 and 38 of 16 from
# B=193, with a partial last tile below 256; the full flush is timed, its
# row counting phase 9's launches at its width
SERVE_B = (127, 128, 129, 192, 193, 255, 256)
SERVE_SHAPES = [
    ("B256,T47,W112", 256, 47, 112, "serve"),
    ("B256,T608,W132", 256, SPDX_T, 132, "serve608"),
]

FIELD_VALUES = {
    "fullname": "Ben Balter",
    "year": "2018",
    "email": "ben@github.invalid",
    "projecturl": "http://github.invalid/benbalter/licensee",
    "login": "benbalter",
    "project": "Licensee",
    "description": "Detects licenses",
}


def log(msg: str) -> None:
    print(msg, flush=True)


# -- processes: nothing the script starts outlives it --------------------------

PR_SET_CHILD_SUBREAPER = 36  # <linux/prctl.h>


def adopt_orphans() -> None:
    """Make this process the reaper of its descendants whose parent ends
    first (Linux prctl), so that `stop_children` finds them as children."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        print(f"chip_smoke: prctl(PR_SET_CHILD_SUBREAPER) failed: "
              f"{os.strerror(ctypes.get_errno())}", file=sys.stderr)


def children() -> dict[int, str]:
    """{pid: command line} of every process whose parent is this one,
    exited ones not yet reaped included."""
    me, found = os.getpid(), {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat", encoding="utf-8",
                      errors="replace") as fh:
                stat = fh.read()
            with open(f"/proc/{name}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        # the fields after the command name in parentheses: state, ppid
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            found[int(name)] = cmd.strip() or stat.split(" ", 2)[1]
    return found


def stop_children(grace_s: float = 30.0) -> None:
    """End and reap every process the script started that is still there.

    --featurize-procs' spawned pool leaves multiprocessing's resource
    tracker running beside this process until the interpreter's end; it
    ignores SIGTERM and ends when its pipe closes, so it is stopped that
    way and waited for.  Any other child gets SIGTERM, then SIGKILL after
    ``grace_s``; each one stopped is named on stderr."""
    import signal
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        print(f"chip_smoke: stopping multiprocessing's resource tracker "
              f"(pid {tracker._pid})", file=sys.stderr)
        os.close(tracker._fd)
        os.waitpid(tracker._pid, 0)
        tracker._fd = tracker._pid = None
    deadline = time.monotonic() + grace_s
    named = set()
    while left := children():
        sig = signal.SIGTERM if time.monotonic() < deadline else signal.SIGKILL
        for pid, cmd in left.items():
            if pid not in named:
                named.add(pid)
                print(f"chip_smoke: stopping pid {pid}: {cmd[:200]}",
                      file=sys.stderr)
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
            with contextlib.suppress(ChildProcessError):
                os.waitpid(pid, os.WNOHANG)
        time.sleep(0.05)


# -- phase 1: device ---------------------------------------------------------


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device(torch) -> tuple[dict, float]:
    """The last line's device object, and the card's SM count times its
    maximum SM clock (SM-clocks per second, for K1's bound)."""
    log(smi("name,power.limit"))
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(smi("clocks.max.sm").split()[0])
    log(f"device: {device['kind']} x{device['count']} (torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}); {n_sms} SMs, "
        f"max SM clock {max_mhz:g} MHz")
    return device, n_sms * max_mhz * 1e6


# -- phase 2: build ------------------------------------------------------------


def load_native() -> float:
    """Build (if stale) and load the native featurizer; raises with g++'s
    or the loader's message unless it loads (`pipeline.load()` would
    turn that into None, and the run into the Python fallback).
    Returns the seconds it took."""
    from licensee_tpu_torch.native import build, pipeline, textops

    t0 = time.perf_counter()
    build.build_and_load("pipeline", (":libpcre2-8.so.0",))
    build.build_and_load("textops")
    if pipeline.load() is None or textops.load() is None:
        raise RuntimeError("the native featurizer did not load")
    return time.perf_counter() - t0


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from licensee_tpu_torch.kernels import build

    pcre = subprocess.run(["ldconfig", "-p"], capture_output=True,
                          text=True).stdout
    log("libpcre2: " + "; ".join(
        line.strip() for line in pcre.splitlines() if "pcre2-8" in line))
    t0 = time.perf_counter()
    # g++ for the native featurizer runs beside the nvcc processes
    with ThreadPoolExecutor(max_workers=1) as pool:
        native = pool.submit(load_native)
        report = build.build(verbose=True)
        log(f"build: {len(build.sources())} sources -> {build.LIBRARY} in "
            f"{time.perf_counter() - t0:.1f} s")
        native_s = native.result()
    from licensee_tpu_torch.native import build as native_build

    log(f"build: native featurizer -> {native_build.LIB_DIR} loaded after "
        f"{native_s:.1f} s")
    for line in report.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling", "C75")):
            log("  ptxas: " + line.strip())
    build.load_library()


# -- phase 3: kernels ----------------------------------------------------------


def cuda_time_ms(torch, fn, min_total_s: float = 0.3, max_iters: int = 50,
                 min_iters: int = 3):
    """Mean milliseconds per call over a run of calls timed by CUDA
    events, after a warm-up call; the count adapts to the call's time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    iters = int(max(min_iters, min(max_iters, min_total_s / max(once, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(torch, fn, out_bytes: int):
    """Device milliseconds per call of ``fn``: the call captured in a
    CUDA graph (several times over where its output is small) and the
    graph replayed, so the host's launch overhead drops out."""
    reps = max(1, min(20, (256 << 20) // max(out_bytes, 1)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_time_ms(torch, graph.replay) / reps
    del graph
    return ms


def random_case(np, torch, rng, B, T, W):
    """Seeded corpus constants and blob features of the given widths:
    dense random bitsets, and columns in the ranges real corpora have."""
    dev = "cuda"
    bits = rng.integers(0, 2**32, size=(T, W), dtype=np.uint32)
    file_bits = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    cols = {
        "n_wf": rng.integers(50, 3000, T),
        "n_fieldset": rng.integers(0, 4, T),
        "field_count": rng.integers(0, 6, T),
        "alt_count": rng.integers(0, 40, T),
        "length": rng.integers(100, 60000, T),
    }
    from licensee_tpu_torch.kernels.dice_ref import CorpusTensors

    def t32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    ct = CorpusTensors(
        bits=torch.from_numpy(bits.view(np.int32)).to(dev),
        n_wf=t32(cols["n_wf"]),
        n_fieldset=t32(cols["n_fieldset"]),
        field_count=t32(cols["field_count"]),
        alt_count=t32(cols["alt_count"]),
        length=t32(cols["length"]),
        cc_flag=torch.from_numpy(rng.random(T) < 0.1).to(dev),
        valid=torch.from_numpy(rng.random(T) < 0.95).to(dev),
    )
    feats = (
        torch.from_numpy(file_bits.view(np.int32)).to(dev),
        t32(rng.integers(0, 3000, B)),
        t32(rng.integers(0, 60000, B)),
        torch.from_numpy(rng.random(B) < 0.1).to(dev),
    )
    return ct, feats


def max_abs_err(torch, got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def k1_bound(B, T, W, epilogue: str, sm_clocks_per_s: float):
    """K1's least time: (bytes, operations ms, how the operations were
    counted).  Bytes: the blob and template words, the meta rows and the
    blob columns in, the outputs out.  Operations: the B·T·W pair-words
    on the single-bit tensor cores against the score algebra (and
    compare) on the CUDA cores, whichever takes longer: the two units
    run side by side."""
    out = 3 * B * 4 if epilogue == "best" else 2 * B * T * 4
    n_bytes = B * W * 4 + T * W * 4 + T * 8 * 4 + B * 9 + out
    tensor_ms = B * T * W / (B1_PAIR_WORDS_PER_CLK_SM * sm_clocks_per_s) * 1e3
    alu_ops = B * T * K1_PAIR_OPS[epilogue]
    alu_ms = alu_ops / (INT_OPS_PER_CLK_SM * sm_clocks_per_s) * 1e3
    how = (f"{B * T * W} b1 pair-words, {tensor_ms:.5f} ms; {alu_ops} "
           f"integer ops, {alu_ms:.5f} ms")
    return n_bytes, max(tensor_ms, alu_ms), how


def k1_topk_bound(B, T, W, k, sm_clocks_per_s):
    """K1 with the top-k fused: its bytes (the inputs as for the other
    epilogues, k (idx, num, den) triples a blob out) and operations (the
    pair-words on the single-bit tensor cores against the score algebra
    of every pair plus the exact compares that selecting k of T needs,
    `topk_compares`, on the CUDA cores)."""
    n_bytes = B * W * 4 + T * W * 4 + T * 8 * 4 + B * 9 + 3 * B * k * 4
    tensor_ms = B * T * W / (B1_PAIR_WORDS_PER_CLK_SM * sm_clocks_per_s) * 1e3
    alu_ops = (B * T * K1_PAIR_OPS["planes"]
               + B * topk_compares(T, k) * TOPK_COMPARE_OPS)
    alu_ms = alu_ops / (INT_OPS_PER_CLK_SM * sm_clocks_per_s) * 1e3
    how = (f"{B * T * W} b1 pair-words, {tensor_ms:.5f} ms; {alu_ops} "
           f"integer ops (the algebra, and {topk_compares(T, k)} compares "
           f"a row to select {k} of {T}), {alu_ms:.5f} ms")
    return n_bytes, max(tensor_ms, alu_ms), how


def topk_fused_rows(torch, label, B, T, W, run, args,
                    sm_clocks_per_s) -> list[dict]:
    """`topk_fused` (K1 with the top-k in its epilogue) at one shape, for
    k = closest + 1 and k = K_FUSED_MAX: each held bit for bit against its
    plain version and timed beside its bound."""
    from licensee_tpu_torch.kernels import dice_cuda

    rows = []
    for k in (CLOSEST + 1, dice_cuda.K_FUSED_MAX):
        def fn(k=k):
            return dice_cuda.topk_fused(*args, k)

        def plain(k=k):
            return dice_cuda.topk_fused_plain(*args, k)

        err = held_against_plain(torch, f"topk_fused {label} k={k}", fn,
                                 plain)
        n_bytes, ops_ms, how = k1_topk_bound(B, T, W, k, sm_clocks_per_s)
        rows.append(kernel_row(
            torch, f"topk_fused@{label},k{k}", "dice_score_fused.cu",
            "licensee_tpu/kernels/dice_pallas.py:482", B, T, W, run, err,
            fn, plain, None, n_bytes, ops_ms, how, out_bytes=3 * B * k * 4,
            shape={"B": B, "T": T, "W": W, "k": k},
        ))
    return rows


def held_against_plain(torch, what, fn, plain) -> int:
    """The kernel's outputs against its plain version's; raises unless
    they agree bit for bit."""
    got, want = fn(), plain()
    torch.cuda.synchronize()
    err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    if err:
        raise AssertionError(f"{what}: kernel != plain (max {err})")
    return err


def k1_rows(torch, label, B, T, W, run, args, sm_clocks_per_s,
            epilogues=("best", "planes")) -> list[dict]:
    """K1's rows at one shape: the fused first-max (`best_match_fused`)
    and the planes (`score_pairs_fused`), each held against its plain
    version and timed."""
    from licensee_tpu_torch.kernels import dice_cuda

    suffix = "" if label == "main" else f"@{label}"
    entries = {
        "best": ("best_match_fused", dice_cuda.best_match_fused,
                 dice_cuda.best_match_fused_plain),
        "planes": ("score_pairs_fused", dice_cuda.score_pairs_fused,
                   dice_cuda.score_pairs_fused_plain),
    }
    rows = []
    for epilogue in epilogues:
        name, kernel, plain_fn = entries[epilogue]

        def fn(kernel=kernel):
            return kernel(*args)

        def plain(plain_fn=plain_fn):
            return plain_fn(*args)

        err = held_against_plain(torch, f"{name} {label}", fn, plain)
        n_bytes, ops_ms, how = k1_bound(B, T, W, epilogue, sm_clocks_per_s)
        rows.append(kernel_row(
            torch, name + suffix, "dice_score_fused.cu",
            "licensee_tpu/kernels/dice_pallas.py:482", B, T, W, run, err,
            fn, plain, None, n_bytes, ops_ms, how,
            out_bytes=3 * B * 4 if epilogue == "best" else 2 * B * T * 4,
        ))
    return rows


def ties_case(np, torch, rng, B, T, W):
    """K1's inputs with exact ties and excluded rows: template t repeats
    template t mod (the kernel's slice of the templates at this B), in
    even pairs, so equal scores straddle every split boundary; half the
    blobs are copies of templates; every template is CC, so the rows
    under the CC false-positive flag (every fourth) have every template
    excluded."""
    from licensee_tpu_torch.kernels import dice_cuda

    ct, (fb, nw, ln, cf) = random_case(np, torch, rng, B, T, W)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_split = dice_cuda.fused_schedule(B, T, W, n_sms)[1]
    src = (torch.arange(T, device="cuda") % per_split) // 2 * 2
    meta = dice_cuda.pack_meta(ct)[src].contiguous()
    meta[:, dice_cuda.CC_FLAG] = 1
    meta[:, dice_cuda.VALID] = 1
    bits = ct.bits[src].contiguous()
    copy = torch.from_numpy(rng.integers(0, T, B)).to("cuda")
    fb = fb.clone()
    fb[::2] = bits[copy[::2]]
    nw = nw.clone()
    nw[::2] = meta[copy[::2], dice_cuda.N_WF]
    cf = torch.zeros(B, dtype=torch.bool, device="cuda")
    cf[::4] = True
    return meta, bits, fb, nw, ln, cf


def phase_kernels(np, torch, seed: int, sm_clocks_per_s: float) -> list[dict]:
    from licensee_tpu_torch.kernels import dice_cuda, dice_ref

    rng = np.random.default_rng(seed)
    rows = []
    for label, B, T, W, run in SHAPES:
        ct, (fb, nw, ln, cf) = random_case(np, torch, rng, B, T, W)
        meta = dice_cuda.pack_meta(ct)
        tpl_i8 = dice_cuda.pack_templates_mma(ct)
        v_pad = tpl_i8.shape[1]
        suffix = "" if label == "main" else f"@{label}"

        # K1: the single-bit tensor-core overlap, the score algebra and
        # (best) the exact first-max or (topk_fused) the top-k, fused
        rows += k1_rows(torch, label, B, T, W, run,
                        (meta, ct.bits, fb, nw, ln, cf), sm_clocks_per_s)
        rows += topk_fused_rows(torch, label, B, T, W, run,
                                (meta, ct.bits, fb, nw, ln, cf),
                                sm_clocks_per_s)

        # K2: fused unpack + int8 tensor-core overlap
        def k2():
            return dice_cuda.overlap_pairs_mma(tpl_i8, fb, T)

        def k2_plain():
            return dice_cuda.overlap_pairs_mma_plain(tpl_i8, fb, T)

        err = held_against_plain(torch, f"K2 {label}", lambda: [k2()],
                                 lambda: [k2_plain()])
        # the library yardstick: cuBLAS's int8 product on operands the
        # library cannot unpack itself (unpacked here, outside the timing)
        lhs = torch.zeros((B, v_pad), dtype=torch.int8, device="cuda")
        lhs[:, : 32 * W] = dice_ref.unpack_bits(fb)
        k2_library = None
        for rhs in (tpl_i8.T, tpl_i8.T.contiguous()):  # [v_pad, t_pad]
            try:
                lib = torch._int_mm(lhs, rhs)[:, :T]
                torch.cuda.synchronize()
            except RuntimeError as exc:
                log(f"torch._int_mm refused {label} operands: {exc}")
                continue
            lib_err = max_abs_err(torch, lib, k2())
            if lib_err:
                raise AssertionError(f"K2 {label}: _int_mm != kernel "
                                     f"(max {lib_err})")
            del lib
            k2_library = functools.partial(torch._int_mm, lhs, rhs)
            break
        # the template rows and columns the contraction needs: T rows of
        # 32·W unpacked bytes, not the tile padding of tpl_i8
        k2_bytes = B * W * 4 + T * 32 * W + B * T * 4
        k2_ops = 2 * B * T * 32 * W
        rows.append(kernel_row(
            torch, "overlap_pairs_mma" + suffix, "dice_overlap_mma.cu",
            "licensee_tpu/kernels/dice_pallas.py:355", B, T, W, run, err,
            k2, k2_plain, k2_library, k2_bytes,
            k2_ops / INT8_TENSOR_OPS_PER_S * 1e3,
            f"{k2_ops} int8 tensor-core ops", out_bytes=B * T * 4,
        ))
        if B == MAIN_B:
            time_scorers(torch, label, ct, meta, tpl_i8, (fb, nw, ln, cf))
        del k2_library, lhs, ct, fb, nw, ln, cf, meta, tpl_i8
        torch.cuda.empty_cache()

    for label, B, T, W, run in SMALL_SHAPES:
        ct, feats = random_case(np, torch, rng, B, T, W)
        rows += k1_rows(torch, label, B, T, W, run,
                        (dice_cuda.pack_meta(ct), ct.bits, *feats),
                        sm_clocks_per_s, epilogues=("best",))
    rows += small_batches(np, torch, rng, sm_clocks_per_s)
    label, B, T, W, run = TIES_SHAPE
    args = ties_case(np, torch, rng, B, T, W)
    idx, num, den = dice_cuda.best_match_fused(*args)
    cf = args[5]
    if not ((idx[cf] == 0).all() and (num[cf] == -1).all()
            and (den[cf] == 1).all()):
        raise AssertionError("ties: an all-excluded row is not (0, -1, 1)")
    rows += k1_rows(torch, label, B, T, W, run, args, sm_clocks_per_s,
                    epilogues=("best",))
    for k in (CLOSEST + 1, dice_cuda.K_FUSED_MAX):
        idx, knum, kden = dice_cuda.topk_fused(*args, k)
        if not ((idx[cf] == 0).all() and (knum[cf] == -1).all()
                and (kden[cf] == 1).all()):
            raise AssertionError(f"topk_fused ties k={k}: an all-excluded "
                                 "row is not (0, -1, 1) in every round")
    rows += topk_fused_rows(torch, label, B, T, W, run, args,
                            sm_clocks_per_s)
    rows += topk_rows(np, torch, rng, args, sm_clocks_per_s)
    return rows


def small_batches(np, torch, rng, sm_clocks_per_s) -> list[dict]:
    """The fused K1 at each of `DETECT_B` and `SERVE_B` at T=47 and
    T=608, held bit for bit against its plain version on random features
    and on the ties case (copies of templates, exact ties across the
    template splits, every fourth row with every template excluded);
    then the rows of `DETECT_SHAPES` (B=1) and `SERVE_SHAPES` (B=256),
    timed."""
    from licensee_tpu_torch.kernels import dice_cuda

    for B in DETECT_B + SERVE_B:
        for T, W in ((47, 112), (SPDX_T, 132)):
            ct, feats = random_case(np, torch, rng, B, T, W)
            args = (dice_cuda.pack_meta(ct), ct.bits, *feats)
            held_against_plain(torch, f"best_match_fused B={B} T={T}",
                               lambda: dice_cuda.best_match_fused(*args),
                               lambda: dice_cuda.best_match_fused_plain(*args))
            ties = ties_case(np, torch, rng, B, T, W)
            idx, num, den = got = dice_cuda.best_match_fused(*ties)
            held_against_plain(
                torch, f"best_match_fused ties B={B} T={T}", lambda: got,
                lambda: dice_cuda.best_match_fused_plain(*ties))
            cf = ties[5]
            if not ((idx[cf] == 0).all() and (num[cf] == -1).all()
                    and (den[cf] == 1).all()):
                raise AssertionError(f"ties B={B} T={T}: an all-excluded "
                                     "row is not (0, -1, 1)")
    log(f"best_match_fused: bit-identical to its plain version at B in "
        f"{list(DETECT_B + SERVE_B)} at T=47 and T={SPDX_T}, random and "
        f"ties")
    rows = []
    for label, B, T, W, run in DETECT_SHAPES + SERVE_SHAPES:
        ct, feats = random_case(np, torch, rng, B, T, W)
        rows += k1_rows(torch, label, B, T, W, run,
                        (dice_cuda.pack_meta(ct), ct.bits, *feats),
                        sm_clocks_per_s, epilogues=("best",))
    return rows


def topk_row(torch, label, num, den, k, run, sm_clocks_per_s) -> dict:
    """`topk_exact` on one pair of planes: held bit for bit against its
    plain version (`dice_ref.topk_candidates`) and timed beside its
    bound: the planes' bytes against the exact compares a tournament
    needs to select k of T (`topk_compares`)."""
    from licensee_tpu_torch.kernels import dice_cuda

    B, T = num.shape

    def fn():
        return dice_cuda.topk_exact(num, den, k)

    def plain():
        return dice_cuda.topk_exact_plain(num, den, k)

    err = held_against_plain(torch, f"topk_exact {label} k={k}", fn, plain)
    n_bytes = 2 * B * T * 4 + 3 * B * k * 4
    compares = topk_compares(T, k)
    ops = B * compares * TOPK_COMPARE_OPS
    return kernel_row(
        torch, f"topk_exact@{label},k{k}", "dice_topk.cu",
        "licensee_tpu/kernels/dice_xla.py:248", B, T, None, run, err, fn,
        plain, None, n_bytes,
        ops / (INT_OPS_PER_CLK_SM * sm_clocks_per_s) * 1e3,
        f"{ops} integer ops ({B} rows x {compares} compares to select "
        f"{k} of {T} x {TOPK_COMPARE_OPS})", out_bytes=3 * B * k * 4,
        shape={"B": B, "T": T, "k": k},
    )


def topk_compares(T: int, k: int) -> int:
    """The exact compares that selecting the top k of T entries needs: a
    tournament's T - 1 for the winner, then ceil(log2 T) to replay each
    later winner's path.  Fewer than the kernel's k rounds of T, and at
    k = T fewer than a sort's network."""
    return (T - 1) + (k - 1) * max(1, (T - 1).bit_length())


def topk_rows(np, torch, rng, ties_args, sm_clocks_per_s) -> list[dict]:
    """K4's top-k on K1's planes at the main paths' shapes and at
    B=262144, with k = closest + 1 (the --closest 3 path) and k = T,
    then on the ties case, whose all-excluded rows (every fourth) must
    return template 0 at (-1, 1) in every round: the repeat-index case
    of k rounds of a masked first-max."""
    from licensee_tpu_torch.kernels import dice_cuda

    rows = []
    for label, B, T, W, run in SHAPES:
        ct, feats = random_case(np, torch, rng, B, T, W)
        num, den = dice_cuda.score_pairs_fused(
            dice_cuda.pack_meta(ct), ct.bits, *feats)
        del ct, feats
        shape = "main" if label == "main" else label
        for k in (CLOSEST + 1, T):
            rows.append(topk_row(torch, shape, num, den, k, run,
                                 sm_clocks_per_s))
        del num, den
        torch.cuda.empty_cache()
    label, B, T, W, run = TIES_SHAPE
    num, den = dice_cuda.score_pairs_fused(*ties_args)
    cf = ties_args[5]
    for k in (CLOSEST + 1, T):
        idx, knum, kden = dice_cuda.topk_exact(num, den, k)
        if not ((idx[cf] == 0).all() and (knum[cf] == -1).all()
                and (kden[cf] == 1).all()):
            raise AssertionError(f"topk ties k={k}: an all-excluded row is "
                                 "not (0, -1, 1) in every round")
        rows.append(topk_row(torch, label, num, den, k, run,
                             sm_clocks_per_s))
    return rows


def time_scorers(torch, label, ct, meta, tpl_i8, feats) -> None:
    """The whole score step of one batch as `make_best_match_fn` runs it
    per method, the argmax included: K1 fused (one launch), or K2, then
    the score algebra and the exact argmax in PyTorch."""
    from licensee_tpu_torch.kernels import dice_cuda, dice_ref

    def k1():
        return dice_cuda.best_match_fused(meta, ct.bits, *feats)

    def k2():
        overlap = dice_cuda.overlap_pairs_mma(tpl_i8, feats[0], ct.n_templates)
        return dice_ref.argmax_exact(
            *dice_ref.finish_scores(ct, overlap, *feats[1:]))

    def k1_topk():
        return dice_cuda.topk_exact(*dice_cuda.score_pairs_fused(
            meta, ct.bits, *feats), CLOSEST + 1)

    def k1_topk_fused():
        return dice_cuda.topk_fused(meta, ct.bits, *feats, CLOSEST + 1)

    held_against_plain(torch, f"scorers {label}", k1, k2)
    held_against_plain(torch, f"scorers {label} top-1 of top-k",
                       lambda: [t[:, 0] for t in k1_topk()], k1)
    held_against_plain(torch, f"scorers {label} top-k fused", k1_topk_fused,
                       k1_topk)
    B, T = feats[0].shape[0], ct.n_templates
    for method, fn in (("K1 fused", k1), ("K2+algebra+argmax", k2),
                       (f"K1 planes + top-k (k={CLOSEST + 1})", k1_topk),
                       (f"K1 + top-k fused (k={CLOSEST + 1})",
                        k1_topk_fused)):
        log(f"scorer {method} @{label}: B={B} T={T} "
            f"ms={cuda_time_ms(torch, fn):.4f} "
            f"device_ms={graph_time_ms(torch, fn, 2 * B * T * 4):.4f}")


def kernel_row(torch, name, source, replaces, B, T, W, run, err, fn, plain,
               library, n_bytes, ops_ms, ops_how, out_bytes,
               shape=None) -> dict:
    ms = cuda_time_ms(torch, fn)
    device_ms = graph_time_ms(torch, fn, out_bytes)
    # the plain versions take seconds at B=262144: one timed call there
    plain_ms = cuda_time_ms(torch, plain, min_total_s=0.5, max_iters=5,
                            min_iters=1)
    library_ms = library_device_ms = None
    if library:
        library_ms = cuda_time_ms(torch, library)
        library_device_ms = graph_time_ms(torch, library, out_bytes)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    row = {
        "name": name,
        "route": "cuda",
        "source": "licensee_tpu_torch/csrc/" + source,
        "replaces": replaces,
        "launches": 0,  # filled from the slice run `run` (phase 4)
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "device_ms": device_ms,
        "library_device_ms": library_device_ms,
        "shape": shape or {"B": B, "T": T, "W": W},
        "slice_run": run,
    }

    def fmt(x):
        return "null" if x is None else f"{x:.4f}"

    dims = " ".join(f"{k}={v}" for k, v in row["shape"].items())
    log(f"kernel {name}: {dims} max_abs_err={err} "
        f"kernel_ms={ms:.4f} device_ms={device_ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={fmt(library_ms)} "
        f"library_device_ms={fmt(library_device_ms)} "
        f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}; "
        f"{n_bytes} bytes, {bytes_ms:.5f} ms; {ops_how})")
    return row


# -- phase 4: the slice ----------------------------------------------------------


def mutate(text: str, rng, rate: float) -> str:
    """Seeded word-level edits: each word is kept, dropped, doubled or
    replaced by a made-up word with total probability ``rate``."""
    parts = re.split(r"(\s+)", text)
    out = []
    for p in parts:
        if not p or p.isspace():
            out.append(p)
            continue
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(p + " " + p)
        elif r < rate:
            out.append("zq" + "".join(rng.choice(list("abcdefgh"), 5)))
        else:
            out.append(p)
    return "".join(out)


def vendored_bases() -> list:
    """(name, text) of the vendored templates rendered with field values,
    then of the test fixtures."""
    from licensee_tpu_torch.corpus.fields import field_regex
    from licensee_tpu_torch.corpus.license import License

    bases = []
    for lic in License.all(hidden=True, pseudo=False):
        text = field_regex().sub(
            lambda m: FIELD_VALUES[m.group(1)], lic.content or "")
        bases.append((f"{lic.key}.LICENSE", text))
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures")
    for dirpath, _dirs, files in sorted(os.walk(fixtures)):
        if os.path.relpath(dirpath, fixtures).split(os.sep)[0] == "analysis":
            continue  # the static analyzer's Python fixtures
        for f in sorted(files):
            if f.endswith((".json", ".yml")):
                continue
            with open(os.path.join(dirpath, f), "rb") as fh:
                raw = fh.read()
            if len(raw) <= 64 * 1024:
                bases.append((f, raw.decode("utf-8", errors="ignore")))
    return bases


def write_files(items: list) -> None:
    """Write each (path, text) of ``items``, its directory made, from 8
    threads: on a slow file system the latency of each create, not the
    CPU, bounds a manifest's set-up."""
    from concurrent.futures import ThreadPoolExecutor

    def one(item) -> None:
        path, text = item
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(text)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, items))


def write_manifest(np, root: str, seed: int, n_files: int = 2000) -> str:
    """The vendored slice's manifest: the vendored templates rendered with
    field values and the test fixtures, then seeded mutations of them."""
    return write_rows(np, root, vendored_bases(), seed, n_files)


def write_big_manifest(np, root: str, seed: int, n_files: int = 12000,
                       n_rows: int = 50000) -> str:
    """The default-flags manifest: ``n_files`` distinct files, each a
    rendered template or fixture (seven in ten, verbatim) or a seeded
    mutation of one, listed once each and then ``n_rows - n_files``
    times more in a seeded order, and one path that cannot be read."""
    rng = np.random.default_rng(seed + 1)
    bases = vendored_bases()
    rates = (0.002, 0.01, 0.03, 0.1, 0.3)
    items = []
    for i in range(n_files):
        name, text = bases[int(rng.integers(len(bases)))]
        if rng.random() < 0.3:
            text = mutate(text, rng, rates[int(rng.integers(len(rates)))])
        items.append((os.path.join(root, f"f{i // 1000:02d}",
                                   f"{i:05d}.{name}"), text))
    write_files(items)
    files = [path for path, _text in items]
    rows = files + [files[int(j)]
                    for j in rng.integers(0, n_files, n_rows - n_files)]
    rows.append(os.path.join(root, "missing", "LICENSE"))
    manifest = os.path.join(root, "manifest.txt")
    with open(manifest, "w", encoding="utf-8") as fh:
        fh.write("\n".join(rows) + "\n")
    return manifest


def write_spdx_manifest(np, root: str, spdx_dir: str, seed: int,
                        n_files: int = 1000) -> str:
    """The wide slice's manifest: every template of an SPDX
    license-list-XML directory as rendered text, then seeded mutations."""
    from licensee_tpu_torch.corpus.spdx import load_spdx_dir

    bases = [(f"{t.key}.LICENSE", t.content) for t in load_spdx_dir(spdx_dir)]
    return write_rows(np, root, bases, seed, n_files)


# declared licenses of the generated package manifests: SPDX ids, the
# spellings each ecosystem's tools accept, and values no template has
DECLARED = ("MIT", "mit", "Apache-2.0", "GPL-3.0", "GPL-2.0", "LGPL-3.0",
            "BSD-3-Clause", "BSD-2-Clause", "ISC", "MPL-2.0", "Unlicense",
            "AGPL-3.0", "UNLICENSED", "Proprietary", "MIT OR Apache-2.0")
CRAN_DECLARED = ("GPL-3", "GPL-2", "MIT + file LICENSE", "GPL (>= 2)",
                 "LGPL-3", "BSD_3_clause + file LICENSE")
CABAL_DECLARED = ("BSD3", "BSD2", "GPL-3", "LGPL-3", "MIT", "AGPL-3")


def package_files(rng, i: int) -> list:
    """(name, text) of the package manifests of crawl repo ``i``: a
    seeded subset of package.json, a gemspec, Cargo.toml, an R
    DESCRIPTION and a cabal file, each declaring a license (or, now and
    then, none)."""
    def lic(pool):
        return pool[int(rng.integers(len(pool)))]

    files = []
    if rng.random() < 0.6:
        field = (f'  "license": "{lic(DECLARED)}",\n'
                 if rng.random() < 0.9 else "")
        files.append(("package.json", f'{{\n  "name": "pkg{i}",\n{field}'
                      f'  "version": "1.{i % 7}.0"\n}}\n'))
    if rng.random() < 0.25:
        decl = (f's.license = "{lic(DECLARED).lower()}"'
                if rng.random() < 0.7 else
                f's.licenses = ["{lic(DECLARED).lower()}", "mit"]')
        files.append((f"gem{i}.gemspec", "Gem::Specification.new do |s|\n"
                      f'  s.name = "gem{i}"\n  {decl}\nend\n'))
    if rng.random() < 0.25:
        files.append(("Cargo.toml", f'[package]\nname = "crate{i}"\n'
                      f'license = "{lic(DECLARED)}"\n'))
    if rng.random() < 0.15:
        files.append(("DESCRIPTION", f"Package: r{i}\nLicense: "
                      f"{lic(CRAN_DECLARED)}\n"))
    if rng.random() < 0.15:
        files.append((f"pkg{i}.cabal", f"name: pkg{i}\nlicense: "
                      f"{lic(CABAL_DECLARED)}\n"))
    return files


def readme_file(rng, i: int, bases, readmes, names) -> tuple:
    """(name, text) of crawl repo ``i``'s README: a test fixture's README,
    or a generated one whose License section names a license (the
    Reference matcher's case), holds a rendered template or a seeded
    mutation of one, points elsewhere, or is missing; now and then as
    HTML."""
    r = rng.random()
    if r < 0.15:
        return readmes[int(rng.integers(len(readmes)))]
    if r < 0.35:
        section = (f"This project is released under the "
                   f"{names[int(rng.integers(len(names)))]}.")
    elif r < 0.55:
        section = bases[int(rng.integers(len(bases)))][1]
    elif r < 0.7:
        section = mutate(bases[int(rng.integers(len(bases)))][1], rng, 0.03)
    elif r < 0.85:
        section = "See [LICENSE](LICENSE) for details."
    else:
        section = None
    if rng.random() < 0.12:
        body = f"<h1>repo{i}</h1>\n<p>A project.</p>\n"
        if section is not None:
            paras = "".join(f"<p>{p}</p>\n" for p in section.split("\n\n"))
            body += f"<h2>License</h2>\n{paras}"
        return "README.html", body
    text = f"# repo{i}\n\nA project.\n\n## Usage\n\nRun it.\n"
    if section is not None:
        text += f"\n## License\n\n{section}\n"
    return "README.md", text


def write_mixed_manifest(np, root: str, seed: int, n_repos: int = 2400) -> str:
    """A mixed manifest laid out as crawls list repositories: per repo
    directory a LICENSE-like file (a rendered template or test fixture,
    or a seeded mutation; COPYING, COPYRIGHT and LICENSE-MIT names
    among them), a README, package manifests and an unrouted source
    file, and one path that cannot be read: about 4 rows a repo."""
    from licensee_tpu_torch.corpus.license import License

    rng = np.random.default_rng(seed + 2)
    bases = vendored_bases()
    # what a README's License section names a license by: its title or
    # its source URL (the Reference matcher's two patterns)
    lics = License.all(hidden=True, pseudo=False)
    names = [lic.name for lic in lics] + [
        lic.meta.source for lic in lics if lic.meta.source]
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures")
    readmes = []
    for rel in ("readme/README.md", "mit/README.md",
                "license-with-readme-reference/README",
                "apache-with-readme-notice/README.md",
                "readme-invalid-encoding/README.md"):
        with open(os.path.join(fixtures, rel), "rb") as fh:
            readmes.append((os.path.basename(rel),
                            fh.read().decode("utf-8", errors="ignore")))
    license_names = ("LICENSE", "LICENSE", "LICENSE.txt", "LICENSE.md",
                     "COPYING", "LICENSE-MIT", "COPYRIGHT")
    rates = (0.002, 0.01, 0.03, 0.1, 0.3)
    items = []
    for i in range(n_repos):
        repo = os.path.join(root, f"r{i // 100:02d}", f"repo{i:04d}")
        files = []
        if rng.random() < 0.85:
            name = license_names[int(rng.integers(len(license_names)))]
            text = bases[int(rng.integers(len(bases)))][1]
            if name == "COPYRIGHT" and rng.random() < 0.5:
                text = f"Copyright (c) {2000 + i % 24} Repo {i} Authors\n"
            elif rng.random() < 0.3:
                text = mutate(text, rng, rates[int(rng.integers(len(rates)))])
            files.append((name, text))
        if rng.random() < 0.9:
            files.append(readme_file(rng, i, bases, readmes, names))
        files += package_files(rng, i)
        files.append(("main.c", "int main(void) { return 0; }\n"))
        items += [(os.path.join(repo, name), text) for name, text in files]
    write_files(items)
    paths = [path for path, _text in items]
    paths.append(os.path.join(root, "missing", "LICENSE"))  # unreadable
    manifest = os.path.join(root, "manifest.txt")
    with open(manifest, "w", encoding="utf-8") as fh:
        fh.write("\n".join(paths) + "\n")
    return manifest


def write_rows(np, root: str, bases, seed: int, n_files: int) -> str:
    """``n_files`` manifest rows under ``root``: the (name, text) bases
    (as many as fit), seeded word-level mutations of them, and one path
    that cannot be read."""
    rng = np.random.default_rng(seed)
    bases = bases[: n_files - 1]
    items = [(os.path.join(root, f"b{i:04d}", name), text)
             for i, (name, text) in enumerate(bases)]
    rates = (0.002, 0.01, 0.03, 0.1, 0.3)
    for i in range(n_files - len(items) - 1):
        name, text = bases[int(rng.integers(len(bases)))]
        items.append((os.path.join(root, f"m{i:04d}", name),
                      mutate(text, rng, rates[int(rng.integers(len(rates)))])))
    write_files(items)
    paths = [path for path, _text in items]
    paths.append(os.path.join(root, "missing", "LICENSE"))  # unreadable
    manifest = os.path.join(root, "manifest.txt")
    with open(manifest, "w", encoding="utf-8") as fh:
        fh.write("\n".join(paths) + "\n")
    return manifest


def run_cli(argv: list[str]) -> dict:
    from licensee_tpu_torch.cli.main import main

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"batch-detect {argv} exited {rc}: {err.getvalue()}")
    return json.loads(err.getvalue().strip().splitlines()[-1])


@contextlib.contextmanager
def counting_card_argmax(torch):
    """Counts `dice_ref.argmax_exact` calls on CUDA tensors meanwhile."""
    from licensee_tpu_torch.kernels import dice_ref

    calls = [0]
    argmax = dice_ref.argmax_exact

    def counted(num, den):
        calls[0] += num.device.type == "cuda"
        return argmax(num, den)

    dice_ref.argmax_exact = counted
    try:
        yield calls
    finally:
        dice_ref.argmax_exact = argmax


def read_rows(path: str, n_rows: int, what: str) -> bytes:
    """The output's bytes, after checking it has one JSON row per
    manifest entry."""
    with open(path, "rb") as fh:
        data = fh.read()
    lines = data.decode().splitlines()
    if len(lines) != n_rows:
        raise AssertionError(
            f"{what}: {len(lines)} rows for {n_rows} manifest entries")
    for line in lines:
        json.loads(line)
    return data


def describe(stats: dict, elapsed: float) -> str:
    """rows/s, the lanes' occupancy, the dispatch split and the stage
    seconds of one run, for the log (a resumed run counts the rows it
    wrote)."""
    n_rows = stats["total"]
    run_s = stats["stage_seconds"]["elapsed"]
    occ = stats.get("pipeline", {}).get("occupancy", {})
    disp = stats.get("dispatch", {})
    device = occ.get("device", 0.0)
    return (
        f"{n_rows} rows: {n_rows / run_s:.1f} rows/s over the run's "
        f"{run_s:.3f} s ({n_rows / elapsed:.1f} rows/s over the command's "
        f"{elapsed:.2f} s, set-up included); dice-bound rows "
        f"{stats['device_rows']}, dedupe hits {stats['dedupe_hits']}; lanes "
        f"featurize {occ.get('featurize', 0.0):.4f}, device {device:.4f} "
        f"(not in flight {1 - device:.4f}), writer "
        f"{occ.get('writer', 0.0):.4f}; dispatch set-up "
        f"{disp.get('compiles', 0)} in {disp.get('compile_s', 0.0):.4f} s, "
        f"steady {disp.get('dispatches', 0)} in "
        f"{disp.get('dispatch_s', 0.0):.4f} s; stage_seconds "
        f"{json.dumps(stats['stage_seconds'])}"
    )


def drive(torch, what: str, argv: list[str], n_rows: int):
    """One `batch-detect` run through the CLI, with the kernels' launch
    counts reset just before it and read just after.  A run fails if it
    ran the argmax on the card, but for K2's top-1 path, which runs it
    after the score algebra.  A --closest run through K1 fails unless
    it launched `topk_fused` and never `score_pairs_fused`, `topk_exact`
    or `best_match_fused`; a --closest run through K2 (--method
    pallas-mxu or matmul) unless it launched `topk_exact` and never
    `topk_fused` or `best_match_fused`; another K1 run if it launched
    the planes kernel or a top-k.  Returns (output bytes, stats,
    seconds, launches)."""
    from licensee_tpu_torch.kernels import dice_cuda

    on_card = "cpu" not in argv
    if on_card:
        torch.cuda.synchronize()
    dice_cuda.reset_launches()
    t0 = time.perf_counter()
    with counting_card_argmax(torch) as card_argmax:
        stats = run_cli([*argv, "--stats"])
    elapsed = time.perf_counter() - t0
    launches = dict(dice_cuda.LAUNCHES) if on_card else {}
    closest = "--closest" in argv and argv[argv.index("--closest") + 1] != "0"
    k2 = "pallas-mxu" in argv or "matmul" in argv
    if on_card:
        if closest and k2:
            want, never = "topk_exact", ("topk_fused", "best_match_fused")
        elif closest:
            want, never = "topk_fused", ("score_pairs_fused", "topk_exact",
                                         "best_match_fused")
        elif k2:
            want, never = None, ("topk_fused", "topk_exact")
        else:
            want, never = None, ("score_pairs_fused", "topk_fused",
                                 "topk_exact")
        wrong = {n: launches[n] for n in never if launches[n]}
        argmax_ok = k2 and not closest
        if (card_argmax[0] and not argmax_ok) or wrong or (
                want and not launches[want]):
            raise AssertionError(
                f"{what}: argmax_exact ran {card_argmax[0]} times on the "
                f"card, {wrong} launched, or {want} never launched "
                f"(launches {launches}; scorer "
                f"{stats.get('dispatch', {}).get('scorer')})")
    data = read_rows(argv[argv.index("--output") + 1], n_rows, what)
    log(f"run {what}: {describe(stats, elapsed)}; scorer "
        f"{stats.get('dispatch', {}).get('scorer')}; launches "
        f"{json.dumps(launches)}")
    return data, stats, elapsed, launches


def count_rows(manifest: str) -> int:
    with open(manifest, encoding="utf-8") as fh:
        return sum(1 for line in fh if line.strip())


def run_slice(torch, run: str, root: str, manifest: str,
              extra: list[str], launches: dict) -> None:
    """`batch-detect` over ``manifest`` through K1 and K2, each on the
    card and with --device cpu; adds every kernel's launches over the
    card runs to ``launches[run, kernel]``."""
    n_rows = count_rows(manifest)
    for method, kernel in (("pallas", "best_match_fused"),
                           ("pallas-mxu", "overlap_pairs_mma")):
        outs = {}
        for device in ("cpu", "cuda"):
            out = os.path.join(root, f"{run}.{method}.{device}.jsonl")
            outs[device], _stats, _s, got = drive(
                torch, f"slice {run} {method} --device {device}",
                ["batch-detect", manifest, "--output", out, *extra,
                 "--method", method, "--device", device], n_rows)
            for name, n in got.items():
                launches[run, name] = launches.get((run, name), 0) + n
        if outs["cuda"] != outs["cpu"]:
            raise AssertionError(
                f"{run} {method}: the cuda JSONL differs from the cpu JSONL")
        if not launches.get((run, kernel)):
            raise AssertionError(
                f"{run} {method}: {kernel} never launched on the main path")
        log(f"slice {run} {method}: cuda output byte-identical to cpu; "
            f"{kernel} launches {launches[run, kernel]}")


def prefix_manifest(manifest: str, n: int) -> str:
    """A manifest of the first ``n`` entries of ``manifest``: a run over
    it writes the first rows of the full run's output (each row depends
    on its entry alone), so a repeat can run at a smaller depth."""
    with open(manifest, encoding="utf-8") as fh:
        lines = fh.read().splitlines()[:n]
    path = f"{manifest}.first{n}"
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def first_lines(data: bytes, n: int) -> bytes:
    return b"".join(data.splitlines(keepends=True)[:n])


def start_featurizer_check(root: str, manifest: str) -> tuple:
    """The first 600 rows of the vendored slice on the pure-Python
    featurizer (LICENSEE_TPU_NO_NATIVE=1, in a child process started now,
    beside the slice's runs); `featurizer_check` holds them against the
    native K1 run's."""
    manifest = prefix_manifest(manifest, 600)
    out = os.path.join(root, "vendored.pallas.no-native.jsonl")
    env = dict(os.environ, LICENSEE_TPU_NO_NATIVE="1")
    child = subprocess.Popen(
        [sys.executable, "-m", "licensee_tpu_torch.cli.main", "batch-detect",
         manifest, "--output", out, "--method", "pallas", "--stats"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    return child, time.perf_counter(), manifest, out


def featurizer_check(root: str, started: tuple) -> None:
    """The native K1 run's first 600 rows against the pure-Python
    featurizer's (`start_featurizer_check`'s child, waited for here)."""
    child, t0, manifest, out = started
    _out, err = child.communicate(timeout=900)
    if child.returncode != 0:
        raise RuntimeError(f"LICENSEE_TPU_NO_NATIVE run exited "
                           f"{child.returncode}: {err[-2000:]}")
    elapsed = time.perf_counter() - t0
    n_rows = count_rows(manifest)
    stats = json.loads(err.strip().splitlines()[-1])
    python = read_rows(out, n_rows, "featurizer check")
    with open(os.path.join(root, "vendored.pallas.cuda.jsonl"), "rb") as fh:
        native = first_lines(fh.read(), n_rows)
    if python != native:
        raise AssertionError("the native featurizer's JSONL differs from "
                             "the pure-Python featurizer's")
    log(f"featurizer check: native output byte-identical to "
        f"LICENSEE_TPU_NO_NATIVE=1; that run: "
        f"{describe(stats, elapsed)}")


def device_busy_seconds(prof) -> float:
    """The card's busy seconds in a profiled window: the device time of
    every kernel, copy and fill it recorded (one stream, so they do not
    overlap)."""
    total_us = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        total_us += t
    return total_us / 1e6


def default_flags(torch, what: str, root: str, manifest: str,
                  extra: list[str], launches: dict, run: str,
                  drill: bool) -> None:
    """`batch-detect` at its default flags over ``manifest``, against
    --device cpu and --pipeline-depth 1 --workers 1; with ``drill``, the
    resume drill and a profiled run for the card's busy share."""
    n_rows = count_rows(manifest)
    card = smi("name,power.limit")
    log(f"default flags {what}: {n_rows} rows; {card}; host nproc "
        f"{os.cpu_count()} ({len(os.sched_getaffinity(0))} usable)")

    def one(label, *flags):
        out = os.path.join(root, f"{run}.{label}.jsonl")
        data, stats, elapsed, got = drive(
            torch, f"{what} {label}",
            ["batch-detect", manifest, "--output", out, *extra, *flags],
            n_rows)
        for name, n in got.items():
            launches[run, name] = launches.get((run, name), 0) + n
        return out, data, stats, got

    out, full, stats, got = one("default")
    if got["best_match_fused"] < 1:
        raise AssertionError(f"{what}: best_match_fused never launched on "
                             "the main path at default flags")
    # the twins of the 50,001-row run over its first 12,001 rows
    depth = 12001 if drill else n_rows
    twin_manifest = prefix_manifest(manifest, depth) if drill else manifest
    for label, flags in (("cpu", ["--device", "cpu"]),
                         ("depth1-workers1",
                          ["--pipeline-depth", "1", "--workers", "1"])):
        out_t = os.path.join(root, f"{run}.{label}.jsonl")
        data, _stats, _s, got = drive(
            torch, f"{what} {label}",
            ["batch-detect", twin_manifest, "--output", out_t, *extra,
             *flags], depth)
        for name, n in got.items():
            launches[run, name] = launches.get((run, name), 0) + n
        if data != first_lines(full, depth):
            raise AssertionError(f"{what}: the {label} JSONL differs from "
                                 "the default run's")
    log(f"default flags {what}: the first {depth} rows byte-identical to "
        "--device cpu and to --pipeline-depth 1 --workers 1")
    if not drill:
        return
    # worker processes instead of threads, spawned beside the parent's
    # live CUDA context: the same bytes, and how far the GIL holds the
    # threads back (over the first 4,001 rows since PR 11: the script's
    # time)
    procs, procs_depth = str(os.cpu_count()), 4001
    out_p = os.path.join(root, f"{run}.procs{procs}.jsonl")
    data, _stats, _s, got = drive(
        torch, f"{what} procs{procs}, first {procs_depth} rows",
        ["batch-detect", prefix_manifest(manifest, procs_depth), "--output",
         out_p, *extra, "--featurize-procs", procs], procs_depth)
    for name, n in got.items():
        launches[run, name] = launches.get((run, name), 0) + n
    if data != first_lines(full, procs_depth):
        raise AssertionError(f"{what}: the --featurize-procs JSONL differs")
    log(f"default flags {what}: --featurize-procs {procs} over the first "
        f"{procs_depth} rows byte-identical to those rows of the default "
        "run")
    got = resume_drill(torch, what, out,
                       ["batch-detect", manifest, "--output", out, *extra],
                       full, n_rows)
    for name, n in got.items():
        launches[run, name] = launches.get((run, name), 0) + n

    def profiled():
        # over the twins' rows since PR 11 (the script's time)
        out_p = os.path.join(root, f"{run}.profiled.jsonl")
        data, stats, _s, got = drive(
            torch, f"{what} profiled, first {depth} rows",
            ["batch-detect", twin_manifest, "--output", out_p, *extra],
            depth)
        for name, n in got.items():
            launches[run, name] = launches.get((run, name), 0) + n
        return data, stats

    busy_share(torch, what, profiled, first_lines(full, depth))


def busy_share(torch, what: str, run, full: bytes) -> None:
    """One more run (``run()`` gives its bytes and stats) under
    torch.profiler: it must give ``full`` again, and the card's busy
    seconds over the run's elapsed are its busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        data, stats = run()
    torch.cuda.synchronize()
    if data != full:
        raise AssertionError(f"{what}: the profiled run's JSONL differs")
    busy = device_busy_seconds(prof)
    run_s = stats["stage_seconds"]["elapsed"]
    log(f"device busy {what} (torch.profiler, the profiled run): "
        f"{busy:.6f} s of the run's {run_s:.3f} s: busy share "
        f"{busy / run_s:.6f}, idle share {1 - busy / run_s:.6f}"
        if busy > 0 else
        f"device busy {what}: not measured (the profiler recorded no "
        "device time)")


def phase_slice(np, torch, seed: int, root: str) -> tuple:
    """Phases 4 to 8 and 10 (which reuses their manifests and outputs)
    under ``root``; returns ({(run, kernel): launches}, the inputs phase
    10 reused, for phase 12)."""
    from licensee_tpu_torch.corpus.spdx_synth import synth_spdx_dir

    launches = {}
    vendored = write_manifest(np, os.path.join(root, "vendored"), seed)
    t_phase = time.perf_counter()

    def took(what: str) -> None:
        nonlocal t_phase
        log(f"{what} took {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()

    no_native = start_featurizer_check(root, vendored)
    run_slice(torch, "vendored", root, vendored, [], launches)
    t0 = time.perf_counter()
    spdx_dir = synth_spdx_dir(os.path.join(root, "spdx-src"), SPDX_T,
                              seed)
    spdx = write_spdx_manifest(np, os.path.join(root, "spdx"), spdx_dir,
                               seed)
    log(f"slice spdx: {SPDX_T}-template synthetic SPDX directory and "
        f"manifest written in {time.perf_counter() - t0:.1f} s")
    run_slice(torch, "spdx", root, spdx, ["--corpus", spdx_dir],
              launches)
    featurizer_check(root, no_native)
    took("phase 4")

    t0 = time.perf_counter()
    big = write_big_manifest(np, os.path.join(root, "big"), seed)
    log(f"default flags: 50,001-row manifest over 12,000 files written "
        f"in {time.perf_counter() - t0:.1f} s")
    default_flags(torch, "vendored", root, big, [], launches,
                  "vendored", drill=True)
    default_flags(torch, "spdx", root, spdx, ["--corpus", spdx_dir],
                  launches, "spdx", drill=False)
    took("phase 5")
    modes(np, torch, seed, root, spdx, spdx_dir, launches)
    took("phase 6")
    packed = containers(np, torch, seed, root, launches)
    took("phase 7")
    phase_detect(torch, root, vendored, launches)
    took("phase 8")
    with open(os.path.join(root, "vendored.default.jsonl"), "rb") as fh:
        big_full = fh.read()
    inputs = {
        "big": big, "big_full": big_full, "vendored": vendored,
        "spdx": spdx, "spdx_dir": spdx_dir, "containers": packed,
    }
    phase_scale(np, torch, seed, root, inputs, launches)
    return launches, inputs


def resume_drill(torch, what: str, out: str, argv: list[str], full: bytes,
                 n_rows: int, derived: tuple = ()) -> dict:
    """Cut ``out`` mid-line, resume the run and check it ends at the full
    run's sha256 with the sidecar unchanged; each file ``out + suffix``
    of ``derived`` (the container verdicts) is removed before the resume
    and must come back at the full run's sha256.  Returns the
    launches."""
    import hashlib

    with open(out + ".meta.json", "rb") as fh:
        sidecar = fh.read()
    want = {}
    for suffix in derived:
        with open(out + suffix, "rb") as fh:
            want[suffix] = hashlib.sha256(fh.read()).hexdigest()
        os.remove(out + suffix)
    cut = int(len(full) * 0.6)
    while full[cut - 1 : cut] == b"\n":
        cut += 1
    with open(out, "wb") as fh:
        fh.write(full[:cut])
    kept = full[:cut].count(b"\n")
    data, stats, _s, got = drive(
        torch, f"{what} resumed after {kept} rows", argv, n_rows)
    with open(out + ".meta.json", "rb") as fh:
        if fh.read() != sidecar:
            raise AssertionError(f"{what}: resume rewrote a different sidecar")
    if hashlib.sha256(data).digest() != hashlib.sha256(full).digest():
        raise AssertionError(f"{what}: the resumed output's sha256 differs")
    for suffix, digest in want.items():
        with open(out + suffix, "rb") as fh:
            if hashlib.sha256(fh.read()).hexdigest() != digest:
                raise AssertionError(
                    f"{what}: the resumed {suffix} sha256 differs")
        log(f"resume drill {what}: {suffix} sha256 {digest} equals the "
            "full run's")
    if stats["total"] != n_rows - kept:
        raise AssertionError(f"{what}: resume redid {stats['total']} rows, "
                             f"not {n_rows - kept}")
    log(f"resume drill {what}: cut mid-line after {kept} rows, resumed: "
        f"sha256 {hashlib.sha256(data).hexdigest()} equals the full run's, "
        "sidecar unchanged")
    return got


def modes(np, torch, seed: int, root: str, spdx: str, spdx_dir: str,
          launches: dict) -> None:
    """Phase 6: the rest of batch-detect's verdict surface at default
    flags.  Over a seeded ~10,000-row mixed crawl manifest:
    --mode auto --closest 3 --attribution, --mode readme and --mode
    package, each against --device cpu and --pipeline-depth 1
    --workers 1, the auto run's resume drill, and a profiled run of the
    two that use the card for its busy share.  Over the T=608
    manifest: --closest 3 through K1 and K2 (--method matmul) against
    --device cpu, each with a profiled run, and a corpus-build artifact
    of the SPDX directory through --corpus ART against the K1 run, which
    read the directory."""
    t0 = time.perf_counter()
    mixed = write_mixed_manifest(np, os.path.join(root, "mixed"), seed)
    n_rows = count_rows(mixed)
    log(f"modes: {n_rows}-row mixed manifest written in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{smi('name,power.limit')}")

    def one(run, label, manifest, n, *flags):
        out = os.path.join(root, f"modes.{label}.jsonl")
        argv = ["batch-detect", manifest, "--output", out, *flags]
        data, stats, _s, got = drive(torch, f"modes {label}", argv, n)
        for name, c in got.items():
            launches[run, name] = launches.get((run, name), 0) + c
        return out, argv, data, stats, got

    for label, flags, kernel in (
            ("auto-closest3-attribution",
             ["--mode", "auto", "--closest", str(CLOSEST), "--attribution"],
             "topk_fused"),
            ("readme", ["--mode", "readme"], "best_match_fused"),
            ("package", ["--mode", "package"], None)):
        out, argv, full, stats, got = one("vendored", label, mixed, n_rows,
                                          *flags)
        if kernel is not None and not got[kernel]:
            raise AssertionError(f"modes {label}: {kernel} never launched")
        if kernel is None and any(got.values()):
            raise AssertionError(f"modes {label}: a host-only run launched "
                                 f"{got}")
        for twin, extra in (("cpu", ["--device", "cpu"]),
                            ("depth1-workers1",
                             ["--pipeline-depth", "1", "--workers", "1"])):
            if one("vendored", f"{label}.{twin}", mixed, n_rows, *flags,
                   *extra)[2] != full:
                raise AssertionError(f"modes {label}: the {twin} JSONL "
                                     "differs from the default run's")
        counters = {k: v for k, v in stats.items()
                    if isinstance(v, int) or k == "routed"}
        log(f"modes {label}: byte-identical to --device cpu and to "
            f"--pipeline-depth 1 --workers 1; counters "
            f"{json.dumps(counters)}")
        if label.startswith("auto"):
            got = resume_drill(torch, f"modes {label}", out, argv, full,
                               n_rows)
            for name, c in got.items():
                launches["vendored", name] = (
                    launches.get(("vendored", name), 0) + c)
        if kernel is not None:
            busy_share(torch, f"modes {label}", lambda: one(
                "vendored", f"{label}.profiled", mixed, n_rows,
                *flags)[2:4], full)

    n_spdx = count_rows(spdx)
    closest = ["--closest", str(CLOSEST), "--corpus"]
    dir_out = {}
    for method, kernel in (("auto", "topk_fused"),
                           ("matmul", "overlap_pairs_mma")):
        label = f"spdx-closest3-{method}"
        flags = [*closest, spdx_dir, "--method", method]
        _o, _a, full, _st, got = one("spdx", label, spdx, n_spdx, *flags)
        if not got[kernel]:
            raise AssertionError(f"modes {label}: {kernel} never launched")
        if one("spdx", f"{label}.cpu", spdx, n_spdx, *flags,
               "--device", "cpu")[2] != full:
            raise AssertionError(f"modes {label}: the cpu JSONL differs")
        log(f"modes {label}: byte-identical to --device cpu")
        busy_share(torch, f"modes {label}", lambda: one(
            "spdx", f"{label}.profiled", spdx, n_spdx, *flags)[2:4], full)
        dir_out[method] = full
    from licensee_tpu_torch.cli.main import main as cli

    art = os.path.join(root, "spdx608.npz")
    manifest_line = io.StringIO()
    with contextlib.redirect_stdout(manifest_line):
        if cli(["corpus-build", "--corpus", spdx_dir, "--output", art]) != 0:
            raise RuntimeError("corpus-build of the SPDX directory failed")
    log(f"corpus-build: {manifest_line.getvalue().strip()}")
    # --method auto is the default: the spdx-closest3-auto run is the
    # --corpus DIR run the artifact's must equal
    if one("spdx", "spdx-closest3-artifact", spdx, n_spdx, *closest,
           art)[2] != dir_out["auto"]:
        raise AssertionError("--corpus ARTIFACT differs from --corpus DIR")
    log("modes: --corpus ARTIFACT byte-identical to --corpus DIR "
        "(the spdx-closest3-auto run)")


# -- phase 7: containers --------------------------------------------------------

# the mixed manifest's repositories as package crawls list them: sdists
# and npm tarballs, wheels and jars, git checkouts (of every 12 repos, 4
# .tar, 3 .tar.gz, 3 .zip, 2 git: 800 / 600 / 600 / 400 of 2,400)
CONTAINER_CYCLE = ("tar",) * 4 + ("tar.gz",) * 3 + ("zip",) * 3 + ("git",) * 2
ARCHIVE_MTIME = 1_600_000_000
GIT_ENV = {"GIT_CONFIG_GLOBAL": "/dev/null", "GIT_CONFIG_SYSTEM": "/dev/null",
           "GIT_AUTHOR_NAME": "n", "GIT_AUTHOR_EMAIL": "a@b",
           "GIT_COMMITTER_NAME": "n", "GIT_COMMITTER_EMAIL": "a@b",
           "GIT_AUTHOR_DATE": f"{ARCHIVE_MTIME} +0000",
           "GIT_COMMITTER_DATE": f"{ARCHIVE_MTIME} +0000"}


def write_git_objects(repo: str, files: list) -> None:
    """A git repository at ``repo`` whose one commit holds ``files``
    ((name, bytes)) at its root, written here as loose objects (zlib over
    ``type size\\0data``, named by its sha1) with HEAD on refs/heads/main:
    the layout git itself writes, for a host without git."""
    import hashlib
    import zlib

    git_dir = os.path.join(repo, ".git")

    def put(kind: bytes, body: bytes) -> bytes:
        raw = kind + b" %d\0" % len(body) + body
        sha = hashlib.sha1(raw).hexdigest()
        path = os.path.join(git_dir, "objects", sha[:2], sha[2:])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(zlib.compress(raw))
        return bytes.fromhex(sha)

    os.makedirs(os.path.join(git_dir, "refs", "heads"), exist_ok=True)
    tree = b"".join(
        b"100644 " + name.encode() + b"\0" + put(b"blob", data)
        for name, data in sorted(files, key=lambda f: f[0].encode()))
    stamp = f"n <a@b> {ARCHIVE_MTIME} +0000".encode()
    commit = put(b"commit", b"tree " + put(b"tree", tree).hex().encode()
                 + b"\nauthor " + stamp + b"\ncommitter " + stamp + b"\n\nx\n")
    with open(os.path.join(git_dir, "HEAD"), "w", encoding="ascii") as fh:
        fh.write("ref: refs/heads/main\n")
    with open(os.path.join(git_dir, "refs", "heads", "main"), "w",
              encoding="ascii") as fh:
        fh.write(commit.hex() + "\n")


def write_git_repo(repo: str, files: list) -> None:
    """``files`` ((name, bytes)) committed at the root of a new
    repository: through git where it is installed, else
    `write_git_objects`."""
    import shutil

    os.makedirs(repo)
    if shutil.which("git") is None:
        write_git_objects(repo, files)
        return
    for name, data in files:
        with open(os.path.join(repo, name), "wb") as fh:
            fh.write(data)
    env = dict(os.environ, **GIT_ENV)
    for args in (["init", "-q", "-b", "main"], ["add", "-A"],
                 ["commit", "-qm", "x"]):
        subprocess.run(["git", "-C", repo, *args], check=True, env=env,
                       capture_output=True, timeout=60)


def write_container_manifest(np, root: str, seed: int,
                             n_repos: int = 2400, src: str | None = None
                             ) -> tuple:
    """`write_mixed_manifest`'s 2,400 repository directories packed as
    containers (`CONTAINER_CYCLE`): a .tar under ``package/`` (npm), a
    .tar.gz under ``repoN-1.0/`` (an sdist), a flat .zip (a wheel), a git
    checkout; each listed whole (``::*``, ``::HEAD``), one archive in 40
    also by its first member, and the mixed manifest's unreadable path.
    ``src`` is that mixed manifest where it is already written (phase
    6's, the same seed and size); the containers are written by 8
    threads (a slow file system's latency, not the CPU, bounds them).
    Returns (manifest, expanded rows, containers by kind)."""
    import io
    import tarfile
    import zipfile
    from concurrent.futures import ThreadPoolExecutor

    from licensee_tpu_torch.ingest.sources import expand_manifest

    if src is None:
        src = write_mixed_manifest(np, os.path.join(root, "src"), seed,
                                   n_repos)
    with open(src, encoding="utf-8") as fh:
        paths = fh.read().split()
    repos: dict[str, list] = {}
    for path in paths[:-1]:
        with open(path, "rb") as fh:
            repos.setdefault(os.path.dirname(path), []).append(
                (os.path.basename(path), fh.read()))
    out_dir = os.path.join(root, "packed")
    os.makedirs(out_dir)
    kinds = {}
    for i in range(len(repos)):
        kind = CONTAINER_CYCLE[i % len(CONTAINER_CYCLE)]
        kinds[kind] = kinds.get(kind, 0) + 1

    def pack(i: int, files: list) -> list:
        kind = CONTAINER_CYCLE[i % len(CONTAINER_CYCLE)]
        if kind == "git":
            repo = os.path.join(out_dir, f"repo{i:04d}")
            write_git_repo(repo, files)
            return [f"{repo}::HEAD"]
        prefix = {"tar": "package/", "tar.gz": f"repo{i:04d}-1.0/",
                  "zip": ""}[kind]
        arch = os.path.join(out_dir, f"repo{i:04d}.{kind}")
        if kind == "zip":
            with zipfile.ZipFile(arch, "w", zipfile.ZIP_DEFLATED) as zf:
                for name, data in files:
                    zf.writestr(zipfile.ZipInfo(
                        prefix + name, (2020, 9, 13, 12, 26, 40)), data)
        else:
            with tarfile.open(arch, "w:gz" if kind == "tar.gz" else "w") as tf:
                for name, data in files:
                    info = tarfile.TarInfo(prefix + name)
                    info.size, info.mtime = len(data), ARCHIVE_MTIME
                    tf.addfile(info, io.BytesIO(data))
        listed = [f"{arch}::*"]
        if i % 40 == 0:
            listed.append(f"{arch}::{prefix}{files[0][0]}")
        return listed

    entries = []
    with ThreadPoolExecutor(8) as pool:
        for listed in pool.map(pack, range(len(repos)), repos.values()):
            entries += listed
    entries.append(paths[-1])  # the path that cannot be read
    manifest = os.path.join(root, "containers.txt")
    with open(manifest, "w", encoding="utf-8") as fh:
        fh.write("\n".join(entries) + "\n")
    ex = expand_manifest(entries)
    try:
        n_rows = ex.total
    finally:
        ex.close()
    return manifest, n_rows, kinds


def containers(np, torch, seed: int, root: str, launches: dict) -> dict:
    """Phase 7: `batch-detect` over container entries at default flags.
    The mixed crawl manifest's repositories packed as tars, compressed
    tars, zips and git checkouts expand to ~10,000 member rows, run
    under --mode auto --closest 3 --attribution and --mode license, each
    against --device cpu and --pipeline-depth 1 --workers 1 (the JSONL
    and OUT.containers.jsonl byte for byte) and, over the first 300
    entries, --featurize-procs 4, with the resume drill (both sha256s).
    Returns the manifest,
    its rows, the archives' directory and each mode's (flags, JSONL,
    container verdicts, stats) for phase 10."""
    t0 = time.perf_counter()
    mixed = os.path.join(root, "mixed", "manifest.txt")  # phase 6's
    manifest, n_rows, kinds = write_container_manifest(
        np, os.path.join(root, "containers"), seed,
        src=mixed if os.path.exists(mixed) else None)
    report = {"manifest": manifest, "n_rows": n_rows,
              "packed": os.path.join(root, "containers", "packed"),
              "modes": {}}
    log(f"containers: {sum(kinds.values())} containers {json.dumps(kinds)}, "
        f"{n_rows} expanded rows, written in {time.perf_counter() - t0:.1f} s; "
        f"{smi('name,power.limit')}")
    for label, flags, kernel in (
            ("auto-closest3-attribution",
             ["--mode", "auto", "--closest", str(CLOSEST), "--attribution"],
             "topk_fused"),
            ("license", ["--mode", "license"], "best_match_fused")):
        def one(name, *extra, label=label, flags=flags):
            out = os.path.join(root, f"containers.{label}.{name}.jsonl")
            argv = ["batch-detect", manifest, "--output", out, *flags,
                    *extra]
            data, stats, _s, got = drive(
                torch, f"containers {label} {name}", argv, n_rows)
            for k, c in got.items():
                launches["vendored", k] = launches.get(("vendored", k), 0) + c
            with open(out + ".containers.jsonl", "rb") as fh:
                verdicts = fh.read()
            return out, argv, data, verdicts, stats, got

        out, argv, full, verdicts, stats, got = one("default")
        if not got[kernel]:
            raise AssertionError(f"containers {label}: {kernel} never "
                                 "launched")
        stages = stats["stage_seconds"]
        n_verdicts = verdicts.count(b"\n")
        log(f"containers {label}: {n_rows} expanded rows, "
            f"{n_rows / stages['elapsed']:.1f} rows/s, read "
            f"{stages.get('read', 0.0):.4f} s, containers stage "
            f"{stages.get('containers', 0.0):.4f} s, "
            f"{n_verdicts} container rows")
        for twin, extra in (("cpu", ["--device", "cpu"]),
                            ("depth1-workers1",
                             ["--pipeline-depth", "1", "--workers", "1"])):
            _o, _a, data, twin_verdicts, _st, _g = one(twin, *extra)
            if data != full or twin_verdicts != verdicts:
                raise AssertionError(f"containers {label}: the {twin} JSONL "
                                     "or container verdicts differ")
        # worker processes over the first 300 entries: a prefix of the
        # rows, and container verdicts each among the full run's
        part = prefix_manifest(manifest, 300)
        n_part = count_rows_expanded(part)
        out_p = os.path.join(root, f"containers.{label}.procs4.jsonl")
        data, _st, _s, got = drive(
            torch, f"containers {label} procs4, first 300 entries",
            ["batch-detect", part, "--output", out_p, *flags,
             "--featurize-procs", "4"], n_part)
        for k, c in got.items():
            launches["vendored", k] = launches.get(("vendored", k), 0) + c
        with open(out_p + ".containers.jsonl", "rb") as fh:
            part_verdicts = fh.read().splitlines()
        if data != first_lines(full, n_part) or not set(
                part_verdicts) <= set(verdicts.splitlines()):
            raise AssertionError(f"containers {label}: the procs4 JSONL or "
                                 "container verdicts differ")
        log(f"containers {label}: JSONL and .containers.jsonl byte-identical "
            "to --device cpu and --pipeline-depth 1 --workers 1, and "
            f"--featurize-procs 4 over the first 300 entries ({n_part} rows) "
            "to those rows")
        got = resume_drill(torch, f"containers {label}", out, argv, full,
                           n_rows, derived=(".containers.jsonl",))
        for k, c in got.items():
            launches["vendored", k] = launches.get(("vendored", k), 0) + c
        report["modes"][label] = (flags, full, verdicts, stats)
    return report


# -- phase 10: scale ---------------------------------------------------------------

K5_MESHES = ((1, 1), (2, 1), (1, 2), (2, 2))


def phase_k5(np, torch, seed: int, sm_clocks_per_s: float) -> list[dict]:
    """Phase 10's kernels: K5 (`parallel/mesh.py:make_sharded_scorer`)
    over meshes that repeat the card (`build_mesh(devices=[cuda:0] * n)`)
    at B=4096, T=47 and T=608, top-1 and top-3, bit-identical to the plain
    scorer (`kernels/dice_ref.py`), with one K1 launch a data shard (one
    model shard) or one K2 launch a (data, model) block.  The (2, 2)
    mesh's top-1 is timed beside its bound, and the (1, 1) mesh's beside
    it."""
    from licensee_tpu_torch.kernels import dice_cuda, dice_ref
    from licensee_tpu_torch.parallel.mesh import (
        build_mesh,
        make_sharded_scorer,
    )

    rng = np.random.default_rng(seed + 10)
    rows = []
    for label, T, W, run in (("main", 47, 112, "vendored"),
                             ("main608", SPDX_T, 132, "spdx")):
        B = MAIN_B
        ct, feats = random_case(np, torch, rng, B, T, W)
        num, den = dice_ref.score_pairs(ct, *feats)
        top_k = dice_ref.topk_candidates(num, den, CLOSEST)
        wants = {0: dice_ref.argmax_exact(num, den),
                 CLOSEST: (*(c[:, 0] for c in top_k), *top_k)}
        for D, M in K5_MESHES:
            mesh = build_mesh(D, M, devices=["cuda:0"] * (D * M))
            for k, want in wants.items():
                fn = make_sharded_scorer(ct, mesh, "popcount", k)
                torch.cuda.synchronize()
                dice_cuda.reset_launches()
                got = fn(*feats)
                torch.cuda.synchronize()
                launched = {n: c for n, c in dice_cuda.LAUNCHES.items() if c}
                if M == 1:
                    expect = {"topk_fused" if k else "best_match_fused": D}
                else:
                    expect = {"overlap_pairs_mma": D * M,
                              **({"topk_exact": D} if k else {})}
                expect["make_sharded_scorer"] = 1
                if launched != expect:
                    raise AssertionError(f"K5 ({D},{M}) @{label} k={k}: "
                                         f"launched {launched}, not {expect}")
                err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
                if err or len(got) != len(want):
                    raise AssertionError(f"K5 ({D},{M}) @{label} k={k}: "
                                         f"!= plain (max {err})")
        log(f"K5 @{label}: B={B} T={T} W={W} bit-identical to the plain "
            f"scorer at meshes {list(K5_MESHES)} on [cuda:0]*n, top-1 and "
            f"top-{CLOSEST}; one K1 launch a data shard, one K2 a block")

        def plain():
            return dice_ref.argmax_exact(*dice_ref.score_pairs(ct, *feats))

        fn22 = make_sharded_scorer(
            ct, build_mesh(2, 2, devices=["cuda:0"] * 4), "popcount")
        err = held_against_plain(torch, f"K5 (2,2) @{label}",
                                 lambda: fn22(*feats), plain)
        # the function's bytes (K1's top-1: the same inputs and outputs)
        # against the int8 tensor-core operations of the (2, 2) route:
        # K2 over two lane slices, each padded to whole 4-word stages,
        # for each of two data rows (together the whole batch)
        w_pad = -(-(W // 2) // 4) * 4
        n_bytes = B * W * 4 + T * W * 4 + T * 8 * 4 + B * 9 + 3 * B * 4
        ops = 2 * B * T * 32 * w_pad * 2
        row = kernel_row(
            torch, "make_sharded_scorer" + ("" if label == "main"
                                            else f"@{label}"),
            "", "licensee_tpu/parallel/mesh.py:66", B, T, W, run, err,
            lambda: fn22(*feats), plain, None, n_bytes,
            ops / INT8_TENSOR_OPS_PER_S * 1e3,
            f"{ops} int8 tensor-core ops: K2 over 2 lane slices of "
            f"{w_pad} words", out_bytes=3 * B * 4,
            shape={"B": B, "T": T, "W": W, "mesh": "2x2"})
        row["source"] = "licensee_tpu_torch/parallel/mesh.py"
        rows.append(row)
        fn11 = make_sharded_scorer(ct, build_mesh(1, 1, devices=["cuda:0"]),
                                   "popcount")
        log(f"K5 (1,1) @{label}: ms="
            f"{cuda_time_ms(torch, lambda: fn11(*feats)):.4f} device_ms="
            f"{graph_time_ms(torch, lambda: fn11(*feats), 3 * B * 4):.4f} "
            "(K1 through the mesh's one shard)")
        del ct, feats, num, den, top_k, wants, fn22, fn11
        torch.cuda.empty_cache()
    return rows


def mesh_and_lanes(torch, root: str, inputs: dict, launches: dict) -> None:
    """`batch-detect --mesh 1,1` (K5 over one shard) and `--device-lanes
    1` over phase 4's vendored and T=608 manifests, byte-identical to the
    default run; the mesh run must launch K5 and K1, the others not K5."""
    for run, manifest, extra in (
            ("vendored", inputs["vendored"], []),
            ("spdx", inputs["spdx"], ["--corpus", inputs["spdx_dir"]])):
        n_rows = count_rows(manifest)
        outs = {}
        for label, flags in (("default", []), ("mesh1,1", ["--mesh", "1,1"]),
                             ("lanes1", ["--device-lanes", "1"])):
            out = os.path.join(root, f"scale.{run}.{label}.jsonl")
            outs[label], _stats, _s, got = drive(
                torch, f"scale {run} {label}",
                ["batch-detect", manifest, "--output", out, *extra, *flags],
                n_rows)
            for k, c in got.items():
                launches[run, k] = launches.get((run, k), 0) + c
            meshed = label == "mesh1,1"
            if bool(got["make_sharded_scorer"]) != meshed or not got[
                    "best_match_fused"]:
                raise AssertionError(f"scale {run} {label}: launches {got}")
        if not outs["default"] == outs["mesh1,1"] == outs["lanes1"]:
            raise AssertionError(f"scale {run}: --mesh 1,1 or --device-lanes "
                                 "1 differs from the default run")
        log(f"scale {run}: --mesh 1,1 and --device-lanes 1 byte-identical "
            "to the default run")


def serve_mesh(torch, inputs: dict) -> None:
    """`serve --mesh 1,1`, one stdio session of phase 4's vendored files
    through the CLI: its rows equal a device='cpu' batcher's, no fallback,
    and every flush and warm-up probe one K5 call over one K1 launch."""
    from licensee_tpu_torch.kernels import dice_cuda

    with open(inputs["vendored"], encoding="utf-8") as fh:
        reqs, _by_id = file_requests(fh.read().splitlines()[:700])
    torch.cuda.synchronize()
    dice_cuda.reset_launches()
    rc, out, err, took = run_verb(["serve", "--mesh", "1,1", "--stats"],
                                  "".join(json.dumps(r) + "\n" for r in reqs))
    launches = dict(dice_cuda.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"serve --mesh 1,1: exit {rc}: {err[-2000:]}")
    rows = {r["id"]: r for r in map(json.loads, out.splitlines())}
    held_to_reference("--mesh 1,1 session", rows,
                      cpu_rows(reqs, mode="license"))
    stats = json.loads(err.strip().splitlines()[-1])
    sched = stats["scheduler"]
    want = sched["device_batches"] + len(stats["device"]["per_shape"])
    if (sched["fallbacks"] or sched["completion_errors"]
            or launches["best_match_fused"] != want
            or launches["make_sharded_scorer"] != want):
        raise AssertionError(f"serve --mesh 1,1: launches {launches}, want "
                             f"{want} of K1 and K5; scheduler {sched}")
    log(f"serve --mesh 1,1: {len(reqs)} requests in {took:.3f} s "
        f"({len(reqs) / took:.1f} req/s), rows equal to the device='cpu' "
        f"batcher's; launches {json.dumps(launches)}")


HOST_SCRIPT = """
import os, sys
from licensee_tpu_torch.ingest.loopback import LoopbackBlobHost
root = sys.argv[1]
blobs = {}
for name in sorted(os.listdir(root)):
    path = os.path.join(root, name)
    if os.path.isfile(path):
        with open(path, "rb") as fh:
            blobs[name] = fh.read()
with LoopbackBlobHost(blobs) as host:
    print(host.port, flush=True)
    for line in sys.stdin:
        verb, _, name = line.strip().partition(" ")
        if verb == "republish":
            host.set_content(name, blobs[name] + b"\\0" * 512)
        elif verb == "restore":
            host.set_content(name, blobs[name])
        print("ok", flush=True)
"""


@contextlib.contextmanager
def blob_host(packed: str):
    """A `LoopbackBlobHost` over the archives of ``packed`` in a child
    process (its own interpreter, so its server threads do not share the
    batch run's): yields (base URL, a function sending it a command)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    proc = subprocess.Popen([sys.executable, "-c", HOST_SCRIPT, packed],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            env=env, cwd=repo, text=True)
    try:
        port = int(proc.stdout.readline())

        def command(line: str) -> None:
            proc.stdin.write(line + "\n")
            proc.stdin.flush()
            if proc.stdout.readline().strip() != "ok":
                raise RuntimeError(f"blob host: no answer to {line!r}")

        yield f"http://127.0.0.1:{port}/", command
    finally:
        proc.stdin.close()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def remote_manifest(root: str, cont: dict, base: str) -> str:
    """Phase 7's container manifest with every archive named by its URL
    on the blob host (git checkouts stay local: git over HTTP is refused)."""
    prefix = cont["packed"] + os.sep
    with open(cont["manifest"], encoding="utf-8") as fh:
        entries = fh.read().splitlines()
    out = [base + e[len(prefix):] if e.startswith(prefix) and not e.endswith(
        "::HEAD") else e for e in entries]
    path = os.path.join(root, "remote.txt")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(out) + "\n")
    return path


def remote_containers(torch, root: str, cont: dict, base: str, command,
                      launches: dict) -> dict:
    """Phase 7's 2,400 repositories with their 2,000 archives served from
    the blob host (`rtar`, `rctar`, `rzip`), under each of phase 7's two
    modes: the JSONL and the container verdicts against --device cpu, the
    pipeline at depth 1 on one worker, and phase 7's local run (apart
    from the entry paths); a remote git repository is refused.  Returns
    the remote manifest and the license mode's bytes."""
    manifest = remote_manifest(root, cont, base)
    n_rows = cont["n_rows"]
    local = cont["packed"] + os.sep
    report = {"manifest": manifest}
    twins = {}
    for label, (flags, full, verdicts, stats) in cont["modes"].items():
        out = os.path.join(root, f"remote.{label}.default.jsonl")
        data, rstats, took, k = drive(
            torch, f"remote containers {label} default",
            ["batch-detect", manifest, "--output", out, *flags], n_rows)
        for name, c in k.items():
            launches["vendored", name] = launches.get(
                ("vendored", name), 0) + c
        with open(out + ".containers.jsonl", "rb") as fh:
            rverdicts = fh.read()
        for twin, extra in (("cpu", ["--device", "cpu"]),
                            ("depth1-workers1", ["--pipeline-depth", "1",
                                                 "--workers", "1"])):
            twins[label, twin] = (flags, extra)
        if (data.replace(base.encode(), local.encode()) != full
                or rverdicts.replace(base.encode(), local.encode())
                != verdicts):
            raise AssertionError(f"remote containers {label}: the rows "
                                 "differ from the local containers' run")
        st, lst = rstats["stage_seconds"], stats["stage_seconds"]
        log(f"remote containers {label}: {n_rows} rows byte-identical to "
            f"the local containers' run (entry paths aside); remote "
            f"{n_rows / st['elapsed']:.1f} rows/s over the run, "
            f"{n_rows / took:.1f} over the command ({took:.2f} s), read "
            f"{st.get('read', 0.0):.4f} s; local {n_rows / lst['elapsed']:.1f}"
            f" rows/s over the run, read {lst.get('read', 0.0):.4f} s")
        report[label] = (out, data, rverdicts)
    # the twins of both modes after the timed runs, over the first 600
    # entries, one at a time: each keeps connections to the blob host
    # open for every container, and two at once have had connections
    # refused
    part = prefix_manifest(manifest, 600)
    n_part = count_rows_expanded(part)
    for (label, twin), (flags, extra) in twins.items():
        twin_out = os.path.join(root, f"remote.{label}.{twin}.jsonl")
        twin_data, _st, _s, k = drive(
            torch, f"remote containers {label} {twin}, first 600 entries",
            ["batch-detect", part, "--output", twin_out, *flags, *extra],
            n_part)
        for name, c in k.items():
            launches["vendored", name] = launches.get(
                ("vendored", name), 0) + c
        _out, data, rverdicts = report[label]
        with open(twin_out + ".containers.jsonl", "rb") as vh:
            if twin_data != first_lines(data, n_part) or not set(
                    vh.read().splitlines()) <= set(rverdicts.splitlines()):
                raise AssertionError(f"remote containers {label}: the "
                                     f"{twin} JSONL or container verdicts "
                                     "differ")
    log(f"remote containers: --device cpu and --pipeline-depth 1 --workers 1 "
        f"over the first 600 entries ({n_part} rows) byte-identical to "
        "those rows, in both modes")
    rc, _o, err, _s = run_verb([
        "batch-detect",
        write_lines(root, "rgit.txt", [base + "repo.git::HEAD"]),
        "--output", os.path.join(root, "rgit.jsonl")])
    if rc == 0 or "git-over-HTTP" not in err:
        raise AssertionError(f"remote git repository not refused: {rc} {err}")
    log("remote containers: a remote git repository refused "
        f"({err.strip().splitlines()[-1][:120]})")
    return report


def cli_process(argv: list[str],
                stdout=subprocess.DEVNULL) -> subprocess.Popen:
    """The port's CLI as a child process (stdout dropped unless asked
    for, stderr piped)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-m", "licensee_tpu_torch.cli.main", *argv],
        stdout=stdout, stderr=subprocess.PIPE, text=True,
        cwd=repo, env={**os.environ, "PYTHONPATH": repo})


def write_lines(root: str, name: str, lines: list) -> str:
    path = os.path.join(root, name)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def republish_drill(root: str, remote: dict, base: str, command) -> None:
    """The license mode's remote output cut mid-line, one archive
    republished on the host (its ETag and length change), and the resume
    must be refused: the expansion fingerprint in the sidecar differs."""
    out, data, _v = remote["license"]
    with open(out, "wb") as fh:
        fh.write(data[: int(len(data) * 0.6)])
    with open(remote["manifest"], encoding="utf-8") as fh:
        name = next(e for e in fh.read().split() if e.startswith(base)
                    ).split("::")[0][len(base):]
    command(f"republish {name}")
    try:
        rc, _o, err, _s = run_verb(["batch-detect", remote["manifest"],
                                    "--output", out])
    finally:
        command(f"restore {name}")
    if rc == 0 or "ingest" not in err:
        raise AssertionError(f"republished {name}: resume not refused "
                             f"({rc}): {err[-1000:]}")
    log(f"remote containers: {name} republished between a cut and the "
        "resume: the resume refused (the sidecar's ingest fingerprint)")


class UtilSampler:
    """``nvidia-smi``'s utilization.gpu (the share of each ~1/6 s sample
    period in which a kernel ran) every 100 ms while the block runs,
    whichever process launched the kernels: the card's busy share of a
    striped run, whose kernels run in child processes."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        vals = [float(v) for v in out.split() if v.strip().isdigit()]
        self.samples = len(vals)
        self.mean = sum(vals) / len(vals) / 100 if vals else None
        return False

    def describe(self) -> str:
        return ("nvidia-smi utilization.gpu not read" if self.mean is None
                else f"nvidia-smi utilization.gpu mean {self.mean:.4f} over "
                f"{self.samples} samples")


def striped(torch, what: str, root: str, manifest: str, n: str,
            full: bytes, extra: list = (), verdicts: bytes = None) -> dict:
    """One `batch-detect --stripes N` run through the CLI with
    --stats-file, --prom-file and --progress: the merged output must be
    ``full`` (and ``verdicts``), its stats reconcile, every exposition
    pass `check_exposition`, every stripe launch K1 on the card, no
    stripe restart, and the progress lines parse.  Returns its numbers."""
    from licensee_tpu_torch.obs import check_exposition

    out = os.path.join(root, f"stripes.{what}.jsonl")
    argv = ["batch-detect", manifest, "--output", out, "--stripes", n,
            "--stats", "--stats-file", out + ".stats", "--prom-file",
            out + ".prom", "--progress", "2", *extra]
    with UtilSampler() as util:
        rc, _o, err, took = run_verb(argv)
    if rc != 0:
        raise RuntimeError(f"stripes {what}: exit {rc}: {err[-3000:]}")
    with open(out, "rb") as fh:
        if fh.read() != full:
            raise AssertionError(f"stripes {what}: merged JSONL differs")
    if verdicts is not None:
        with open(out + ".containers.jsonl", "rb") as fh:
            if fh.read() != verdicts:
                raise AssertionError(f"stripes {what}: merged container "
                                     "verdicts differ")
    lines = err.splitlines()
    stats = json.loads(next(x for x in reversed(lines) if x.startswith("{")))
    matched = sum(stats.get(k, 0) for k in (
        "dice_matched", "reference_matched", "package_matched",
        "prefiltered_copyright", "prefiltered_exact"))
    errors = sum(stats.get(k, 0) for k in (
        "read_errors", "featurize_errors", "skipped_oversized"))
    if stats["total"] != matched + stats["unmatched"] + errors:
        raise AssertionError(f"stripes {what}: stats do not reconcile: "
                             f"{stats}")
    with open(out + ".prom", encoding="utf-8") as fh:
        prom = fh.read()
    if check_exposition(prom):
        raise AssertionError(f"stripes {what}: exposition: "
                             f"{check_exposition(prom)[:3]}")
    k1 = re.findall(r'^device_kernel_launches\{stripe="(stripe\d+)",kernel='
                    r'"(?:best_match_fused|topk_fused)"\} (\S+)', prom, re.M)
    per = {}
    for stripe, c in k1:
        per[stripe] = per.get(stripe, 0) + int(float(c))
    n_stripes = len(re.findall(r'^batch_rows\{stripe="stripe\d+",kind='
                               r'"total"\}', prom, re.M))
    if len(per) != n_stripes or not all(per.values()):
        raise AssertionError(f"stripes {what}: K1 launches by stripe {per} "
                             f"over {n_stripes} stripes")
    if any("; restart " in x for x in lines):
        raise AssertionError(f"stripes {what}: a stripe restarted: "
                             + " | ".join(x for x in lines if "restart" in x))
    progress = [x for x in lines if x.startswith("stripes: progress: ")]
    for x in progress:
        if not re.fullmatch(r"stripes: progress: \d+/\d+ stripes done; "
                            r"shards( \d+:\d+B(\(done\))?)+", x):
            raise AssertionError(f"stripes {what}: progress line {x!r}")
    done = next(x for x in lines if x.startswith("stripes: done: "))
    rows = stats["total"]
    got = {"rows_per_s": rows / took, "seconds": took,
           "read_s": stats["stage_seconds"].get("read", 0.0),
           "busy": util.mean, "stripes": n_stripes}
    log(f"stripes {what}: {rows} rows in {took:.2f} s, "
        f"{rows / took:.1f} rows/s over the command ({done[9:]}); summed "
        f"read {got['read_s']:.4f} s, featurize "
        f"{stats['stage_seconds'].get('featurize', 0.0):.4f} s; K1 launches "
        f"by stripe {per}; {len(progress)} progress lines; "
        f"{util.describe()}; merged output, stats and exposition checked")
    return got


def count_rows_expanded(manifest: str) -> int:
    """A container manifest's expanded rows (metadata only)."""
    from licensee_tpu_torch.ingest.sources import expanded_layout

    with open(manifest, encoding="utf-8") as fh:
        return expanded_layout(fh.read().split())["total"]


def find_stripe(out: str, index: int) -> int | None:
    """The pid of the live stripe child ``index`` writing for ``out``."""
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as fh:
                cmd = fh.read().split(b"\0")
        except OSError:
            continue
        if (out.encode() in cmd and b"--stripe-index" in cmd and cmd[
                cmd.index(b"--stripe-index") + 1] == str(index).encode()):
            return int(name)
    return None


def kill_drill(root: str, manifest: str, full: bytes) -> None:
    """`--stripes 2` as a child process whose stripe 0 is SIGKILLed when
    its shard holds a fifth of its rows: the runner must count the
    restart, and the merge must reach the full run's sha256."""
    import hashlib
    import signal

    out = os.path.join(root, "stripes.killed.jsonl")
    shard = f"{out}.shard-00000-of-00002"
    repo = os.path.dirname(os.path.abspath(__file__))
    log_path = out + ".stderr"
    with open(log_path, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "licensee_tpu_torch.cli.main",
             "batch-detect", manifest, "--output", out, "--stripes", "2"],
            stdout=subprocess.DEVNULL, stderr=err, cwd=repo,
            env={**os.environ, "PYTHONPATH": repo})
    killed = None
    deadline = time.monotonic() + 300
    while proc.poll() is None and time.monotonic() < deadline:
        size = os.path.getsize(shard) if os.path.exists(shard) else 0
        if killed is None and size > len(full) // 10:
            killed = find_stripe(out, 0)
            if killed is not None:
                os.kill(killed, signal.SIGKILL)
        time.sleep(0.05)
    rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    with open(log_path, encoding="utf-8", errors="replace") as fh:
        err = fh.read()
    if rc != 0 or killed is None:
        raise AssertionError(f"kill drill: exit {rc}, killed {killed}: "
                             f"{err[-3000:]}")
    if "stripe 0: " not in err or "; restart 1/" not in err:
        raise AssertionError(f"kill drill: the runner did not count the "
                             f"restart: {err[-3000:]}")
    with open(out, "rb") as fh:
        data = fh.read()
    if hashlib.sha256(data).digest() != hashlib.sha256(full).digest():
        raise AssertionError("kill drill: the merged sha256 differs")
    log(f"stripes kill drill: stripe 0 (pid {killed}) SIGKILLed mid-run, "
        "its restart counted by the runner, resumed; merged sha256 "
        f"{hashlib.sha256(data).hexdigest()} equals the unstriped run's")


def start_selftests() -> dict:
    """`batch-detect --selftest`, `--selftest-remote` and
    `--selftest-autoscale` on the card, as three child processes at once
    (`finish_selftests` waits for them)."""
    return {flag: cli_process(["batch-detect", flag])
            for flag in ("--selftest", "--selftest-remote",
                         "--selftest-autoscale")}


def finish_selftests(procs: dict, t0: float) -> None:
    for flag, proc in procs.items():
        _out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"batch-detect {flag}: exit "
                                 f"{proc.returncode}: {err[-3000:]}")
        oks = [x for x in err.splitlines() if ": OK" in x]
        log(f"batch-detect {flag}: passed on the card ({len(oks)} OK "
            f"lines: {oks[-1][:160] if oks else ''})")
    log(f"selftests: done {time.perf_counter() - t0:.1f} s after their "
        "start (beside phase 10's runs)")


def phase_scale(np, torch, seed: int, root: str, inputs: dict,
                launches: dict) -> None:
    """Phase 10 after K5 (`phase_k5`): `batch-detect` at scale on the
    card (the module's docstring lists its runs)."""
    t_phase = time.perf_counter()
    card = smi("name,power.limit")
    log(f"phase 10 (scale): {card}; host nproc {os.cpu_count()}")
    # the selftests' child processes run beside the whole phase
    t_self, selftest_procs = time.perf_counter(), start_selftests()
    mesh_and_lanes(torch, root, inputs, launches)
    serve_mesh(torch, inputs)
    cont = inputs["containers"]
    timing = {}
    with blob_host(cont["packed"]) as (base, command):
        remote = remote_containers(torch, root, cont, base, command,
                                   launches)
        # the stripes over the first 10,001 rows of phase 5's manifest
        # (the script's time: phases 11 and 12 came after them)
        big = prefix_manifest(inputs["big"], 10001)
        full = first_lines(inputs["big_full"], 10001)
        for n in ("1", "2", "4"):
            timing[f"stripes {n}"] = striped(torch, f"vendored{n}", root,
                                             big, n, full)
        kill_drill(root, big, full)
        with open(os.path.join(root, "scale.vendored.default.jsonl"),
                  "rb") as fh:
            slice_full = fh.read()
        timing["elastic"] = striped(
            torch, "elastic", root, inputs["vendored"], "elastic",
            slice_full, ["--autoscale-min", "1", "--autoscale-max", "2",
                         "--autoscale-cooldown", "2"])
        # the first 200 containers of the remote manifest (~850 rows),
        # the stripes' span boundary inside an archive
        with open(remote["manifest"], encoding="utf-8") as fh:
            part = write_lines(root, "remote200.txt",
                               fh.read().splitlines()[:200])
        n_part = count_rows_expanded(part)
        out = os.path.join(root, "remote200.jsonl")
        data, _st, _s, _k = drive(torch, "remote containers, 200",
                                  ["batch-detect", part, "--output", out],
                                  n_part)
        with open(out + ".containers.jsonl", "rb") as fh:
            verdicts = fh.read()
        timing["remote stripes 2"] = striped(
            torch, "remote2", root, part, "2", data, verdicts=verdicts)
        finish_selftests(selftest_procs, t_self)
        republish_drill(root, remote, base, command)
    log("stripes timing: " + card + "; " + "; ".join(
        f"{k}: {v['rows_per_s']:.1f} rows/s over {v['seconds']:.2f} s, read "
        f"{v['read_s']:.4f} s summed, busy "
        + ("not measured" if v["busy"] is None else f"{v['busy']:.4f}")
        for k, v in timing.items()))
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 8: detect -----------------------------------------------------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures")


def run_verb(argv: list[str], stdin: str = "") -> tuple:
    """(exit code, stdout, stderr, seconds) of one call of the port's CLI
    in this process, ``stdin`` on its standard input."""
    from licensee_tpu_torch.cli.main import main as cli

    out, err = io.StringIO(), io.StringIO()
    saved, sys.stdin = sys.stdin, io.StringIO(stdin)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli(argv)
    finally:
        sys.stdin = saved
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def detect_fixtures(root: str) -> list[float]:
    """`detect` and `detect --json` over every fixture directory: the
    license, its file's matcher and content hash as fixtures.yml pins
    them (read by the port's `corpus/yamlite.py`), in the output and in
    the project it printed; then detect.json as
    tests/test_cli.py::test_detect_json_full_golden builds its case, and
    a few fixtures as git repositories (written in Python, read by the
    native object-store backend) against their directories.  Returns
    the seconds each fixture's text `detect` took."""
    import licensee_tpu_torch
    from licensee_tpu_torch.corpus import yamlite
    from licensee_tpu_torch.corpus.license import License

    with open(os.path.join(FIXTURES, "fixtures.yml"), encoding="utf-8") as fh:
        golden = yamlite.load_document(fh.read())
    seconds = []
    for name in sorted(golden):
        want = golden[name] or {}
        path = os.path.join(FIXTURES, name)
        rc, text, _err, took = run_verb(["detect", path])
        seconds.append(took)
        rc_json, js, _err, _s = run_verb(["detect", "--json", path])
        project = licensee_tpu_torch.project(path, detect_packages=True,
                                             detect_readme=True)
        lf = project.license_file
        got = {
            "key": project.license.key if project.license else None,
            "matcher": lf.matcher.name if lf and lf.matcher else None,
            "hash": lf.content_hash if lf else None,
        }
        if got != {k: want.get(k) for k in got}:
            raise AssertionError(f"detect {name}: {got} != fixtures.yml "
                                 f"{want}")
        data = json.loads(js)
        if rc != rc_json or rc != (0 if data["licenses"] else 1):
            raise AssertionError(f"detect {name}: exit codes {rc}, {rc_json}")
        first = text.splitlines()[0].split(None, 1)
        if want.get("key") and project.license == License.find(want["key"]):
            if first != ["License:", project.license.spdx_id]:
                raise AssertionError(f"detect {name}: first line {first}")
        if want.get("hash"):
            files = {(f["content_hash"], (f["matcher"] or {}).get("name"))
                     for f in data["matched_files"]}
            if (f"Content hash:  {want['hash']}" not in text or
                    (want["hash"], want["matcher"]) not in files):
                raise AssertionError(f"detect {name}: hash or matcher "
                                     "missing from the output")
    with open(os.path.join(FIXTURES, "detect.json"), encoding="utf-8") as fh:
        fixture = json.load(fh)
    case = os.path.join(root, "detect-json")
    os.makedirs(case)
    for i, fname in enumerate(("LICENSE.md", "licensee.gemspec")):
        with open(os.path.join(case, fname), "w", encoding="utf-8") as fh:
            fh.write(fixture["matched_files"][i]["content"])
    rc, js, _err, _s = run_verb(["detect", "--json", case])
    got = json.loads(js)
    for d in (fixture, got):
        d["matched_files"][1].pop("content", None)
    if rc != 0 or got != fixture:
        raise AssertionError("detect --json differs from detect.json")
    for name in ("mit", "lgpl", "multiple-license-files", "apache-2.0_markdown"):
        src = os.path.join(FIXTURES, name)
        repo = os.path.join(root, "git-" + name)
        files = []
        for fname in sorted(os.listdir(src)):
            if os.path.isfile(os.path.join(src, fname)):
                with open(os.path.join(src, fname), "rb") as fh:
                    files.append((fname, fh.read()))
        write_git_objects(repo, files)
        project = licensee_tpu_torch.project(repo)
        backend = type(getattr(project, "_backend", None)).__name__
        as_git = run_verb(["detect", "--json", repo])
        as_dir = run_verb(["detect", "--json", src])
        if backend != "_NativeBackend" or as_git[:2] != as_dir[:2]:
            raise AssertionError(f"detect {name} as a git repository "
                                 f"({backend}) differs from the directory")
    return seconds


def other_verbs() -> None:
    """`license-path` (present and missing), `version`, `help`, the
    bare-path default, and `diff`'s exact-match and invalid-license
    branches (its word diff needs git, which this host may lack)."""
    import licensee_tpu_torch

    mit = os.path.join(FIXTURES, "mit")
    checks = {
        "license-path": (run_verb(["license-path", mit]),
                         (0, os.path.join(mit, "LICENSE.txt") + "\n")),
        "license-path missing": (
            run_verb(["license-path", os.path.join(FIXTURES, "readme")]),
            (1, "")),
        "version": (run_verb(["version"]),
                    (0, licensee_tpu_torch.__version__ + "\n")),
    }
    for what, (got, want) in checks.items():
        if got[:2] != want:
            raise AssertionError(f"{what}: {got[:3]} != {want}")
    rc, out, _err, _s = run_verb(["help"])
    if rc != 0 or not out.startswith("Licensee commands:") or not all(
            f" {verb} " in out for verb in
            ("detect", "diff", "license-path", "version", "batch-detect")):
        raise AssertionError(f"help: {out!r}")
    if run_verb([mit])[:3] != run_verb(["detect", mit])[:3]:
        raise AssertionError("a bare path does not run detect")
    rc, out, _err, _s = run_verb(["diff", mit, "--license", "mit"])
    if rc != 0 or not out.rstrip().endswith("Exact match!"):
        raise AssertionError(f"diff exact: {rc} {out!r}")
    with open(os.path.join(mit, "LICENSE.txt"), encoding="utf-8") as fh:
        rc, out_stdin, _err, _s = run_verb(["diff", "--license", "mit"],
                                           stdin=fh.read())
    if rc != 0 or out_stdin != out:
        raise AssertionError("diff of stdin differs from the project's")
    rc, out, err, _s = run_verb(["diff", mit, "--license", "not-a-license"])
    if rc != 1 or out or not err.startswith(
            "not-a-license is not a valid license\nValid licenses: "):
        raise AssertionError(f"diff invalid license: {rc} {err!r}")


def dice_xla_on_card(torch, device: str = "cuda") -> tuple:
    """The DiceXLA matcher on ``device`` against the scalar Dice on every
    fixture's license file, the launch counts reset before and read
    after.  Returns (files, launches, per-file ms, device ms of K1 at
    the matcher's one-row batch replayed from a CUDA graph)."""
    from licensee_tpu_torch.kernels import dice_cuda
    from licensee_tpu_torch.matchers import Dice, DiceXLA, dice_xla_matcher
    from licensee_tpu_torch.projects import FSProject

    dice_xla_matcher.use_device(device)
    files = []
    for name in sorted(os.listdir(FIXTURES)):
        if os.path.isdir(os.path.join(FIXTURES, name)):
            lf = FSProject(os.path.join(FIXTURES, name),
                           detect_packages=False,
                           detect_readme=False).license_file
            if lf is not None:
                files.append(lf)
    dice_xla_matcher._shared_classifier()  # set-up outside the timing
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
    dice_cuda.reset_launches()
    t0 = time.perf_counter()
    got = [(m.match, m.confidence) for m in map(DiceXLA, files)]
    if on_card:
        torch.cuda.synchronize()
    per_file_ms = (time.perf_counter() - t0) / len(files) * 1e3
    launches = dice_cuda.LAUNCHES["best_match_fused"]
    others = {k: n for k, n in dice_cuda.LAUNCHES.items()
              if n and k != "best_match_fused"}
    want = [(d.match, d.confidence) for d in map(Dice, files)]
    if got != want:
        bad = [f.filename for f, g, w in zip(files, got, want) if g != w]
        raise AssertionError(f"DiceXLA != Dice on {bad}")
    if on_card and (launches != len(files) or others):
        raise AssertionError(f"DiceXLA: {launches} best_match_fused "
                             f"launches for {len(files)} files, and "
                             f"{others}")
    graph_ms = None
    if on_card:
        clf = dice_xla_matcher._shared_classifier()
        prepared = clf.prepare_batch([files[0].content], prefilter=False)
        feats = [torch.from_numpy(a[:1]).to(device) for a in (
            prepared.bits.view("int32"), prepared.n_words, prepared.lengths,
            prepared.cc_fp)]
        args = (dice_cuda.pack_meta(clf.tensors), clf.tensors.bits, *feats)
        held_against_plain(torch, "DiceXLA's K1 call",
                           lambda: dice_cuda.best_match_fused(*args),
                           lambda: dice_cuda.best_match_fused_plain(*args))
        graph_ms = graph_time_ms(
            torch, lambda: dice_cuda.best_match_fused(*args), 12)
    return len(files), launches, per_file_ms, graph_ms


def stdout_rows(torch, root: str, manifest: str, device: str) -> tuple:
    """`batch-detect` without --output on ``device`` (the launch counts
    reset before and read after), against the same run with --output:
    the stdout rows must be the file's bytes.  Returns (stdout,
    launches, stats)."""
    from licensee_tpu_torch.kernels import dice_cuda

    argv = ["batch-detect", manifest, "--device", device, "--stats"]
    if device == "cuda":
        torch.cuda.synchronize()
    dice_cuda.reset_launches()
    rc, out, err, took = run_verb(argv)
    launches = dict(dice_cuda.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"batch-detect {argv} exited {rc}: {err[-2000:]}")
    stats = json.loads(err.strip().splitlines()[-1])
    output = os.path.join(root, f"stdout-twin.{device}.jsonl")
    run_cli([*argv, "--output", output])
    with open(output, encoding="utf-8") as fh:
        if fh.read() != out:
            raise AssertionError(f"batch-detect stdout on {device} differs "
                                 "from its --output rows")
    n_rows = count_rows(manifest)
    if out.count("\n") != n_rows or stats["total"] != n_rows:
        raise AssertionError(f"batch-detect stdout: {out.count(chr(10))} "
                             f"rows for {n_rows} entries")
    log(f"batch-detect stdout --device {device}: {n_rows} rows in "
        f"{took:.3f} s ({n_rows / took:.1f} rows/s), read_errors "
        f"{stats['read_errors']}, skipped_oversized "
        f"{stats['skipped_oversized']}; launches {json.dumps(launches)}")
    return out, launches, stats


def phase_detect(torch, root: str, manifest: str, launches: dict) -> None:
    """Phase 8: `detect` and its sibling verbs, the DiceXLA matcher on the
    card, and `batch-detect` on stdout over the vendored slice
    manifest."""
    t0 = time.perf_counter()
    seconds = detect_fixtures(root)
    other_verbs()
    log(f"detect: {len(seconds)} fixtures (text and --json) agree with "
        f"fixtures.yml and detect.json; license-path, version, help, the "
        f"bare path and diff agree ({time.perf_counter() - t0:.1f} s)")
    n_files, n_launch, per_file_ms, graph_ms = dice_xla_on_card(torch)
    launches["detect", "best_match_fused"] = n_launch
    seconds.sort()
    log(f"detect timing: {smi('name,power.limit')}; detect wall per "
        f"fixture: median {seconds[len(seconds) // 2] * 1e3:.2f} ms, min "
        f"{seconds[0] * 1e3:.2f}, max {seconds[-1] * 1e3:.2f}, total "
        f"{sum(seconds):.3f} s over {len(seconds)}; DiceXLA per file: "
        f"eager {per_file_ms:.3f} ms (featurize, dispatch, K1 at B=1), "
        f"K1 graph {graph_ms:.4f} ms; {n_files} files, best_match_fused "
        f"launches {n_launch}, (key, confidence) equal to Dice on each")
    card, card_launches, card_stats = stdout_rows(torch, root, manifest,
                                                  "cuda")
    if not card_launches["best_match_fused"]:
        raise AssertionError("batch-detect stdout never launched "
                             "best_match_fused")
    for name, n in card_launches.items():
        launches["vendored", name] = launches.get(("vendored", name), 0) + n
    cpu, _l, cpu_stats = stdout_rows(torch, root, manifest, "cpu")
    if card != cpu or card_stats["read_errors"] != cpu_stats["read_errors"]:
        raise AssertionError("batch-detect stdout: the card's rows differ "
                             "from --device cpu")
    log("batch-detect stdout: the card's rows equal its --output rows and "
        "the --device cpu rows")


# -- phase 9: serve --------------------------------------------------------------


@dataclasses.dataclass
class ServeScale:
    """How much traffic phase 9 sends: the defaults on the card, `tiny`
    for the test that runs the phase on the CPU."""

    mixed_repos: int = 480      # the auto session: ~2,000 crawl files
    vendored_files: int = 2000  # the license session
    variants: int = 5000        # the 64-client runs at T=47
    variants_608: int = 2500    # and at T=608
    clients: int = 64
    window: int = 8             # requests each client keeps in flight
    single: int = 400           # the one-client runs
    reload_requests: int = 3000
    profiled: int = 2500

    @classmethod
    def tiny(cls) -> "ServeScale":
        return cls(mixed_repos=12, vendored_files=50, variants=300,
                   variants_608=120, clients=4, window=4, single=12,
                   reload_requests=200, profiled=100)


def request_line(obj: dict) -> bytes:
    return json.dumps(obj).encode() + b"\n"


def file_requests(paths: list) -> list:
    """One request a readable file (raw bytes as ``content_b64``, the
    file's basename as ``filename``), then a repeat of every seventh:
    (request objects, {id: path})."""
    import base64

    reqs, by_id = [], {}
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p, "rb") as fh:
            raw = fh.read()
        rid = len(reqs)
        by_id[rid] = p
        reqs.append({"id": rid, "filename": os.path.basename(p),
                     "content_b64": base64.b64encode(raw).decode()})
    for r in reqs[::7]:
        rid = len(reqs)
        by_id[rid] = by_id[r["id"]]
        reqs.append({**r, "id": rid})
    return reqs, by_id


def variant_requests(bases: list, n: int, tag: str) -> list:
    """``n`` license-mode requests, nine in ten distinct Dice-bound
    variants (a base text with a made-up word appended), every tenth a
    repeat of an earlier one (a cache hit or a coalesced duplicate)."""
    texts = []
    for i in range(n):
        if i % 10 == 9:
            texts.append(texts[i // 2])
        else:
            texts.append(f"{bases[i % len(bases)][1]}\nzq{tag}{i}\n")
    return [{"id": i, "content": t, "filename": "LICENSE"}
            for i, t in enumerate(texts)]


def verdict_of(row: dict) -> dict:
    """A response row without what depends on timing: the trace ID and
    whether a duplicate rode the cache or its twin's device slot."""
    return {k: v for k, v in row.items() if k not in ("trace", "cached")}


def serve_session_rows(batcher, reqs: list) -> tuple:
    """(rows by id, seconds) of one in-process `serve_session`."""
    from licensee_tpu_torch.serve.server import serve_session

    out = []
    lines = [json.dumps(r) for r in reqs]
    t0 = time.perf_counter()
    counts = serve_session(batcher, lines, out.append)
    took = time.perf_counter() - t0
    if counts != {"requests": len(lines), "responses": len(lines)}:
        raise AssertionError(f"serve_session: {counts}")
    rows = [json.loads(line) for line in out]
    return {r["id"]: r for r in rows}, took


def cpu_rows(reqs: list, **kwargs) -> dict:
    """The same requests through a `device="cpu"` batcher (a queue deep
    enough that one session never fills it): the reference rows."""
    from licensee_tpu_torch.serve.scheduler import MicroBatcher

    with MicroBatcher(device="cpu", queue_depth=len(reqs) + 1,
                      **kwargs) as batcher:
        rows, _s = serve_session_rows(batcher, reqs)
    return rows


def connect(target: str, timeout: float):
    import socket

    from licensee_tpu_torch.serve.eventloop import parse_target

    kind, addr = parse_target(target)
    sock = socket.socket(socket.AF_UNIX if kind == "unix" else socket.AF_INET,
                         socket.SOCK_STREAM)
    sock.settimeout(timeout)
    sock.connect(addr)
    return sock


def socket_run(target: str, reqs: list, clients: int, window: int,
               control=None, timeout: float = 120.0) -> tuple:
    """`client_run` over the JSONL socket: (rows by id, seconds)."""
    rows, took, _lat = client_run(target, reqs, clients, window, control,
                                  timeout)
    return rows, took


def http_request(obj: dict, token: str | None = None) -> bytes:
    """One keep-alive ``POST /classify`` of the fleet's HTTP edge (with
    ``token``, under that bearer token)."""
    body = json.dumps(obj).encode()
    auth = b"Authorization: Bearer %s\r\n" % token.encode() if token else b""
    return (b"POST /classify HTTP/1.1\r\nHost: edge\r\n" + auth
            + b"Content-Type: application/json\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body)) + body


def read_http(fh) -> tuple:
    """(status, body) of one HTTP/1.1 response read from ``fh``."""
    status = fh.readline()
    if not status:
        raise ConnectionError("the edge hung up")
    length = 0
    while (line := fh.readline()) not in (b"\r\n", b""):
        name, _, value = line.partition(b":")
        if name.strip().lower() == b"content-length":
            length = int(value)
    return int(status.split()[1]), fh.read(length)


def client_run(target: str, reqs: list, clients: int, window: int,
               control=None, timeout: float = 120.0,
               http: bool = False, token: str | None = None) -> tuple:
    """``clients`` closed-loop clients over the socket (with ``http``, the
    fleet's HTTP edge, keep-alive), each on its own connection sending
    its share of ``reqs`` ``window`` requests at a time and reading their
    answers before it sends more.  With ``control``, ``control(rows)``
    runs meanwhile on this thread and the clients hold the last third of
    their shares until it returns, so traffic flows before, during and
    after what it does.  Returns (rows by id, seconds, each request's
    milliseconds from its window's write to its answer).  A non-200
    answer of the edge is an error; ``token`` is the edge's bearer
    token."""
    import threading

    rows: dict = {}
    lats: list = []
    errors: list = []
    resume = threading.Event()
    if control is None:
        resume.set()

    def client(k: int) -> None:
        mine = reqs[k::clients]
        try:
            with connect(target, timeout) as sock, \
                    sock.makefile("rwb") as fh:
                for i in range(0, len(mine), window):
                    if 3 * i >= 2 * len(mine) and not resume.wait(300):
                        raise TimeoutError("control never resumed")
                    part = mine[i:i + window]
                    frame = (functools.partial(http_request, token=token)
                             if http else request_line)
                    t_sent = time.perf_counter()
                    fh.write(b"".join(frame(r) for r in part))
                    fh.flush()
                    for r in part:
                        if http:
                            code, line = read_http(fh)
                            if code != 200:
                                raise ConnectionError(f"HTTP {code}: {line}")
                        else:
                            line = fh.readline()
                        if not line:
                            raise ConnectionError("the worker hung up")
                        lats.append((time.perf_counter() - t_sent) * 1e3)
                        row = json.loads(line)
                        if row.get("id") != r["id"]:
                            raise AssertionError(f"answer {row} to {r['id']}")
                        rows[row["id"]] = row
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(f"client {k}: {exc!r}")

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if control is not None:
        try:
            control(rows)
        finally:
            resume.set()
    for t in threads:
        t.join(timeout=timeout)
    took = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"socket clients: {errors[:3]}, "
                             f"{sum(t.is_alive() for t in threads)} hung")
    if len(rows) != len(reqs):
        raise AssertionError(f"socket run: {len(rows)} rows for "
                             f"{len(reqs)} requests")
    return rows, took, lats


def client_process(target: str, reqs: list, clients: int, window: int,
                   root: str, timeout: float = 900.0) -> tuple:
    """`socket_run`'s clients in a child process (``chip_smoke.py
    --serve-clients``), as a user's clients are: they do not share the
    worker's interpreter lock.  Returns (rows by id, the clients'
    seconds, the child's own start-up excluded)."""
    src = os.path.join(root, "clients.in.jsonl")
    dst = os.path.join(root, "clients.out.json")
    with open(src, "wb") as fh:
        fh.writelines(request_line(r) for r in reqs)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--serve-clients",
         target, src, dst, str(clients), str(window)],
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"serve clients exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    with open(dst, encoding="utf-8") as fh:
        got = json.load(fh)
    return {r["id"]: r for r in got["rows"]}, got["seconds"]


def serve_clients_main(target: str, src: str, dst: str, clients: str,
                       window: str) -> int:
    """The child of `client_process`: the requests of ``src`` (JSONL)
    over ``target``, the rows and seconds into ``dst``."""
    with open(src, encoding="utf-8") as fh:
        reqs = [json.loads(line) for line in fh]
    rows, took = socket_run(target, reqs, int(clients), int(window))
    with open(dst, "w", encoding="utf-8") as fh:
        json.dump({"rows": list(rows.values()), "seconds": took}, fh)
    return 0


@contextlib.contextmanager
def socket_worker(batcher, root: str):
    """`serve_unix`'s server in a thread on a socket under ``root`` (on
    127.0.0.1 where the path would pass the AF_UNIX length limit):
    yields its target; on exit the server shuts down, its thread is
    joined and the socket unlinked."""
    import threading

    from licensee_tpu_torch.serve.server import UnixServer

    path = os.path.join(root, f"w{os.getpid()}.sock")
    server = UnixServer(path if len(path) < 100 else "127.0.0.1:0", batcher)
    target = path if server.kind == "unix" else f"127.0.0.1:{server.bound_port}"
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.2}, daemon=True)
    thread.start()
    try:
        yield target
    finally:
        server.shutdown()
        thread.join(timeout=60.0)
        server.server_close()
        with contextlib.suppress(OSError):
            os.unlink(path)
        if thread.is_alive():
            raise AssertionError("the socket worker's thread did not end")


def held_to_reference(what: str, rows: dict, want: dict) -> None:
    """Every row equal to the reference row of its id, trace ID and
    cache flag aside, and none an error."""
    bad = [i for i in want if verdict_of(rows[i]) != verdict_of(want[i])]
    errors = [r for r in rows.values() if r.get("error")]
    if bad or errors:
        raise AssertionError(
            f"serve {what}: {len(bad)} rows differ from the device='cpu' "
            f"batcher's (e.g. {[(rows[i], want[i]) for i in bad[:2]]}), "
            f"{len(errors)} error rows (e.g. {errors[:2]})")


def held_to_batch_detect(mode: str, rows: dict, by_id: dict, root: str,
                         device: str) -> None:
    """The session's verdicts against `batch-detect` over the same files
    (its stdout rows: key, matcher, confidence)."""
    paths = sorted(set(by_id.values()))
    manifest = os.path.join(root, f"serve-{mode}.manifest")
    with open(manifest, "w", encoding="utf-8") as fh:
        fh.write("\n".join(paths) + "\n")
    rc, out, err, _s = run_verb(["batch-detect", manifest, "--mode", mode,
                                 "--device", device])
    if rc != 0:
        raise RuntimeError(f"batch-detect for serve {mode}: {err[-2000:]}")
    want = {}
    for line in out.splitlines():
        row = json.loads(line)
        if "path" in row:
            want[row["path"]] = (row["key"], row["matcher"],
                                 row["confidence"])
    bad = [i for i, p in by_id.items()
           if (rows[i].get("key"), rows[i].get("matcher"),
               rows[i].get("confidence")) != want[p]]
    if bad:
        i = bad[0]
        raise AssertionError(f"serve {mode}: {len(bad)} rows differ from "
                             f"batch-detect, e.g. {rows[i]} vs "
                             f"{want[by_id[i]]} ({by_id[i]})")


def summary(stats: dict, n: int, took: float) -> dict:
    lat = stats["latency_ms"]
    return {
        "requests": n,
        "seconds": took,
        "requests_per_s": n / took,
        **{f"{stage}_{q}_ms": lat[stage][f"{q}_ms"]
           for stage in ("total", "queue_wait", "device")
           for q in ("p50", "p99")},
        "flush": stats["scheduler"]["flush"],
        "buckets": stats["scheduler"]["buckets"],
        "device_batches": stats["scheduler"]["device_batches"],
        "fallbacks": stats["scheduler"]["fallbacks"],
        "completion_errors": stats["scheduler"]["completion_errors"],
    }


class ServeRun:
    """One card batcher's run, from its construction to its close: the
    launch counts are reset before it is built and read after it is
    closed, then held to what the scheduler counted (`check`)."""

    def __init__(self, what: str, device: str, **kwargs):
        from licensee_tpu_torch.kernels import dice_cuda
        from licensee_tpu_torch.serve.scheduler import MicroBatcher

        self.what, self.device = what, device
        if device == "cuda":
            import torch

            torch.cuda.synchronize()
        dice_cuda.reset_launches()
        self.batcher = MicroBatcher(device=device, warm_start=True, **kwargs)

    def check(self, epochs: int = 1) -> tuple:
        """Close the batcher; fail unless no request fell back or lost its
        completion, each bucket was set up once, before any live flush,
        and (on the card) `best_match_fused` launched exactly once per
        flush, per warm-up probe (one a bucket for each of ``epochs``
        classifiers) and per reload validation (``epochs`` - 1), and no
        other kernel launched.  Returns (stats, launches)."""
        from licensee_tpu_torch.kernels import dice_cuda

        self.batcher.close()
        stats = self.batcher.stats()
        launches = dict(dice_cuda.LAUNCHES)
        sched = stats["scheduler"]
        problems = []
        if sched["fallbacks"] or sched["completion_errors"]:
            problems.append(f"fallbacks {sched['fallbacks']}, completion "
                            f"errors {sched['completion_errors']}")
        buckets = list(self.batcher.buckets)
        per_shape = stats["device"]["per_shape"]
        if (sorted(per_shape) != buckets or stats["device"]["compiles"]
                != len(buckets) or any(per_shape[b]["compiles"] != 1
                                       for b in buckets)):
            problems.append(f"bucket set-up: {stats['device']}")
        if self.device == "cuda":
            want = (sched["device_batches"] + epochs * len(buckets)
                    + epochs - 1)
            others = {k: n for k, n in launches.items()
                      if n and k != "best_match_fused"}
            if launches["best_match_fused"] != want or others:
                problems.append(
                    f"launches {launches}: want best_match_fused {want} "
                    f"({sched['device_batches']} flushes, {len(buckets)} "
                    f"warm-up probes x {epochs}, {epochs - 1} validations)"
                    " and nothing else")
        if problems:
            raise AssertionError(f"serve {self.what}: {problems}")
        return stats, launches


class ThreadProbe:
    """Where some threads of this process stand over a run: a sampler
    thread reads their stacks every ``interval`` seconds, and each
    thread's clocks are read at the start and the end.  A sample is labelled with the innermost function of the port and the
    innermost function of all (``_complete_group>result``: the
    completion thread awaiting a flush's event).  The sampler takes the
    interpreter lock to read the stacks, so a thread it finds in Python
    code is waiting for that lock or was preempted there.  Each
    thread's on-CPU seconds come from its CPU-time clock
    (``time.pthread_getcpuclockid``), its run-queue seconds from the
    kernel's ``/proc/self/task/<tid>/schedstat`` where it can be read."""

    PORT = os.sep + "licensee_tpu_torch" + os.sep

    def __init__(self, threads: dict, interval: float = 0.001):
        import collections
        import threading

        self.threads, self.interval = threads, interval
        self.samples = {name: collections.Counter() for name in threads}
        self._stop = threading.Event()
        self._sampler = threading.Thread(target=self._loop, daemon=True)

    @staticmethod
    def _clocks(thread) -> tuple:
        """(on-CPU seconds, run-queue seconds), each None where the
        host cannot read it."""
        try:
            on_cpu = time.clock_gettime(
                time.pthread_getcpuclockid(thread.ident))
        except OSError:
            on_cpu = None
        try:
            with open(f"/proc/self/task/{thread.native_id}/schedstat",
                      encoding="ascii") as fh:
                queued = int(fh.read().split()[1]) / 1e9
        except (OSError, ValueError, IndexError):
            queued = None
        return on_cpu, queued

    def _where(self, frame) -> str:
        leaf, port = frame.f_code.co_name, None
        while frame is not None and port is None:
            if self.PORT in frame.f_code.co_filename:
                port = frame.f_code.co_name
            frame = frame.f_back
        return leaf if port in (None, leaf) else f"{port}>{leaf}"

    def _loop(self) -> None:
        idents = {t.ident: name for name, t in self.threads.items()}
        while not self._stop.wait(self.interval):
            frames = sys._current_frames()
            for ident, name in idents.items():
                if ident in frames:
                    self.samples[name][self._where(frames[ident])] += 1

    def __enter__(self) -> "ThreadProbe":
        self._t0 = time.perf_counter()
        self._start = {n: self._clocks(t) for n, t in self.threads.items()}
        self._sampler.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._sampler.join(timeout=10.0)
        self.wall = time.perf_counter() - self._t0
        self._end = {n: self._clocks(t) for n, t in self.threads.items()}

    def report(self) -> dict:
        """{thread: {on_cpu_s, run_queue_s, wall_s, samples, top}}, the
        top being the six commonest places with their share of the
        samples; either seconds None where the host cannot read it."""
        out = {}
        for name, counts in self.samples.items():
            a, b = self._start[name], self._end[name]
            n = sum(counts.values())
            out[name] = {
                **{key: None if a[i] is None or b[i] is None
                   else b[i] - a[i]
                   for i, key in enumerate(("on_cpu_s", "run_queue_s"))},
                "wall_s": self.wall,
                "samples": n,
                "top": [[where, round(k / n, 4)]
                        for where, k in counts.most_common(6)],
            }
        return out


def serve_children(target: str, device: str, stdio_reqs: list,
                   stdio_want: dict, diff_text: str) -> None:
    """The port's CLI in child processes, started together: `serve
    --selftest`, `serve --selftest-reload`, a piped `serve --stats`
    session (its rows equal the in-process ones, ``fallbacks`` 0 on
    stderr) and `diff --socket` of ``diff_text`` on its stdin against
    the in-process worker at ``target`` (its stdout the diff verb's
    payload as `diff` renders it)."""
    from licensee_tpu_torch.cli.main import _print_table
    from licensee_tpu_torch.fleet.wire import oneshot
    from licensee_tpu_torch.normalize.pipeline import format_percent

    cli = [sys.executable, "-m", "licensee_tpu_torch.cli.main"]
    dev = ["--device", "cpu"] if device == "cpu" else []
    here = os.path.dirname(os.path.abspath(__file__))
    procs = {
        "selftest": (cli + ["serve", "--selftest", *dev], None),
        "selftest-reload": (cli + ["serve", "--selftest-reload", *dev], None),
        "stdio": (cli + ["serve", "--stats", *dev],
                  b"".join(request_line(r) for r in stdio_reqs)),
        "diff": (cli + ["diff", "--socket", target], diff_text.encode()),
    }
    started = {
        name: (subprocess.Popen(argv, cwd=here, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE), stdin)
        for name, (argv, stdin) in procs.items()
    }
    done = {}
    for name, (proc, stdin) in started.items():
        try:
            out, err = proc.communicate(stdin or b"", timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"serve child {name} timed out") from None
        done[name] = (proc.returncode, out.decode(), err.decode())
    for name in ("selftest", "selftest-reload"):
        rc, out, err = done[name]
        last = json.loads(out.strip().splitlines()[-1]) if out.strip() else {}
        if rc != 0 or last.get("problems") != []:
            raise AssertionError(f"serve --{name}: exit {rc}, {out[-1000:]}"
                                 f" {err[-1000:]}")
    rc, out, err = done["stdio"]
    stats = json.loads(err.strip().splitlines()[-1])
    rows = {r["id"]: r for r in map(json.loads, out.splitlines())}
    if (rc != 0 or stats["scheduler"]["fallbacks"] != 0
            or set(rows) != set(stdio_want)
            or any(verdict_of(rows[i]) != verdict_of(stdio_want[i])
                   for i in rows)):
        raise AssertionError(f"serve --stats over a pipe: exit {rc}, "
                             f"{len(rows)} rows, {err[-1000:]}")
    payload = oneshot(target, {"op": "diff", "content": diff_text,
                               "filename": "LICENSE"}, 60.0)["diff"]
    rendered = io.StringIO()
    with contextlib.redirect_stdout(rendered):
        print(f"Comparing to {payload['spdx_id'] or payload['key']}:")
        _print_table([
            ["Input Length:", payload["input_length"]],
            ["License length:", payload["license_length"]],
            ["Similarity:", format_percent(payload["similarity"])],
        ])
        print("Exact match!" if payload["identical"] else payload["diff"])
    rc, out, err = done["diff"]
    if rc != 0 or out != rendered.getvalue():
        raise AssertionError(f"diff --socket: exit {rc}, {out[-500:]!r} "
                             f"!= {rendered.getvalue()[-500:]!r} {err}")
    log(f"serve children: --selftest, --selftest-reload, a piped --stats "
        f"session ({len(rows)} rows equal to the in-process ones, 0 "
        f"fallbacks) and diff --socket (the verb's payload) all agree")


def reload_under_load(device: str, root: str, bases: list,
                      corpus_608, artifact: str, scale: ServeScale) -> tuple:
    """Reload from the vendored corpus to the T=608 artifact in the
    middle of a 64-client run: no request errors, every row carries the
    old or the new fingerprint and equals the device='cpu' verdict under
    that corpus, the fingerprint flips, the first repeat after the swap
    is not served from the cache, and a corrupt artifact is refused
    while the worker keeps serving.  Returns (stats, launches,
    seconds)."""
    from licensee_tpu_torch.corpus.artifact import (
        corpus_fingerprint,
        short_fingerprint,
    )
    from licensee_tpu_torch.corpus.compiler import default_corpus
    from licensee_tpu_torch.fleet.wire import oneshot
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    reqs = variant_requests(bases, scale.reload_requests, "reload")
    fps = {short_fingerprint(corpus_fingerprint(c)): c
           for c in (default_corpus(), corpus_608)}
    want = {}
    for fp, corpus in fps.items():
        clf = BatchClassifier(corpus=corpus, device="cpu")
        results = clf.classify_blobs([r["content"] for r in reqs],
                                     filenames=["LICENSE"] * len(reqs))
        want[fp] = [(r.key, r.matcher, r.confidence) for r in results]
    corrupt = os.path.join(root, "corrupt.corpus.npz")
    with open(corrupt, "wb") as fh:
        fh.write(b"not a corpus artifact at all")
    seed = {"content": f"{bases[0][1]}\nzqfence\n", "filename": "LICENSE"}
    run = ServeRun("reload", device, corpus_source="vendored")
    fence = {}

    def control(rows: dict) -> None:
        deadline = time.monotonic() + 120
        while len(rows) < len(reqs) // 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        fence["before"] = [oneshot(target, {"id": -1, **seed}, 60.0)
                           for _ in range(2)]
        fence["reload"] = oneshot(target, {"id": -2, "op": "reload",
                                           "corpus": artifact}, 300.0)
        fence["after"] = oneshot(target, {"id": -3, **seed}, 60.0)
        fence["corrupt"] = oneshot(target, {"id": -4, "op": "reload",
                                            "corpus": corrupt}, 300.0)
        fence["still"] = oneshot(target, {"id": -5, **seed}, 60.0)

    with socket_worker(run.batcher, root) as target:
        old = run.batcher.corpus_fingerprint
        rows, took = socket_run(target, reqs, scale.clients, scale.window,
                                control=control)
    new = fence["reload"].get("reload", {}).get("fingerprint")
    problems = []
    if not new or new == old or run.batcher.corpus_fingerprint != new:
        problems.append(f"the fingerprint did not flip: {fence['reload']}")
    if not fence["before"][1]["cached"] or fence["after"]["cached"]:
        problems.append(f"cache fence: {fence['before']} {fence['after']}")
    if (fence["after"]["corpus"] != short_fingerprint(new)
            or fence["before"][0]["corpus"] != short_fingerprint(old)):
        problems.append(f"fence rows' corpora: {fence}")
    if (not fence["corrupt"].get("error", "").startswith("reload_failed")
            or fence["still"].get("corpus") != short_fingerprint(new)
            or fence["still"].get("error")):
        problems.append(f"corrupt artifact: {fence['corrupt']} "
                        f"{fence['still']}")
    seen = {r.get("corpus") for r in rows.values()}
    bad = [i for i, r in rows.items()
           if r.get("error") or r.get("corpus") not in fps
           or (r["key"], r["matcher"], r["confidence"])
           != want[r["corpus"]][i]]
    if bad:
        problems.append(f"{len(bad)} rows wrong or attributed to no known "
                        f"corpus, e.g. {rows[bad[0]]}")
    if seen != set(fps):
        problems.append(f"rows carry the corpora {seen}, want both")
    if problems:
        raise AssertionError(f"serve reload under load: {problems}")
    stats, launches = run.check(epochs=2)
    log(f"serve reload under load: {len(rows)} requests from "
        f"{scale.clients} clients in {took:.3f} s, the fingerprint "
        f"{short_fingerprint(old)} -> {short_fingerprint(new)} "
        f"({fence['reload']['reload']['elapsed_s']} s to build, validate "
        f"and warm the T={corpus_608.n_templates} candidate), "
        f"{sum(r['corpus'] == short_fingerprint(new) for r in rows.values())}"
        f" rows under the new corpus, every row equal to the device='cpu' "
        f"verdict of its corpus; the cache fenced, the corrupt artifact "
        f"refused; launches {json.dumps(launches)}")
    return stats, launches, took


def phase_serve(np, torch, seed: int, device: str = "cuda",
                scale: ServeScale | None = None,
                root: str | None = None) -> dict:
    """Phase 9: `serve` on ``device``.  Returns {"runs": [summaries],
    "launches": {(run, kernel): n}, "refs": {socket run: the reference
    rows by id}}."""
    if root is None:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
            return phase_serve(np, torch, seed, device, scale, tmp)
    from licensee_tpu_torch.corpus.spdx import load_spdx_dir, spdx_corpus
    from licensee_tpu_torch.corpus.spdx_synth import synth_spdx_dir

    scale = scale or ServeScale()
    on_card = device == "cuda"
    t_phase = time.perf_counter()
    report = {"runs": [], "launches": {}}

    def add(run: str, launches: dict) -> None:
        for k, n in launches.items():
            key = (run, k)
            report["launches"][key] = report["launches"].get(key, 0) + n

    # -- inputs --
    mixed = write_mixed_manifest(np, os.path.join(root, "mixed"), seed,
                                 n_repos=scale.mixed_repos)
    vendored = write_manifest(np, os.path.join(root, "vendored"), seed,
                              n_files=scale.vendored_files)
    spdx_dir = synth_spdx_dir(os.path.join(root, "spdx-src"), SPDX_T, seed)
    corpus_608 = spdx_corpus(spdx_dir)
    artifact = os.path.join(root, "spdx608.corpus.npz")
    rc, _out, err, _s = run_verb(["corpus-build", "--corpus", spdx_dir,
                                  "--output", artifact])
    if rc != 0:
        raise RuntimeError(f"corpus-build: {err[-2000:]}")
    bases = vendored_bases()
    bases_608 = [(t.key, t.content) for t in load_spdx_dir(spdx_dir)]
    sessions = {}
    for mode, manifest in (("license", vendored), ("auto", mixed)):
        with open(manifest, encoding="utf-8") as fh:
            sessions[mode] = file_requests(fh.read().splitlines())
    variants = variant_requests(bases, scale.variants, "a")
    variants_608 = variant_requests(bases_608, scale.variants_608, "b")
    single = variant_requests(bases, scale.single, "c")
    single_608 = variant_requests(bases_608, scale.single, "d")
    log(f"serve inputs: sessions of {len(sessions['license'][0])} license "
        f"and {len(sessions['auto'][0])} auto requests, {len(variants)} "
        f"T=47 and {len(variants_608)} T={SPDX_T} variants "
        f"({time.perf_counter() - t_phase:.1f} s)")

    # -- in process: the two sessions, with the children beside the
    # license worker's socket --
    for mode in ("license", "auto"):
        reqs, by_id = sessions[mode]
        run = ServeRun(f"{mode} session", device, mode=mode)
        rows, took = serve_session_rows(run.batcher, reqs)
        if mode == "license":
            # diff a file the session matched by Dice below 100%: the
            # word diff's branch
            near = next(by_id[i] for i, r in rows.items()
                        if r.get("matcher") == "dice"
                        and r["confidence"] < 100)
            with open(near, encoding="utf-8", errors="replace") as fh:
                near_text = fh.read()
            with socket_worker(run.batcher, root) as target:
                serve_children(target, device, reqs[:200],
                               {r["id"]: rows[r["id"]] for r in reqs[:200]},
                               near_text)
        stats, launches = run.check()
        add("serve", launches)
        held_to_reference(f"{mode} session", rows,
                          cpu_rows(reqs, mode=mode))
        held_to_batch_detect(mode, rows, by_id, root, device)
        report["runs"].append({"run": f"{mode} session T=47",
                               **summary(stats, len(reqs), took)})
        log(f"serve {mode} session: {len(reqs)} requests through "
            f"serve_session in {took:.3f} s, rows equal to the "
            f"device='cpu' batcher's and to batch-detect's; launches "
            f"{json.dumps(launches)}")

    # -- over the socket: 64 clients, then one client one request at a
    # time, at T=47 and at T=608, each to the card's batcher and to a
    # device='cpu' one --
    refs = {}
    for label, reqs, clients, window, corpus, run_key in (
            ("T=47 64 clients", variants, scale.clients, scale.window, None,
             "serve"),
            ("T=47 one client", single, 1, 1, None, "serve"),
            (f"T={SPDX_T} 64 clients", variants_608, scale.clients,
             scale.window, corpus_608, "serve608"),
            (f"T={SPDX_T} one client", single_608, 1, 1, corpus_608,
             "serve608")):
        done = {}
        for dev in dict.fromkeys((device, "cpu")):
            run = ServeRun(label, dev, corpus=corpus)
            with socket_worker(run.batcher, root) as target:
                rows, took = client_process(target, reqs, clients, window,
                                            root)
            stats, launches = run.check()
            sched = stats["scheduler"]
            if clients == 1 and (sched["flush"]["deadline"] != sched[
                    "device_batches"] or set(sched["buckets"]) != {"8"}):
                raise AssertionError(f"serve {label} ({dev}): not every "
                                     f"flush a B=1 deadline flush: {sched}")
            done[dev] = (rows, took, stats, launches)
        # the reference: the host batcher's rows over the same socket,
        # or on the CPU an in-process session's
        refs[label] = (done["cpu"][0] if on_card
                       else cpu_rows(reqs, corpus=corpus))
        held_to_reference(label, done[device][0], refs[label])
        rows, took, stats, launches = done[device]
        add(run_key, launches)
        sched = stats["scheduler"]
        if clients > 1 and on_card and str(run.batcher.max_batch) not in \
                sched["buckets"]:
            raise AssertionError(f"serve {label}: no flush reached "
                                 f"{run.batcher.max_batch}: {sched}")
        report["runs"].append({"run": label, **summary(stats, len(reqs),
                                                       took)})
        if device != "cpu":
            report["runs"].append({"run": f"{label}, host batcher",
                                   **summary(done["cpu"][2], len(reqs),
                                             done["cpu"][1])})
        log(f"serve {label}: {len(reqs)} requests in {took:.3f} s "
            f"(a device='cpu' batcher over the socket: "
            f"{done['cpu'][1]:.3f} s), rows equal to the device='cpu' "
            f"batcher's; flush "
            f"{json.dumps(sched['flush'])}, buckets "
            f"{json.dumps(sched['buckets'])}; launches "
            f"{json.dumps(launches)}")

    # -- where the device stage's host time goes: the scheduler and
    # completion threads probed, at the default switch interval and at
    # a tenth of it --
    probed = variants[:scale.profiled]
    probed_want = {r["id"]: refs["T=47 64 clients"][r["id"]] for r in probed}
    default_interval = sys.getswitchinterval()
    for interval in (default_interval, default_interval / 10):
        label = f"T=47 64 clients, switch interval {interval * 1e3:g} ms"
        run = ServeRun(label, device)
        probe = ThreadProbe({"scheduler": run.batcher._thread,
                             "completion": run.batcher._completion})
        sys.setswitchinterval(interval)
        try:
            with socket_worker(run.batcher, root) as target, probe:
                rows, took = client_process(target, probed, scale.clients,
                                            scale.window, root)
        finally:
            sys.setswitchinterval(default_interval)
        stats, launches = run.check()
        add("serve", launches)
        held_to_reference(label, rows, probed_want)
        report["runs"].append({"run": label,
                               **summary(stats, len(probed), took),
                               "threads": probe.report()})

    stats, launches, took = reload_under_load(device, root, bases,
                                              corpus_608, artifact, scale)
    add("serve", launches)
    report["runs"].append({"run": "reload under load",
                           **summary(stats, scale.reload_requests, took)})

    # -- the card's busy share over one 64-client run --
    busy = None
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        reqs = variant_requests(bases, scale.profiled, "p")
        run = ServeRun("profiled", device)
        with socket_worker(run.batcher, root) as target:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                rows, took = client_process(target, reqs, scale.clients,
                                            scale.window, root)
                torch.cuda.synchronize()
        _stats, launches = run.check()
        add("serve", launches)
        busy = (device_busy_seconds(prof), took)

    runs = "; ".join(
        f"{r['run']}: {r['requests']} requests, {r['requests_per_s']:.1f} "
        f"req/s, total p50 {r['total_p50_ms']} p99 {r['total_p99_ms']} ms, "
        f"queue_wait p50 {r['queue_wait_p50_ms']} p99 "
        f"{r['queue_wait_p99_ms']} ms, device p50 {r['device_p50_ms']} p99 "
        f"{r['device_p99_ms']} ms, flush {json.dumps(r['flush'])}, buckets "
        f"{json.dumps(r['buckets'])}"
        + (f", threads {json.dumps(r['threads'])}" if "threads" in r else "")
        for r in report["runs"] if r["run"] != "reload under load")
    share = (f"card busy {busy[0]:.6f} s of the profiled 64-client run's "
             f"{busy[1]:.3f} s: busy share {busy[0] / busy[1]:.6f}"
             if busy and busy[0] > 0 else "card busy share: not measured")
    card = smi("name,power.limit") if on_card else "cpu"
    log(f"serve timing: {card}; {runs}; {share}")
    log(f"serve: phase 9 took {time.perf_counter() - t_phase:.1f} s")
    report["refs"] = refs
    return report


# -- phase 11: the fleet ---------------------------------------------------


@dataclasses.dataclass
class FleetScale:
    """How much traffic phase 11 sends through the fleet: the defaults on
    the card, `tiny` for the test that runs the phase on the CPU."""

    variants: int = 5000        # front, 64 clients, T=47 (phase 9's mix)
    variants_608: int = 2500    # and at T=608 after the roll
    clients: int = 64
    window: int = 8             # requests each client keeps in flight
    edge_clients: int = 16
    edge_requests: int = 4000   # through the edge at T=47; half at T=608
    kill_requests: int = 2000   # the SIGKILL drill
    reload_requests: int = 2000  # the rolling reload
    open_loop_rate: float = 50.0  # each open-loop edge client's requests/s
    open_loop_s: float = 3.0
    selftests: tuple = ("real", "stub")  # `fleet --selftest*` children

    @classmethod
    def tiny(cls) -> "FleetScale":
        return cls(variants=240, variants_608=120, clients=4, window=4,
                   edge_clients=2, edge_requests=60, kill_requests=160,
                   reload_requests=160, open_loop_rate=20.0,
                   open_loop_s=1.0, selftests=())


FLEET_SELFTESTS = {
    "real": ("--selftest", "--selftest-reload", "--selftest-tcp"),
    "stub": ("--selftest --stub", "--selftest-reload --stub",
             "--selftest-tcp --stub"),
}


def fleet_verdict(row: dict) -> dict:
    """A fleet row without what depends on timing or routing: the trace
    ID, the cache flag and the worker that answered."""
    return {k: v for k, v in verdict_of(row).items() if k != "worker"}


def held_to_cpu(what: str, rows: dict, want: dict) -> None:
    bad = [i for i in rows if fleet_verdict(rows[i]) != verdict_of(want[i])]
    errors = [r for r in rows.values() if r.get("error")]
    if bad or errors:
        raise AssertionError(
            f"fleet {what}: {len(bad)} rows differ from the device='cpu' "
            f"batcher's (e.g. {[(rows[i], want[i]) for i in bad[:2]]}), "
            f"{len(errors)} error rows (e.g. {errors[:2]})")


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q`` quantile of ``values``."""
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def launch_counts(exposition: str) -> dict:
    """{(worker label or None, kernel): n} of the exposition's
    ``device_kernel_launches`` samples."""
    out = {}
    for line in exposition.splitlines():
        m = re.match(r"device_kernel_launches\{([^}]*)\} (\S+)$", line)
        if m:
            labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
            out[(labels.get("worker"), labels["kernel"])] = int(
                float(m.group(2)))
    return out


def worker_launches(sock: str) -> dict:
    """{kernel: launches} one worker's registry reports."""
    from licensee_tpu_torch.fleet.wire import oneshot

    text = oneshot(sock, {"op": "stats", "format": "prometheus"},
                   60.0)["prometheus"]
    return {k: n for (_w, k), n in launch_counts(text).items()}


def front_stats(front: str) -> dict:
    from licensee_tpu_torch.fleet.wire import oneshot

    return oneshot(front, {"op": "stats"}, 60.0)["stats"]


def reload_wants(reqs: list, corpora: dict) -> dict:
    """{fingerprint: [(key, matcher, confidence)]} of ``reqs`` under each
    corpus, on the CPU."""
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    want = {}
    for fp, corpus in corpora.items():
        clf = BatchClassifier(corpus=corpus, device="cpu")
        results = clf.classify_blobs([r["content"] for r in reqs],
                                     filenames=["LICENSE"] * len(reqs))
        want[fp] = [(r.key, r.matcher, r.confidence) for r in results]
    return want


class TimedChildren:
    """The port's CLI as child processes started together, each reaped by
    a thread of its own, so that each one's seconds from the start to its
    exit are its own; `finish` checks that each exited 0 and that its
    last JSON line (stdout or stderr) says ``"problems": []``."""

    def __init__(self, runs: list):
        import threading

        self.t0 = time.perf_counter()
        self.procs = {" ".join(argv): cli_process(argv,
                                                  stdout=subprocess.PIPE)
                      for argv in runs}
        self.ended = {}
        self.threads = [threading.Thread(target=self._reap, args=item,
                                         daemon=True)
                        for item in self.procs.items()]
        for t in self.threads:
            t.start()

    def _reap(self, name: str, proc) -> None:
        out, err = proc.communicate(timeout=900)
        self.ended[name] = (proc.returncode, out, err,
                            time.perf_counter() - self.t0)

    def finish(self) -> tuple:
        """({run: seconds from the start to its exit}, {run: its last
        JSON line})."""
        for t in self.threads:
            t.join(timeout=900)
        took, summaries = {}, {}
        for name in self.procs:
            if name not in self.ended:
                raise AssertionError(f"{name} did not end")
            rc, out, err, took[name] = self.ended[name]
            summaries[name] = next((json.loads(line) for line in reversed(
                (out + err).splitlines()) if line.startswith('{"')), {})
            if rc != 0 or summaries[name].get("problems") != []:
                raise AssertionError(f"{name}: exit {rc}: {out[-1500:]} "
                                     f"{err[-3000:]}")
        return took, summaries

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
        for t in self.threads:
            t.join(timeout=30)


def start_fleet_children(scale: FleetScale, device: str) -> TimedChildren:
    """`fleet --selftest*` (real workers on ``device``, and the stub
    twins) and `stats --selftest`, as child processes started together."""
    runs = [["stats", "--selftest"]]
    for kind in scale.selftests:
        for flags in FLEET_SELFTESTS[kind]:
            dev = ["--device", device] if kind == "real" else []
            runs.append(["fleet", *flags.split(), *dev])
    return TimedChildren(runs)


def fleet_verbs(front: str, workers: list) -> dict:
    """`stats --format prometheus`, `traces`, `slo`, `top` (one frame)
    and the per-worker `stats` against the live fleet, as child
    processes started together: each must exit 0, but `slo`, which
    exits 1 while an objective burns: its exit code must be its JSON's
    verdict and the availability objective must hold.  The merged
    exposition must pass `check_exposition`.  Returns {verb: stdout}."""
    from licensee_tpu_torch.obs import check_exposition

    verbs = {
        "stats": ["stats", "--socket", front, "--format", "prometheus"],
        "workers": ["stats", *[a for w in workers for a in ("--socket", w)]],
        "traces": ["traces", "--socket", front, "--slowest", "1"],
        "slo": ["slo", "--socket", front, "--json"],
        "top": ["top", "--socket", front, "--interval", "0"],
    }
    procs = {name: cli_process(argv, stdout=subprocess.PIPE)
             for name, argv in verbs.items()}
    done = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        done[name] = (proc.returncode, out, err)
    problems = []
    for name, (rc, out, err) in done.items():
        if name == "slo":
            slo = json.loads(out)
            if rc != (0 if slo.get("ok") else 1) or not slo[
                    "objectives"]["availability"]["ok"]:
                problems.append(f"slo: exit {rc}, {out[:1500]}")
        elif rc != 0:
            problems.append(f"{name}: exit {rc}, {err[-1500:]}")
    bad = check_exposition(done["stats"][1])
    if bad:
        problems.append(f"the merged exposition: {bad[:3]}")
    if "critical path" not in done["traces"][1]:
        problems.append(f"traces: {done['traces'][1][:500]!r}")
    if "WORKER" not in done["top"][1]:
        problems.append(f"top: {done['top'][1][:500]!r}")
    if problems:
        raise AssertionError(f"fleet verbs: {problems}")
    return {name: out for name, (_rc, out, _err) in done.items()}


def await_quiet_alerts(front: str, bound_s: float = 90.0) -> float:
    """Wait (at most ``bound_s``) until the watchdog has no active alert,
    then run `alerts`, which must exit 0.  Returns the seconds waited."""
    t0 = time.perf_counter()
    while front_stats(front)["alerts"]["active"]:
        if time.perf_counter() - t0 > bound_s:
            break
        time.sleep(1.0)
    waited = time.perf_counter() - t0
    proc = cli_process(["alerts", "--socket", front, "--history", "20"],
                       stdout=subprocess.PIPE)
    out, err = proc.communicate(timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"alerts: exit {proc.returncode} after "
                             f"{waited:.1f} s of quiet: {out} {err}")
    log(f"fleet alerts: none active after {waited:.1f} s without traffic; "
        f"{out.strip().splitlines()[-1]}")
    return waited


def fleet_kill_drill(front: str, reqs: list, want: dict, scale: FleetScale,
               on_card: bool, victims: dict) -> dict:
    """SIGKILL worker w0 a quarter into a front run: zero client errors,
    the rows equal the CPU batcher's, the supervisor counts one restart
    (a SIGKILL, its flight recorder harvested) and the respawned worker
    answers again, on the card its launch gauge above 0.  ``victims``
    gets the killed process's launch counts, read just before the kill.
    Returns the drill's numbers."""
    import signal

    drill = {}

    def control(rows: dict) -> None:
        deadline = time.monotonic() + 300
        while len(rows) < len(reqs) // 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        backend = front_stats(front)["backends"]["w0"]
        victims.update(worker_launches(backend["socket"]))
        pid = backend["supervisor"]["pid"]
        os.kill(pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        while time.perf_counter() - t_kill < 300:
            stats = front_stats(front)
            sup = stats["backends"]["w0"]["supervisor"]
            if sup["state"] == "healthy" and sup["pid"] not in (None, pid):
                drill["respawn_s"] = time.perf_counter() - t_kill
                drill["restarts"] = stats["host"]["restarts"]
                drill["log"] = sup["restart_log"][-1]
                drill["during"] = len(rows)
                return
            time.sleep(0.05)
        raise AssertionError(f"w0 never came back: {sup}")

    rows, took, lats = client_run(front, reqs, scale.clients, scale.window,
                                  control=control, timeout=600.0)
    held_to_cpu("kill drill", rows, want)
    log_entry = drill["log"]
    if (drill["restarts"] != 1 or log_entry.get("signal") != 9
            or log_entry.get("reason") != "crash"):
        raise AssertionError(f"fleet kill drill: restarts "
                             f"{drill['restarts']}, {log_entry}")
    sock = front_stats(front)["backends"]["w0"]["socket"]
    again = worker_launches(sock)
    if on_card and not again.get("best_match_fused"):
        raise AssertionError(f"the respawned w0 launched no K1: {again}")
    return {**drill, "requests": len(reqs), "seconds": took,
            "p50_ms": percentile(lats, 0.5), "p99_ms": percentile(lats, 0.99),
            "flight_harvested": log_entry.get("flight_harvested")}


def rolling_reload(front: str, reqs: list, want: dict, artifact: str,
                   scale: FleetScale) -> dict:
    """`{"op": "reload"}` on the front door to a `corpus-build` artifact
    a quarter into a front run: the roll succeeds, both workers report
    its fingerprint, no row is an error and each row names the old or
    the new corpus and equals the CPU verdict under it."""
    from licensee_tpu_torch.corpus.artifact import short_fingerprint
    from licensee_tpu_torch.fleet.wire import oneshot

    roll = {}

    def control(rows: dict) -> None:
        deadline = time.monotonic() + 300
        while len(rows) < len(reqs) // 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        t0 = time.perf_counter()
        roll["reply"] = oneshot(front, {"id": -1, "op": "reload",
                                        "corpus": artifact}, 600.0)
        roll["seconds"] = time.perf_counter() - t0

    before = {name: b["socket"] for name, b in
              front_stats(front)["backends"].items()}
    rows, took, lats = client_run(front, reqs, scale.clients, scale.window,
                                  control=control, timeout=600.0)
    reply = roll["reply"].get("reload") or {}
    fps = {name: oneshot(sock, {"op": "stats"}, 60.0)["stats"]["corpus"][
        "fingerprint"] for name, sock in before.items()}
    problems = []
    if not reply.get("ok") or set(fps.values()) != {reply["fingerprint"]}:
        problems.append(f"the roll: {roll['reply']}, workers {fps}")
    bad = [i for i, r in rows.items()
           if r.get("error") or r.get("corpus") not in want
           or (r["key"], r["matcher"], r["confidence"])
           != want[r["corpus"]][i]]
    if bad:
        problems.append(f"{len(bad)} rows wrong or of no known corpus, "
                        f"e.g. {rows[bad[0]]}")
    if problems:
        raise AssertionError(f"fleet rolling reload: {problems}")
    new = short_fingerprint(reply["fingerprint"])
    return {"requests": len(reqs), "seconds": took,
            "roll_s": roll["seconds"], "fingerprint": new,
            "p50_ms": percentile(lats, 0.5), "p99_ms": percentile(lats, 0.99),
            "rows_new": sum(r["corpus"] == new for r in rows.values())}


def open_loop_edge(edge: str, scale: FleetScale) -> dict:
    """``edge_clients`` open-loop keep-alive clients through the edge
    (`fleet/faults.py:open_loop_http_client`), in threads: no stalled
    client and no answer but 200."""
    import threading

    from licensee_tpu_torch.fleet import faults

    results = [None] * scale.edge_clients

    def one(k: int) -> None:
        results[k] = faults.open_loop_http_client(
            edge, scale.open_loop_rate, scale.open_loop_s, timeout_s=60.0)

    threads = [threading.Thread(target=one, args=(k,), daemon=True)
               for k in range(scale.edge_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=scale.open_loop_s + 120)
    if any(r is None or r["stalled"] or r["non_200"] for r in results):
        brief = [{k: v for k, v in (r or {}).items() if k != "lats_ms"}
                 for r in results]
        raise AssertionError(f"open-loop edge clients: {brief}")
    lats = [x for r in results for x in r["lats_ms"]]
    sent = sum(r["sent"] for r in results)
    return {"requests": sent, "offered_per_s": sent / max(
        r["send_elapsed_s"] for r in results),
        "p50_ms": percentile(lats, 0.5), "p99_ms": percentile(lats, 0.99)}


def phase_fleet(np, torch, seed: int, device: str = "cuda",
                scale: FleetScale | None = None, root: str | None = None,
                refs: dict | None = None) -> dict:
    """Phase 11: `fleet --workers 2 --socket FRONT --http HOST:PORT` on
    ``device`` (the module's docstring lists its runs).  ``refs`` are
    phase 9's reference rows of the same requests, by run label, where
    they exist.  Returns {"launches": {(run, kernel): n}, "timing":
    {...}}."""
    if root is None:
        with tempfile.TemporaryDirectory(prefix="cs_fleet_") as tmp:
            return phase_fleet(np, torch, seed, device, scale, tmp, refs)
    from licensee_tpu_torch.corpus.artifact import (
        corpus_fingerprint,
        short_fingerprint,
    )
    from licensee_tpu_torch.corpus.compiler import default_corpus
    from licensee_tpu_torch.corpus.spdx import load_spdx_dir, spdx_corpus
    from licensee_tpu_torch.corpus.spdx_synth import synth_spdx_dir
    from licensee_tpu_torch.fleet.selftest import _free_port
    from licensee_tpu_torch.fleet.wire import oneshot

    scale = scale or FleetScale()
    refs = refs or {}
    on_card = device == "cuda"
    t_phase = time.perf_counter()
    card = smi("name,power.limit") if on_card else "cpu"

    # -- inputs: phase 9's request mix, the T=608 directory's artifact --
    spdx_dir = synth_spdx_dir(os.path.join(root, "spdx-src"), SPDX_T, seed)
    corpus_608 = spdx_corpus(spdx_dir)
    artifact = os.path.join(root, "spdx608.corpus.npz")
    rc, _out, err, _s = run_verb(["corpus-build", "--corpus", spdx_dir,
                                  "--output", artifact])
    if rc != 0:
        raise RuntimeError(f"corpus-build: {err[-2000:]}")
    bases = vendored_bases()
    bases_608 = [(t.key, t.content) for t in load_spdx_dir(spdx_dir)]
    variants = variant_requests(bases, scale.variants, "a")
    variants_608 = variant_requests(bases_608, scale.variants_608, "b")
    drill_reqs = variant_requests(bases, scale.kill_requests, "k")
    roll_reqs = variant_requests(bases, scale.reload_requests, "r")
    want = refs.get("T=47 64 clients")
    if want is None or len(want) != len(variants):
        want = cpu_rows(variants)
    want_608 = refs.get(f"T={SPDX_T} 64 clients")
    if want_608 is None or len(want_608) != len(variants_608):
        want_608 = cpu_rows(variants_608, corpus=corpus_608)
    want_drill = cpu_rows(drill_reqs)
    want_roll = reload_wants(roll_reqs, {
        short_fingerprint(corpus_fingerprint(c)): c
        for c in (default_corpus(), corpus_608)})
    edge_47 = variants[:scale.edge_requests]
    edge_608 = variants_608[:scale.edge_requests // 2]
    log(f"fleet inputs: {len(variants)} T=47 and {len(variants_608)} "
        f"T={SPDX_T} variants, {len(drill_reqs)} for the kill drill, "
        f"{len(roll_reqs)} for the roll, references ready "
        f"({time.perf_counter() - t_phase:.1f} s)")

    # -- boot --
    sock_dir = os.path.join(root, "w")
    front = os.path.join(root, "front.sock")
    edge = f"127.0.0.1:{_free_port()}"
    fleet_log = open(os.path.join(root, "fleet.log"), "w+")
    t0 = time.perf_counter()
    fleet = subprocess.Popen(
        [sys.executable, "-m", "licensee_tpu_torch.cli.main", "fleet",
         "--workers", "2", "--socket", front, "--socket-dir", sock_dir,
         # the edge's clients share one address, so one token bucket:
         # a rate above the run's keeps 429s out of the measurement
         "--http", edge, "--edge-rate", "1000000", "--device", device],
        stdout=subprocess.DEVNULL, stderr=fleet_log,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    timing = {"card": card}
    launches = {}
    try:
        while not os.path.exists(front):
            if fleet.poll() is not None or time.perf_counter() - t0 > 600:
                fleet_log.seek(0)
                raise AssertionError(f"the fleet did not boot: exit "
                                     f"{fleet.poll()}: {fleet_log.read()}")
            time.sleep(0.05)
        timing["boot_s"] = time.perf_counter() - t0
        workers = {name: b["socket"] for name, b in
                   front_stats(front)["backends"].items()}

        # -- traffic at T=47: the front, then the edge --
        util = UtilSampler() if on_card else contextlib.nullcontext()
        with util:
            rows, took, lats = client_run(front, variants, scale.clients,
                                          scale.window, timeout=600.0)
        held_to_cpu("front T=47", rows, want)
        runs = [("front T=47", len(variants), took, lats)]
        rows, took, lats = client_run(edge, edge_47, scale.edge_clients,
                                      scale.window, timeout=600.0, http=True)
        held_to_cpu("edge T=47", rows, want)
        runs.append(("edge T=47", len(edge_47), took, lats))
        timing["utilization"] = util.describe() if on_card else "not measured"

        # -- a worker SIGKILLed mid-run --
        victim = {}
        timing["kill"] = fleet_kill_drill(front, drill_reqs, want_drill,
                                          scale, on_card, victim)
        pre_roll = {w: worker_launches(s) for w, s in workers.items()}

        # -- a rolling reload to the T=608 artifact under load --
        timing["roll"] = rolling_reload(front, roll_reqs, want_roll,
                                        artifact, scale)

        # -- traffic at T=608: the front, the edge, the open-loop edge --
        rows, took, lats = client_run(front, variants_608, scale.clients,
                                      scale.window, timeout=600.0)
        held_to_cpu(f"front T={SPDX_T}", rows, want_608)
        runs.append((f"front T={SPDX_T}", len(variants_608), took, lats))
        rows, took, lats = client_run(edge, edge_608, scale.edge_clients,
                                      scale.window, timeout=600.0, http=True)
        held_to_cpu(f"edge T={SPDX_T}", rows, want_608)
        runs.append((f"edge T={SPDX_T}", len(edge_608), took, lats))
        timing["open_loop"] = open_loop_edge(edge, scale)
        timing["runs"] = [
            {"run": run, "requests": n, "seconds": took,
             "requests_per_s": n / took, "p50_ms": percentile(lats, 0.5),
             "p99_ms": percentile(lats, 0.99)}
            for run, n, took, lats in runs]

        if on_card:
            # the two workers' processes on the card, before the
            # children add their own
            timing["memory"] = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=used_memory",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip().replace("\n", "; ")
        else:
            timing["memory"] = "not measured"

        # -- the children (selftests) beside the verbs and the quiet --
        children = start_fleet_children(scale, device)
        verbs = fleet_verbs(front, list(workers.values()))
        slo = json.loads(verbs["slo"])
        timing["slo"] = {"ok": slo["ok"], **{
            name: obj["max_burn"]
            for name, obj in sorted(slo["objectives"].items())}}
        per_worker = launch_counts(verbs["stats"])
        end = {w: {k: n for (wl, k), n in per_worker.items() if wl == w}
               for w in workers}
        stats = {}

        for w, sock in workers.items():
            st = oneshot(sock, {"op": "stats"}, 60.0)["stats"]
            stats[w] = st
            sched = st["scheduler"]
            if sched["fallbacks"] or sched["completion_errors"]:
                raise AssertionError(f"fleet {w}: fallbacks "
                                     f"{sched['fallbacks']}, completion "
                                     f"errors {sched['completion_errors']}")
            others = {k: n for k, n in end[w].items()
                      if n and k != "best_match_fused"}
            if others or (on_card and not end[w].get("best_match_fused")):
                raise AssertionError(f"fleet {w}: launches {end[w]}")
        timing["workers"] = {
            w: {"flushes": stats[w]["scheduler"]["device_batches"],
                "k1_launches": end[w].get("best_match_fused", 0),
                "corpus": stats[w]["corpus"]["fingerprint"][:12]}
            for w in workers}
        timing["victim_k1_launches"] = victim.get("best_match_fused", 0)
        timing["quiet_s"] = await_quiet_alerts(front)
        timing["children"], _summaries = children.finish()
        log(f"fleet children: {', '.join(children.procs)} passed "
            f"({max(timing['children'].values(), default=0):.1f} s after "
            "their start)")
        # the T=47 share: the victim before its death and every worker
        # before the roll; the rest (the roll's validation and warm-up,
        # T=608 traffic) at T=608
        k1_47 = victim.get("best_match_fused", 0) + sum(
            c.get("best_match_fused", 0) for c in pre_roll.values())
        k1_all = victim.get("best_match_fused", 0) + sum(
            c.get("best_match_fused", 0) for c in end.values())
        launches[("serve", "best_match_fused")] = k1_47
        launches[("serve608", "best_match_fused")] = k1_all - k1_47
    finally:
        if fleet.poll() is None:
            fleet.terminate()
            try:
                fleet.wait(timeout=120)
            except subprocess.TimeoutExpired:
                fleet.kill()
                fleet.wait()
        fleet_log.close()
    if fleet.returncode != 0 or os.path.exists(front):
        raise AssertionError(f"the fleet's stop: exit {fleet.returncode}, "
                             f"front socket left: {os.path.exists(front)}")
    timing["launches"] = {"T=47": launches[("serve", "best_match_fused")],
                          f"T={SPDX_T}": launches[("serve608",
                                                   "best_match_fused")]}
    runs = "; ".join(
        f"{r['run']}: {r['requests']} requests, {r['requests_per_s']:.1f} "
        f"req/s, total p50 {r['p50_ms']:.3f} p99 {r['p99_ms']:.3f} ms"
        for r in timing["runs"])
    ol, kill, roll = timing["open_loop"], timing["kill"], timing["roll"]
    log(f"fleet timing: {card}; {runs}; open-loop edge "
        f"({scale.edge_clients} clients): {ol['requests']} requests at "
        f"{ol['offered_per_s']:.1f} offered req/s, p50 {ol['p50_ms']:.3f} "
        f"p99 {ol['p99_ms']:.3f} ms; workers "
        + ", ".join(f"{w}: {v['flushes']} flushes, {v['k1_launches']} K1 "
                    f"launches" for w, v in timing["workers"].items())
        + f" (the killed w0: {timing['victim_k1_launches']} K1 launches); "
        f"K1 launches T=47 {timing['launches']['T=47']} / T={SPDX_T} "
        f"{timing['launches'][f'T={SPDX_T}']}; restarts {kill['restarts']}; "
        f"boot {timing['boot_s']:.3f} s (two workers), respawn "
        f"{kill['respawn_s']:.3f} s after the SIGKILL; kill drill "
        f"{kill['requests']} requests, 0 errors, p99 {kill['p99_ms']:.3f} "
        f"ms; roll {roll['roll_s']:.3f} s to {roll['fingerprint']} under "
        f"{roll['requests']} requests ({roll['rows_new']} under the new "
        f"corpus), p99 {roll['p99_ms']:.3f} ms; {timing['utilization']}; "
        f"per-process memory {timing['memory']}; slo "
        f"{json.dumps(timing['slo'])} (max burn by objective); alerts "
        f"quiet after {timing['quiet_s']:.1f} s")
    log(f"fleet: phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "timing": timing}


# -- phase 12: tenancy and jobs ------------------------------------------------------


@dataclasses.dataclass
class TenancyScale:
    """How much phase 12 sends: the defaults on the card, `tiny` for a
    rehearsal on the CPU."""

    classify: int = 2000        # tagged classifies a tenant (phase 9's mix)
    clients: int = 8            # edge clients a tenant
    window: int = 8             # requests each client keeps in flight
    roll_requests: int = 1000   # beta's during acme's roll, acme's after
    container_repos: int = 2400  # job (a)'s repositories without phase 7's
    selftests: tuple = ("real", "stub")  # `fleet --selftest-*` children

    @classmethod
    def tiny(cls) -> "TenancyScale":
        return cls(classify=60, clients=2, window=4, roll_requests=40,
                   container_repos=30, selftests=())


TENANCY_SELFTESTS = {
    "real": ("--selftest-tenant", "--selftest-jobs"),
    "stub": ("--selftest-tenant --stub", "--selftest-jobs --stub"),
}
TENANT_TOKENS = {"acme": "tok-acme", "beta": "tok-beta"}
TERMINAL = ("completed", "failed", "cancelled")


def edge_post(edge: str, path: str, token: str, payload: dict,
              timeout: float = 600.0) -> tuple:
    """(status, parsed body) of one ``POST path`` to the edge."""
    body = json.dumps(payload).encode()
    with connect(edge, timeout) as sock, sock.makefile("rwb") as fh:
        fh.write((f"POST {path} HTTP/1.1\r\nHost: edge\r\n"
                  f"Authorization: Bearer {token}\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        fh.flush()
        code, raw = read_http(fh)
    return code, json.loads(raw)


def tenant_run(edge: str, tenant: str, reqs: list, want: dict, fp: str,
               scale: TenancyScale, control=None) -> dict:
    """``reqs`` tagged with ``tenant`` under its token through the edge:
    every row equals the CPU reference ``want``, comes from a worker of
    the tenant's pool and stamps the pool's short fingerprint ``fp``.
    Returns the run's numbers."""
    tagged = [{**r, "corpus": tenant} for r in reqs]
    rows, took, lats = client_run(edge, tagged, scale.clients, scale.window,
                                  control=control, timeout=600.0, http=True,
                                  token=TENANT_TOKENS[tenant])
    crossed = [r for r in rows.values()
               if not str(r.get("worker", "")).startswith(tenant)
               or r.get("corpus") != fp]
    if crossed:
        raise AssertionError(f"tenancy {tenant}: {len(crossed)} rows from "
                             f"another pool or corpus than {fp}, e.g. "
                             f"{crossed[:2]}")
    held_to_cpu(f"tenancy {tenant}", rows, want)
    return {"requests": len(reqs), "seconds": took,
            "requests_per_s": len(reqs) / took,
            "p50_ms": percentile(lats, 0.5), "p99_ms": percentile(lats, 0.99)}


def job_launches(prom: str) -> dict:
    """{kernel: launches} summed over a job's merged stripe exposition."""
    out = {}
    with open(prom, encoding="utf-8") as fh:
        for line in fh:
            m = re.match(r'device_kernel_launches\{[^}]*kernel="([^"]+)"'
                         r'[^}]*\} (\S+)$', line.strip())
            if m:
                out[m.group(1)] = out.get(m.group(1), 0) + int(
                    float(m.group(2)))
    return out


def read_or_none(path: str) -> bytes | None:
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except FileNotFoundError:
        return None


def phase_tenancy(np, torch, seed: int, device: str = "cuda",
                  scale: TenancyScale | None = None, root: str | None = None,
                  inputs: dict | None = None, refs: dict | None = None
                  ) -> dict:
    """Phase 12: the tenancy and jobs tiers on ``device`` (the module's
    docstring lists its runs).  ``inputs`` are phase 10's (phase 5's T=608
    manifest and directory, phase 7's containers), ``refs`` phase 9's
    reference rows by run label; what is missing is made here.  Returns
    {"launches": {(run, kernel): n}, "timing": {...}}."""
    if root is None:
        with tempfile.TemporaryDirectory(prefix="cs_tenancy_") as tmp:
            return phase_tenancy(np, torch, seed, device, scale, tmp,
                                 inputs, refs)
    from licensee_tpu_torch.corpus.artifact import (
        corpus_fingerprint,
        short_fingerprint,
    )
    from licensee_tpu_torch.corpus.compiler import default_corpus
    from licensee_tpu_torch.corpus.spdx import load_spdx_dir, spdx_corpus
    from licensee_tpu_torch.corpus.spdx_synth import synth_spdx_dir
    from licensee_tpu_torch.fleet.wire import oneshot
    from licensee_tpu_torch.jobs.client import JobsClient
    from licensee_tpu_torch.jobs.executor import JobExecutor, validate_spec

    scale = scale or TenancyScale()
    inputs = inputs or {}
    refs = refs or {}
    on_card = device == "cuda"
    t_phase = time.perf_counter()
    card = smi("name,power.limit") if on_card else "cpu"
    # the selftests run beside everything else the phase does, and so
    # does the native featurizer's parity selftest (host-only: it opens
    # no device), whose SKIP (no native library) is a failure here
    children = TimedChildren([["fleet", *flags.split(), "--device", device]
                              for kind in scale.selftests
                              for flags in TENANCY_SELFTESTS[kind]])
    repo = os.path.dirname(os.path.abspath(__file__))
    native = subprocess.Popen(
        [sys.executable, "-m", "licensee_tpu_torch.native.selftest"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=repo, env={**os.environ, "PYTHONPATH": repo})

    # -- inputs: the tenants' corpora and requests, the jobs' manifests --
    spdx_dir = inputs.get("spdx_dir") or synth_spdx_dir(
        os.path.join(root, "spdx-src"), SPDX_T, seed)
    spdx = inputs.get("spdx") or write_spdx_manifest(
        np, os.path.join(root, "spdx"), spdx_dir, seed)
    cont = inputs.get("containers") or {}
    containers_manifest = cont.get("manifest") or write_container_manifest(
        np, os.path.join(root, "containers"), seed,
        scale.container_repos)[0]
    corpus_608, roll_corpus = spdx_corpus(spdx_dir), spdx_corpus(None)
    fps = {name: short_fingerprint(corpus_fingerprint(c)) for name, c in (
        ("acme", default_corpus()), ("beta", corpus_608),
        ("roll", roll_corpus))}
    artifact = os.path.join(root, "acme.corpus.npz")
    rc, _out, err, _s = run_verb(["corpus-build", "--corpus", "spdx",
                                  "--output", artifact])
    if rc != 0:
        raise RuntimeError(f"corpus-build: {err[-2000:]}")
    bases = vendored_bases()
    bases_608 = [(t.key, t.content) for t in load_spdx_dir(spdx_dir)]
    acme_reqs = variant_requests(bases, scale.classify, "a")
    beta_reqs = variant_requests(bases_608, scale.classify, "b")
    beta_roll = variant_requests(bases_608, scale.roll_requests, "u")
    acme_after = variant_requests(bases, scale.roll_requests, "t")
    want_acme = refs.get("T=47 64 clients")
    if want_acme is None or len(want_acme) < len(acme_reqs):
        want_acme = cpu_rows(acme_reqs)
    want_beta = refs.get(f"T={SPDX_T} 64 clients")
    if want_beta is None or len(want_beta) < len(beta_reqs):
        want_beta = cpu_rows(beta_reqs, corpus=corpus_608)
    want_beta_roll = cpu_rows(beta_roll, corpus=corpus_608)
    want_after = cpu_rows(acme_after, corpus=roll_corpus)
    registry = os.path.join(root, "tenants.json")
    with open(registry, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "default_pool": "acme", "tenants": {
            "acme": {"token": TENANT_TOKENS["acme"], "corpus": "vendored"},
            "beta": {"token": TENANT_TOKENS["beta"], "corpus": spdx_dir},
        }}, fh)
    log(f"tenancy inputs: fingerprints {fps}, {len(acme_reqs)} + "
        f"{len(beta_reqs)} tagged requests, references ready "
        f"({time.perf_counter() - t_phase:.1f} s)")

    # -- boot: one worker a pool, the edge, the jobs tier --
    sock_dir = os.path.join(root, "w")
    jobs_dir = os.path.join(root, "jobs")
    front = os.path.join(root, "front.sock")
    fleet_log = open(os.path.join(root, "fleet.log"), "w+")
    t0 = time.perf_counter()
    # the edge binds a port the system picks (the selftests beside it
    # bind ports of their own all the while) and the fleet names it
    fleet = subprocess.Popen(
        [sys.executable, "-m", "licensee_tpu_torch.cli.main", "fleet",
         "--tenants", registry, "--workers", "1", "--socket", front,
         "--socket-dir", sock_dir, "--http", "127.0.0.1:0",
         "--jobs-dir", jobs_dir,
         "--jobs-concurrency", "2", "--edge-rate", "1000000",
         "--device", device],
        stdout=subprocess.DEVNULL, stderr=fleet_log,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    timing = {"card": card}
    launches = {}
    cpu_jobs = JobExecutor(os.path.join(root, "cpu-jobs"), device="cpu",
                           max_concurrent=2)
    try:
        edge = None
        while edge is None:
            fleet_log.seek(0)
            said = fleet_log.read()
            m = re.search(r"HTTP edge on \S+ \(port (\d+)\)", said)
            if m:
                edge = f"127.0.0.1:{m.group(1)}"
            elif fleet.poll() is not None or time.perf_counter() - t0 > 600:
                raise AssertionError(f"the tenant fleet did not boot: exit "
                                     f"{fleet.poll()}: {said}")
            else:
                time.sleep(0.05)
        timing["boot_s"] = time.perf_counter() - t0
        workers = {name: b["socket"] for name, b in
                   front_stats(front)["backends"].items()}
        if sorted(workers) != ["acme0", "beta0"]:
            raise AssertionError(f"tenant fleet workers: {workers}")

        # -- tagged classifies under each token --
        timing["runs"] = {
            "acme T=47": tenant_run(edge, "acme", acme_reqs, want_acme,
                                    fps["acme"], scale),
            f"beta T={SPDX_T}": tenant_run(edge, "beta", beta_reqs,
                                           want_beta, fps["beta"], scale),
        }

        # -- acme's POST /corpus under beta's traffic, then acme's rows --
        with open(artifact, "rb") as fh:
            upload = {"artifact_b64": base64.b64encode(fh.read()).decode(),
                      "name": "acme.corpus.npz"}
        roll = {}

        def control(rows: dict) -> None:
            deadline = time.monotonic() + 300
            while len(rows) < len(beta_roll) // 4 and \
                    time.monotonic() < deadline:
                time.sleep(0.005)
            t_roll = time.perf_counter()
            roll["code"], roll["body"] = edge_post(
                edge, "/corpus", TENANT_TOKENS["acme"], upload)
            roll["seconds"] = time.perf_counter() - t_roll

        timing["runs"][f"beta T={SPDX_T} during the roll"] = tenant_run(
            edge, "beta", beta_roll, want_beta_roll, fps["beta"], scale,
            control=control)
        rolled = roll["body"].get("corpus") or {}
        if roll["code"] != 200 or rolled.get("pool") != "acme" or \
                short_fingerprint(rolled.get("fingerprint")) != fps["roll"]:
            raise AssertionError(f"acme's POST /corpus: {roll}")
        timing["roll_s"] = roll["seconds"]
        timing["runs"]["acme after the roll"] = tenant_run(
            edge, "acme", acme_after, want_after, fps["roll"], scale)
        with open(registry, encoding="utf-8") as fh:
            saved = json.load(fh)["tenants"]
        if saved["acme"]["corpus"] != rolled["corpus"] or \
                saved["beta"]["corpus"] != spdx_dir:
            raise AssertionError(f"the registry after the roll: {saved}")
        log(f"tenancy: acme rolled to {fps['roll']} in "
            f"{roll['seconds']:.3f} s under beta's traffic; the registry "
            "names the staged artifact")

        # -- two jobs through the `jobs` verb, each beside the same spec
        #    on a device='cpu' executor --
        specs = {
            "a": (containers_manifest, ["--stripes", "2"],
                  {"stripes": 2}),
            "b": (spdx, ["--option", f"corpus={spdx_dir}", "--option",
                         "method=matmul"],
                  {"options": {"corpus": spdx_dir, "method": "matmul"}}),
        }
        cpu_jobs.start()
        jobs, cpu_ids = {}, {}
        for name, (manifest, flags, extra) in specs.items():
            with open(manifest, encoding="utf-8") as fh:
                entries = [line.strip() for line in fh if line.strip()]
            spec, reason = validate_spec({"manifest": entries, **extra})
            if reason is not None:
                raise AssertionError(f"job ({name}): {reason}")
            cpu_ids[name] = cpu_jobs.submit(spec)[0].job_id
            t_submit = time.perf_counter()
            rc, out, err, _s = run_verb([
                "jobs", "submit", "--edge", edge, "--token",
                TENANT_TOKENS["acme"], "--manifest", manifest, *flags])
            if rc != 0:
                raise AssertionError(f"jobs submit ({name}): {err[-2000:]}")
            jobs[name] = (json.loads(out)["job_id"], t_submit)
        client = JobsClient(edge, token=TENANT_TOKENS["acme"])
        done = {}
        try:
            deadline = time.monotonic() + 900
            while len(done) < len(jobs):
                if time.monotonic() > deadline:
                    raise AssertionError(f"jobs not done: {done}")
                for name, (job_id, _t) in jobs.items():
                    if name not in done:
                        code, row = client.status(job_id)
                        if row.get("state") in TERMINAL:
                            done[name] = (row, time.perf_counter())
                time.sleep(0.05)
        finally:
            client.close()
        for name, cpu_id in cpu_ids.items():
            while cpu_jobs.status(cpu_id)["state"] not in TERMINAL:
                time.sleep(0.05)
        timing["jobs"] = {}
        for name, (job_id, t_submit) in jobs.items():
            row, t_done = done[name]
            rc, out, err, _s = run_verb(["jobs", "wait", job_id, "--edge",
                                         edge, "--token",
                                         TENANT_TOKENS["acme"]])
            if rc != 0 or json.loads(out)["state"] != "completed":
                raise AssertionError(f"job ({name}): {row}: {err[-2000:]}")
            got = {}
            for what in ("results", "containers"):
                out_path = os.path.join(root, f"job-{name}.{what}")
                rc, _out, err, _s = run_verb([
                    "jobs", what, job_id, "--edge", edge, "--token",
                    TENANT_TOKENS["acme"], "--output", out_path])
                if rc != 0:
                    raise AssertionError(f"jobs {what} ({name}): {err}")
                got[what] = read_or_none(out_path)
            cpu_out = cpu_jobs.results_path(cpu_ids[name])
            want = {"results": read_or_none(cpu_out or ""),
                    "containers": read_or_none(f"{cpu_out}.containers.jsonl")
                    or b""}
            if cpu_out is None or got != want:
                raise AssertionError(
                    f"job ({name}): results {len(got['results'])} bytes, "
                    f"containers {len(got['containers'] or b'')} bytes, "
                    f"differ from the device='cpu' executor's "
                    f"({cpu_jobs.status(cpu_ids[name])})")
            modes = cont.get("modes") or {}
            if name == "a" and "license" in modes and (
                    modes["license"][1], modes["license"][2]) != (
                    got["results"], got["containers"]):
                raise AssertionError("job (a): its rows differ from phase "
                                     "7's --mode license run")
            kernels = job_launches(os.path.join(
                jobs_dir, job_id, "results.jsonl.prom"))
            kernel = "best_match_fused" if name == "a" else \
                "overlap_pairs_mma"
            others = {k: n for k, n in kernels.items() if n and k != kernel}
            if others or (on_card and not kernels.get(kernel)):
                raise AssertionError(f"job ({name}): stripe launches "
                                     f"{kernels}")
            launches[("vendored" if name == "a" else "spdx", kernel)] = \
                kernels.get(kernel, 0)
            kernels = {k: n for k, n in kernels.items() if n}
            rows = row["rows_written"]
            timing["jobs"][name] = {
                "rows": rows, "seconds": t_done - t_submit,
                "rows_per_s": rows / (t_done - t_submit),
                "runner_s": row["elapsed_s"], "stripes": row["stripes"],
                "launches": kernels}
        log("tenancy jobs: (a) and (b) byte-identical to the device='cpu' "
            "executor's" + (", (a) also to phase 7's --mode license run"
                            if "license" in (cont.get("modes") or {})
                            else ""))

        # -- the pools' workers: no fallback, K1 and nothing else --
        for w, sock in workers.items():
            st = oneshot(sock, {"op": "stats"}, 60.0)["stats"]
            sched = st["scheduler"]
            got = worker_launches(sock)
            others = {k: n for k, n in got.items()
                      if n and k != "best_match_fused"}
            if sched["fallbacks"] or sched["completion_errors"] or others \
                    or (on_card and not got.get("best_match_fused")):
                raise AssertionError(f"tenancy {w}: fallbacks "
                                     f"{sched['fallbacks']}, launches {got}")
            run = "serve" if w == "acme0" else "serve608"
            launches[(run, "best_match_fused")] = got.get(
                "best_match_fused", 0)
        timing["worker_launches"] = {
            "acme0": launches[("serve", "best_match_fused")],
            "beta0": launches[("serve608", "best_match_fused")]}
        timing["children"], summaries = children.finish()
        out, err = native.communicate(timeout=600)
        if native.returncode != 0 or "parity OK" not in out:
            raise AssertionError(f"native selftest: exit "
                                 f"{native.returncode}: {out} {err[-2000:]}")
        timing["native"] = out.strip().replace("\n", "; ")
        timing["resume_s"] = next(
            (s.get("resume_s") for name, s in summaries.items()
             if "--selftest-jobs" in name and "--stub" not in name), None)
    finally:
        cpu_jobs.close()
        children.stop()
        if native.poll() is None:
            native.kill()
            native.communicate()
        if fleet.poll() is None:
            fleet.terminate()
            try:
                fleet.wait(timeout=120)
            except subprocess.TimeoutExpired:
                fleet.kill()
                fleet.wait()
        fleet_log.close()
    if fleet.returncode != 0 or os.path.exists(front):
        raise AssertionError(f"the tenant fleet's stop: exit "
                             f"{fleet.returncode}, front socket left: "
                             f"{os.path.exists(front)}")

    def fmt(x):
        return "not measured" if x is None else f"{x:.3f} s"

    log(f"jobs timing: {card}; " + "; ".join(
        f"job ({n}) {j['rows']} rows, {j['stripes']} stripe(s): "
        f"{j['rows_per_s']:.1f} rows/s over submit->completed "
        f"({j['seconds']:.3f} s; the runner {j['runner_s']:.3f} s), "
        f"launches {json.dumps(j['launches'])}"
        for n, j in timing["jobs"].items())
        + f"; resume (the real --selftest-jobs drill, fleet B's boot to "
        f"the resumed job's completion) {fmt(timing['resume_s'])}; roll "
        f"{timing['roll_s']:.3f} s; boot {timing['boot_s']:.3f} s (two "
        f"pools of one worker); " + "; ".join(
            f"{run}: {r['requests']} requests, {r['requests_per_s']:.1f} "
            f"req/s, p50 {r['p50_ms']:.3f} p99 {r['p99_ms']:.3f} ms"
            for run, r in timing["runs"].items())
        + f"; K1 launches acme0 {timing['worker_launches']['acme0']} / "
        f"beta0 {timing['worker_launches']['beta0']}; selftests "
        + ", ".join(f"{n}: {t:.1f} s" for n, t in
                    timing["children"].items()))
    log(f"tenancy: {timing['native']} (host CPU)")
    log(f"tenancy: phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "timing": timing}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--serve-clients", nargs=5, default=None,
                        metavar=("TARGET", "IN", "OUT", "CLIENTS", "WINDOW"),
                        help=argparse.SUPPRESS)  # phase 9's client process
    args = parser.parse_args()
    if args.serve_clients:
        return serve_clients_main(*args.serve_clients)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import licensee_tpu_torch  # noqa: F401 — fails outside a checkout

    device, sm_clocks_per_s = phase_device(torch)
    phase_build()
    t0 = time.perf_counter()
    rows = phase_kernels(np, torch, args.seed, sm_clocks_per_s)
    log(f"phase 3 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows += phase_k5(np, torch, args.seed, sm_clocks_per_s)
    log(f"phase 10's K5 took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        launches, inputs = phase_slice(np, torch, args.seed, root)
        serve = phase_serve(np, torch, args.seed)
        launches.update(serve["launches"])
        fleet = phase_fleet(np, torch, args.seed, refs=serve["refs"])
        tenancy = phase_tenancy(np, torch, args.seed, inputs=inputs,
                                refs=serve["refs"])
    for phase in (fleet, tenancy):
        for key, n in phase["launches"].items():
            launches[key] = launches.get(key, 0) + n
    for row in rows:
        row["launches"] = launches.get(
            (row.pop("slice_run"), row["name"].split("@")[0]), 0)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    adopt_orphans()
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
