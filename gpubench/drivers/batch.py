"""The driver ``batch``: `BatchProject` at the configuration's default
flags, in process, over a manifest the run's seed draws through the
mix's generator, its JSONL rows written into a pipe that the harness
reads as they land.

The pipeline writes a whole batch of rows at a time, in manifest order,
so the k-th batch has landed once k·batch_size rows have come through
the pipe.  The window opens at the first landing ``warm_s`` (the cell's
file) or more after the run starts, the pipeline's fill and its first
seconds being set-up, and closes at the first landing ``--seconds`` or
more after that: its rows over its seconds, so no partial batch is
counted and no stall inside it is missed.  Closing the pipe then ends the run (the writer's
next write fails).  A manifest that runs dry before the close fails
the run: the window is never shortened.
"""

from __future__ import annotations

import fcntl
import json
import math
import os
import shutil
import sys
import tempfile
import threading
import time

from gpubench import check, spec
from gpubench.device import cpu_seconds

# fcntl's F_SETPIPE_SZ (Linux; Python 3.10+ names it fcntl.F_SETPIPE_SZ)
F_SETPIPE_SZ = getattr(fcntl, "F_SETPIPE_SZ", 1031)
# rows of the warm-up run over the same classifier: one batch's worth
# of every path the timed rows take (read, featurize, K1, finish, write)
WARM_ROWS = 512


def manifest_rows(cell, seconds: float) -> int:
    """The rows a run's manifest holds: the warm-up and the window at the
    cell's ceiling rate, and the cell's headroom, the batches in flight
    when the window opens and with the landing that closes it (one
    batch where every row is scored, a whole coalesced group where few
    are)."""
    B = int(cell.config["batch"]["batch_size"])
    own = cell.own
    return B * (int(own["headroom_batches"]) + math.ceil(
        float(own["rows_per_s_ceiling"]) * (float(own["warm_s"]) + seconds)
        / B))


def project_kwargs(config: dict, classifier) -> dict:
    b = config["batch"]
    return dict(
        classifier=classifier,
        batch_size=int(b["batch_size"]),
        threshold=float(config["confidence_threshold"]),
        workers=None if b["workers"] == "cores" else int(b["workers"]),
        inflight=int(b["inflight"]),
        pipeline_depth=int(b["pipeline_depth"]),
        coalesce_batches=int(b["coalesce_batches"]),
        mode=config["mode"],
        process_index=0,
        process_count=1,
    )


class Landings:
    """Reads the pipe, counts rows, and marks the window's ends."""

    def __init__(self, fifo: str, batch: int, warm_s: float, seconds: float,
                 on_open, on_close):
        self.fifo, self.batch = fifo, batch
        self.warm_s, self.seconds = warm_s, seconds
        self.on_open, self.on_close = on_open, on_close
        self.data = bytearray()
        self.landed: list = []  # (seconds from the open, rows)
        self.t_open = self.t_close = None
        self.rows_open = self.rows_close = 0

    def read(self) -> None:
        fd = os.open(self.fifo, os.O_RDONLY)
        t_start = time.perf_counter()
        # room for a whole batch of rows in the pipe: the writer thread
        # never waits on this reader for more than one wake-up a batch
        fcntl.fcntl(fd, F_SETPIPE_SZ, 1 << 20)
        try:
            rows = last = 0
            while True:
                chunk = os.read(fd, 1 << 20)
                now = time.perf_counter()
                if not chunk:
                    raise RuntimeError(
                        f"the manifest ran dry after {rows} rows: the "
                        "window cannot close (raise the cell's ceiling)")
                self.data += chunk
                rows += chunk.count(b"\n")
                landed = rows // self.batch * self.batch
                if landed == last:
                    continue  # part of a batch: nothing landed
                last = landed
                if self.t_open is None:
                    if now - t_start >= self.warm_s:
                        self.t_open, self.rows_open = now, landed
                        self.landed.append((0.0, landed))
                        self.on_open()
                    continue
                self.landed.append((now - self.t_open, landed))
                if now - self.t_open >= self.seconds:
                    self.t_close, self.rows_close = now, landed
                    self.on_close()
                    return
        finally:
            os.close(fd)


def snapshot(project, classifier, launches: dict) -> dict:
    d = classifier.dispatch_stats()
    return {
        "stage_seconds": dict(project.stats.stage_seconds),
        "device_rows": project.stats.device_rows,
        "chunks": d.get("dispatches", 0) + d.get("compiles", 0),
        "launches": dict(launches),
    }


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> dict:
    import torch

    from licensee_tpu_torch.kernels import dice_cuda
    from licensee_tpu_torch.kernels.batch import BatchClassifier
    from licensee_tpu_torch.projects.batch_project import BatchProject

    config, mix = cell.config, cell.mix
    B = int(config["batch"]["batch_size"])
    warm_s = float(cell.own["warm_s"])
    phases = spec.Phases(t_start, "interpreter, torch and the card check")
    corpus = spec.port_corpus(config)
    phases.mark("the port's corpus")
    if (corpus.n_templates, corpus.n_lanes) != (config["templates"],
                                                config["lanes"]):
        raise RuntimeError(
            f"{config['name']}: the port compiled T={corpus.n_templates}, "
            f"W={corpus.n_lanes}; the configuration states "
            f"T={config['templates']}, W={config['lanes']}")
    templates = spec.reference_templates(config)
    generator = cell.generator()
    bases = generator.bases(templates, mix)
    n_rows = manifest_rows(cell, seconds)
    pool = os.path.join(spec.CACHE, "pools", cell.name)
    root = tempfile.mkdtemp(prefix="gpubench-")
    try:
        rows = generator.manifest(mix, bases, seed, n_rows, pool)
        warm = generator.manifest(mix, bases, seed ^ 0x5EED, WARM_ROWS, pool)
        phases.mark("traffic")
        classifier = BatchClassifier(
            corpus=corpus, pad_batch_to=B, mode=config["mode"],
            device=device)
        kwargs = project_kwargs(config, classifier)
        phases.mark("the classifier")
        BatchProject(warm, **kwargs).run(os.path.join(root, "warm.jsonl"),
                                         resume=False)
        phases.mark("the warm-up run")
        if trace and device == "cuda":
            from gpubench.device import prime_profiler

            prime_profiler(torch)
        project = BatchProject(rows, **kwargs)
        fifo = os.path.join(root, "rows.jsonl")
        os.mkfifo(fifo)
        marks: dict = {}
        prof = None

        def on_open() -> None:
            nonlocal prof
            marks["open"] = snapshot(project, classifier, dice_cuda.LAUNCHES)
            marks["cpu_open"] = cpu_seconds()
            if trace:
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                t0 = time.perf_counter()
                prof.start()
                marks["trace_open"] = time.perf_counter()
                print(f"profiler start: {marks['trace_open'] - t0:.3f} s",
                      file=sys.stderr)

        def on_close() -> None:
            if prof is not None:
                marks["trace_close"] = time.perf_counter()
                if device == "cuda":
                    torch.cuda.synchronize()
                prof.stop()
            marks["close"] = snapshot(project, classifier, dice_cuda.LAUNCHES)
            marks["cpu_close"] = cpu_seconds()

        errors: list = []

        def drive() -> None:
            try:
                project.run(fifo, resume=False)
            except BrokenPipeError:
                pass  # the harness closed the pipe: the window is over
            except BaseException as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        runner = threading.Thread(target=drive, name="gpubench-batch")
        runner.start()
        landings = Landings(fifo, B, warm_s, seconds, on_open, on_close)
        try:
            landings.read()
            phases.mark("the pipeline before the window", landings.t_open)
        except RuntimeError:
            runner.join(timeout=300)
            if errors:  # the run failed: that, not the pipe, is the cause
                raise errors[0] from None
            raise
        finally:
            runner.join(timeout=300)
        if runner.is_alive():
            raise RuntimeError("the batch run did not end after the window")
        if errors:
            raise errors[0]
        window_s = landings.t_close - landings.t_open
        print("landings (s, rows): " + " ".join(
            f"{t:.2f}:{r}" for t, r in landings.landed), file=sys.stderr)
        report_host(marks, window_s, landings.rows_close - landings.rows_open)
        peak = (torch.cuda.max_memory_allocated()
                if device == "cuda" else 0)
        del project, classifier
        if device == "cuda":
            torch.cuda.empty_cache()
        result = {
            "setup_s": landings.t_open - t_start,
            "setup_phases": phases.done,
            "window_s": window_s,
            "memory_peak_bytes": peak,
            "e2e": {"rows_per_s": (landings.rows_close - landings.rows_open)
                    / window_s},
        }
        layer = {
            "window_s": window_s,
            "rows": landings.rows_close - landings.rows_open,
            "open": marks["open"], "close": marks["close"],
            "templates": config["templates"], "lanes": config["lanes"],
        }
        if prof is not None:
            path = os.path.join(root, "trace.json")
            prof.export_chrome_trace(path)
            from gpubench.device import Trace

            layer["trace"] = Trace(path)
            layer["trace_s"] = marks["trace_close"] - marks["trace_open"]
            if device == "cuda":
                from gpubench.device import sm_clocks_per_s

                layer["sm_clocks"] = sm_clocks_per_s(torch)
        result["layer"] = layer
        result.update(judge(landings, rows, mix, config, templates, seed))
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)


def report_host(marks: dict, window_s: float, rows: int) -> None:
    """The cores this process kept busy in the window and its CPU time a
    row, on standard error: the rate is the one over the other."""
    cpu = marks["cpu_close"] - marks["cpu_open"]
    print(f"host in the window: process cores busy {cpu / window_s:.3f}; "
          f"process CPU ms a row {cpu * 1e3 / max(rows, 1):.4f}",
          file=sys.stderr)


def judge(landings: Landings, rows: list, mix: dict, config: dict,
          templates: list, seed: int) -> dict:
    """Every written row in manifest order, and a seeded sample of them
    (with each unreadable path) against the reference over the bytes on
    disk."""
    from gpubench.ref.classify import Reference

    n = landings.rows_close
    lines = bytes(landings.data).split(b"\n")[:n]
    written = [json.loads(line) for line in lines]
    order_errors = sum(w.get("path") != rows[i] for i, w in enumerate(written))
    unreadable = [int(i) for i in mix.get("unreadable_rows", ())]
    picked = check.sample(seed, n, unreadable)
    raws = []
    for i in picked:
        try:
            with open(rows[i], "rb") as fh:
                raws.append(fh.read())
        except OSError:
            raws.append(None)
    ref = Reference(templates, float(config["confidence_threshold"]))
    names = [os.path.basename(rows[i]) for i in picked]
    differ, examples = check.compare([written[i] for i in picked],
                                     ref.verdicts(raws, names))
    failed = sum(1 for i, w in enumerate(written[landings.rows_open:],
                                         landings.rows_open)
                 if w.get("error") and i not in unreadable)
    return {
        "attempted": n - landings.rows_open,
        "failed": failed,
        "checks": [
            ("rows_out_of_order", order_errors, 0),
            ("rows_differing", differ, 0),
            ("unreadable_rows_missing", sum(i >= n for i in unreadable), 0),
        ],
        "checked": len(picked),
        "examples": examples,
    }
