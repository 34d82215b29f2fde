"""The port's striped scale-out runner (`licensee_tpu_torch/parallel/
stripes.py` and the batch-detect --stripes CLI), the twins of
tests/test_stripes.py, on the CPU.

The supervision and merge machinery runs over STUB workers: a script
that keeps the stripe rank arguments, the per-shard resume invariant
and the stats sidecar, so SIGKILL, restart and merge run in
milliseconds.  Real children run once: a 2-stripe `batch-detect` whose
merged JSONL and sidecar equal the JAX CLI's striped run and the port's
unstriped run byte for byte.  `auto` sizing equals the JAX package's,
and an elastic drill scales up and down in a few seconds.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from licensee_tpu_torch.fleet.supervisor import BackoffPolicy
from licensee_tpu_torch.parallel.stripes import (
    StripeError,
    StripeRunner,
    auto_stripe_count,
    count_manifest_entries,
    merge_stats,
    parse_stripes_arg,
    stripe_argv,
)

# every test in this module runs under the lock-order sanitizer
# (tests/lock_sanitizer.py): the runner's supervision loop shares the
# BackoffPolicy/terminate machinery with the fleet supervisor, and any
# lock its callbacks take must keep a consistent global order
pytestmark = pytest.mark.usefixtures("lock_order_sanitizer")

# ---------------------------------------------------------------------------
# the stub stripe worker: same rank math, same shard naming, same
# resume-point semantics as a real batch-detect child — plus scripted
# faults (SIGKILL itself mid-stripe, leave a torn tail, write a short
# shard) driven by marker files in the output directory.

STUB = textwrap.dedent(
    """
    import json, os, signal, sys, time

    manifest, output, index, count = (
        sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    )
    slow_s = float(os.environ.get("STUB_SLOW_S", "0"))
    paths = [l.strip() for l in open(manifest) if l.strip()]
    base, rem = divmod(len(paths), count)
    lo = index * base + min(index, rem)
    hi = lo + base + (1 if index < rem else 0)
    mine = paths[lo:hi]
    shard = (
        output if count <= 1
        else f"{output}.shard-{index:05d}-of-{count:05d}"
    )
    # resume: newline-terminated rows count, torn tail truncated (the
    # BatchProject._resume_point contract)
    done, good = 0, 0
    if os.path.exists(shard):
        with open(shard, "rb") as f:
            for line in f:
                if not line.endswith(b"\\n"):
                    break
                done += 1
                good += len(line)
        with open(shard, "r+b") as f:
            f.truncate(good)
    crash_marker = f"{shard}.crash-once"
    short_marker = f"{shard}.write-short"
    stop = len(mine) - (1 if os.path.exists(short_marker) else 0)
    with open(shard, "a", encoding="utf-8") as f:
        for i in range(done, stop):
            f.write(json.dumps({"path": mine[i], "row": lo + i}) + "\\n")
            f.flush()
            if slow_s:
                time.sleep(slow_s)
            if os.path.exists(crash_marker) and i >= len(mine) // 2:
                os.remove(crash_marker)
                f.write('{"path": "torn-by-SIGKILL')  # no newline
                f.flush()
                os.kill(os.getpid(), signal.SIGKILL)
    with open(f"{shard}.stats.json.tmp", "w", encoding="utf-8") as f:
        json.dump(
            {"total": stop - done, "stage_seconds": {"write": 0.001}}, f
        )
    os.replace(f"{shard}.stats.json.tmp", f"{shard}.stats.json")
    """
)


@pytest.fixture()
def stub_world(tmp_path):
    """A manifest + a stub-worker argv_for, ready for StripeRunner."""
    stub = tmp_path / "stub_worker.py"
    stub.write_text(STUB)
    paths = [f"/nope/LICENSE_{i}" for i in range(23)]
    manifest = tmp_path / "manifest.txt"
    manifest.write_text("\n".join(paths) + "\n")
    output = str(tmp_path / "out.jsonl")

    def argv_for(index, count, resume=True):
        return [
            sys.executable, str(stub), str(manifest), output,
            str(index), str(count),
        ]

    def make_runner(stripes, **kwargs):
        kwargs.setdefault("argv_for", argv_for)
        kwargs.setdefault("env_for", lambda i, chips: dict(os.environ))
        kwargs.setdefault(
            "backoff", BackoffPolicy(base_s=0.05, max_s=0.2)
        )
        kwargs.setdefault("poll_interval_s", 0.03)
        kwargs.setdefault("stall_timeout_s", 0)  # probes off for stubs
        return StripeRunner(str(manifest), output, stripes, **kwargs)

    return {
        "paths": paths,
        "manifest": str(manifest),
        "output": output,
        "make_runner": make_runner,
    }


# -- arg validation + auto sizing --


def test_parse_stripes_arg_validation():
    assert parse_stripes_arg("3") == 3
    for bad in ("0", "-2", "two", "1.5"):
        with pytest.raises(ValueError):
            parse_stripes_arg(bad)
    assert parse_stripes_arg("auto") >= 1


def test_auto_stripe_count_sizing():
    # every stripe needs >= 2 cores (produce workers + serial loop)
    assert auto_stripe_count(cores=1) == 1
    assert auto_stripe_count(cores=2) == 1
    assert auto_stripe_count(cores=8) == 4
    assert auto_stripe_count(cores=64) == 16  # the cap


def test_auto_stripe_count_equals_jax():
    """The port reads no bench file; with the JAX package's own scaling
    model its floor never changes the answer, for every core count."""
    from licensee_tpu.parallel import stripes as jax_stripes

    model = jax_stripes.load_scaling_model()
    assert model["striped_processes_needed_10M_60s"] == 3
    for cores in range(1, 65):
        assert auto_stripe_count(cores=cores) == (
            jax_stripes.auto_stripe_count(cores=cores, scaling_model=model)
        ), cores


def test_runner_rejects_bad_stripe_counts(stub_world):
    with pytest.raises(ValueError):
        stub_world["make_runner"](0)
    with pytest.raises(ValueError):
        stub_world["make_runner"](-1)
    # more stripes than manifest entries: an empty shard can never
    # satisfy the merge row-count check — refuse up front
    with pytest.raises(ValueError, match="more stripes"):
        stub_world["make_runner"](len(stub_world["paths"]) + 1)


def test_auto_clamp_shrinks_to_manifest_size(stub_world):
    """`--stripes auto` sizes from the HOST; a small manifest clamps
    the count instead of erroring about a number the user never chose
    (explicit --stripes N still refuses, tested above)."""
    runner = stub_world["make_runner"](
        len(stub_world["paths"]) + 10, auto_clamp=True
    )
    assert runner.stripes == len(stub_world["paths"])
    summary = runner.run()
    assert summary["rows_written"] == len(stub_world["paths"])


def test_runner_rejects_bad_knobs(stub_world):
    with pytest.raises(ValueError):
        stub_world["make_runner"](2, chips_per_stripe=0)
    with pytest.raises(ValueError):
        stub_world["make_runner"](2, max_restarts=-1)


def test_count_manifest_entries_skips_blanks(tmp_path):
    m = tmp_path / "m.txt"
    m.write_text("/a\n\n/b\n   \n/c\n")
    assert count_manifest_entries(str(m)) == 3


# -- the dict-env chip partition (PR-2's regression contract: a dry run
# over a caller dict must never consult or mutate os.environ) --


def test_chip_partition_dict_env_never_touches_os_environ(tmp_path):
    manifest = tmp_path / "m.txt"
    manifest.write_text("\n".join(f"/nope/{i}" for i in range(8)) + "\n")
    before = dict(os.environ)
    runner = StripeRunner(
        str(manifest), str(tmp_path / "o.jsonl"), 3,
        chips_per_stripe=2,
        argv_for=lambda i, n, resume=True: ["true"],
        base_env={"PATH": "/usr/bin"},
    )
    assert dict(os.environ) == before  # nothing leaked into THIS process
    specs = [
        h.env["LICENSEE_TPU_VISIBLE_CHIPS"] for h in runner.handles
    ]
    assert specs == ["0,1", "2,3", "4,5"]  # disjoint contiguous ranges
    for handle, spec in zip(runner.handles, specs):
        # CUDA's visibility derives through apply_visible_chips over the
        # CHILD's dict
        assert handle.env["CUDA_VISIBLE_DEVICES"] == spec


def test_stripe_argv_resume_contract(tmp_path):
    argv = stripe_argv("m.txt", "o.jsonl", 1, 4, ("--mode", "auto"),
                       resume=False)
    assert "--no-resume" in argv
    assert ["--stripe-index", "1", "--stripe-count", "4"] == argv[
        argv.index("--stripe-index"): argv.index("--stripe-count") + 2
    ]
    assert argv[-2:] == ["--mode", "auto"]
    # a RESTART must always resume from the shard's completed prefix,
    # even when the run started --no-resume
    assert "--no-resume" not in stripe_argv(
        "m.txt", "o.jsonl", 1, 4, resume=True
    )


# -- supervision: SIGKILL mid-run, resume, merge invariants --


def test_sigkill_mid_stripe_resumes_and_merges_exactly(stub_world):
    """The satellite contract: a worker SIGKILLed mid-chunk (torn tail
    included) restarts from its OWN shard's resume point; the merged
    output has every manifest row exactly once, in manifest order."""
    output = stub_world["output"]
    # arm stripe 0's one-shot crash: it kills itself (SIGKILL, torn
    # tail) halfway through its stripe on the first incarnation
    shard0 = f"{output}.shard-00000-of-00002"
    open(f"{shard0}.crash-once", "w").close()
    runner = stub_world["make_runner"](2)
    summary = runner.run()
    assert summary["rows_written"] == len(stub_world["paths"])
    assert runner.handles[0].restarts == 1
    assert runner.handles[0].exit_codes[0] == -signal.SIGKILL
    assert runner.handles[1].restarts == 0
    rows = [
        json.loads(line)
        for line in open(output, encoding="utf-8")
    ]
    # zero duplicates, zero gaps, manifest order — the resumed stripe
    # re-scored only its own unfinished suffix
    assert [r["path"] for r in rows] == stub_world["paths"]
    assert [r["row"] for r in rows] == list(range(len(rows)))
    # per-stripe intermediates are gone after the merge
    assert not os.path.exists(shard0)
    assert not os.path.exists(f"{shard0}.stats.json")
    # merged stats count only rows CLASSIFIED by the final incarnations
    # (a resume's stats cover new rows only, like BatchProject's): the
    # crash at row 6 leaves 7 rows complete, so stripe 0's resume
    # re-scores 5 and stripe 1 scored its 11 — never the other
    # stripe's rows
    assert summary["stats"]["total"] == len(stub_world["paths"]) - 7


def test_sustained_progress_earns_restart_budget_back(stub_world):
    """Fleet-supervisor parity: a stripe that keeps growing its shard
    past stable_after_s resets its BACKOFF counter, so isolated
    transient crashes over a long run never exhaust a lifetime budget;
    the lifetime count still reports via total_restarts."""
    os.environ["STUB_SLOW_S"] = "0.02"
    try:
        output = stub_world["output"]
        open(f"{output}.shard-00000-of-00002.crash-once", "w").close()
        runner = stub_world["make_runner"](
            2,
            backoff=BackoffPolicy(
                base_s=0.02, max_s=0.1, stable_after_s=0.05
            ),
        )
        summary = runner.run()
        assert summary["rows_written"] == len(stub_world["paths"])
        handle = runner.handles[0]
        assert handle.total_restarts == 1
        assert handle.restarts == 0  # earned back by shard growth
        assert summary["per_stripe"][0]["restarts"] == 1
    finally:
        os.environ.pop("STUB_SLOW_S", None)


def test_spawn_failure_drains_other_stripes(stub_world):
    """A Popen failure must not orphan already-spawned siblings."""
    os.environ["STUB_SLOW_S"] = "0.05"
    try:
        good = stub_world["make_runner"](2).handles[0].argv_first

        def argv_for(index, count, resume=True):
            # stripe 0 spawns fine (the real stub argv); stripe 1's
            # spawn raises FileNotFoundError
            if index == 0:
                return good
            return ["/nonexistent-interpreter-for-stripe-test"]

        runner = stub_world["make_runner"](2, argv_for=argv_for)
        with pytest.raises(StripeError, match="spawn failed"):
            runner.run()
        # stripe 0 was spawned first and must be reaped by the drain
        proc = runner.handles[0].proc
        assert proc is None or proc.poll() is not None
    finally:
        os.environ.pop("STUB_SLOW_S", None)


def test_crash_loop_exhausts_restart_budget(stub_world):
    def always_dies(index, count, resume=True):
        return [sys.executable, "-c", "import sys; sys.exit(3)"]

    runner = stub_world["make_runner"](
        2, argv_for=always_dies, max_restarts=2
    )
    with pytest.raises(StripeError, match="giving up"):
        runner.run()
    # every child is reaped; nothing keeps running after the abort
    assert all(h.proc is None or h.proc.poll() is not None
               for h in runner.handles)
    # a failure with ZERO shard growth is deterministic: the fast-fail
    # fires after two attempts instead of burning the whole backoff
    # budget (max_restarts=2 would have allowed a third)
    assert len(runner.handles[0].exit_codes) <= 2


def test_short_shard_refuses_merge(stub_world):
    output = stub_world["output"]
    open(f"{output}.shard-00001-of-00002.write-short", "w").close()
    runner = stub_world["make_runner"](2)
    with pytest.raises(StripeError, match="complete rows"):
        runner.run()


def test_request_stop_drains_resume_safe(stub_world):
    os.environ["STUB_SLOW_S"] = "0.05"
    try:
        runner = stub_world["make_runner"](2)
        errs: list = []

        def run():
            try:
                runner.run()
            except StripeError as exc:
                errs.append(exc)

        t = threading.Thread(target=run)
        t.start()
        # let the stubs write a few rows, then drain
        deadline = time.perf_counter() + 5.0
        shard0 = f"{stub_world['output']}.shard-00000-of-00002"
        while time.perf_counter() < deadline:
            if os.path.exists(shard0) and os.path.getsize(shard0) > 0:
                break
            time.sleep(0.01)
        runner.request_stop()
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert errs and "resume-safe" in str(errs[0])
        # shards survive a drain (they are the resume state)
        assert os.path.exists(shard0)
    finally:
        os.environ.pop("STUB_SLOW_S", None)


def test_already_complete_skips_spawning(stub_world):
    runner = stub_world["make_runner"](2)
    summary = runner.run()
    assert summary["already_complete"] is False
    # second run over the SAME complete output: nothing respawns (the
    # argv here would fail loudly if it ran)
    runner2 = stub_world["make_runner"](
        2,
        argv_for=lambda i, n, resume=True: [
            sys.executable, "-c", "import sys; sys.exit(9)"
        ],
    )
    summary2 = runner2.run()
    assert summary2["already_complete"] is True
    assert summary2["rows_written"] == len(stub_world["paths"])
    # the merge persisted stats beside the output, so a no-op rerun
    # still surfaces them (the --stats-file contract on reruns)
    assert summary2["stats"] is not None
    assert summary2["stats"]["total"] == len(stub_world["paths"])


def test_cleanup_sweeps_stale_shards_from_other_stripe_counts(stub_world):
    """An aborted earlier run at a different stripe count leaves shards
    this run's handles don't name; a successful merge must sweep them
    so a future run at that count can never resume months-stale rows."""
    output = stub_world["output"]
    stale = f"{output}.shard-00000-of-00004"
    open(stale, "w").write('{"path": "/stale", "row": 0}\n')
    open(f"{stale}.meta.json", "w").write("{}")
    summary = stub_world["make_runner"](2).run()
    assert summary["rows_written"] == len(stub_world["paths"])
    assert not os.path.exists(stale)
    assert not os.path.exists(f"{stale}.meta.json")


def test_merge_stats_sums_counters_routes_and_stages():
    merged = merge_stats([
        {"total": 5, "dice_matched": 2, "routed": {"license": 5},
         "stage_seconds": {"read": 0.5, "elapsed": 2.0}},
        {"total": 7, "dice_matched": 1, "routed": {"license": 6,
                                                   "none": 1},
         "stage_seconds": {"read": 0.25, "elapsed": 1.0}},
    ])
    assert merged["total"] == 12
    assert merged["dice_matched"] == 3
    assert merged["routed"] == {"license": 11, "none": 1}
    assert merged["stage_seconds"]["read"] == 0.75
    assert merged["stage_seconds"]["elapsed"] == 3.0


# -- the CLI surface (error paths run without any backend import) --


def _main(argv, capsys):
    from licensee_tpu_torch.cli.main import main

    rc = main(argv)
    return rc, capsys.readouterr()


def test_cli_stripes_needs_output(tmp_path, capsys):
    m = tmp_path / "m.txt"
    m.write_text("/nope\n")
    rc, out = _main(
        ["batch-detect", str(m), "--stripes", "2"], capsys
    )
    assert rc == 1
    assert "--stripes needs --output" in out.err


def test_cli_stripes_validation(tmp_path, capsys):
    m = tmp_path / "m.txt"
    m.write_text("/nope\n")
    for bad in ("0", "-1", "x"):
        rc, out = _main(
            ["batch-detect", str(m), "--stripes", bad,
             "--output", str(tmp_path / "o.jsonl")],
            capsys,
        )
        assert rc == 1, bad
        assert "--stripes" in out.err
    # more stripes than manifest entries surfaces as the runner's error
    rc, out = _main(
        ["batch-detect", str(m), "--stripes", "5",
         "--output", str(tmp_path / "o.jsonl")],
        capsys,
    )
    assert rc == 1
    assert "more stripes" in out.err


def test_cli_stripes_refuses_multihost_env(tmp_path, capsys, monkeypatch):
    m = tmp_path / "m.txt"
    m.write_text("/nope\n")
    monkeypatch.setenv("LICENSEE_TPU_COORDINATOR", "localhost:9999")
    rc, out = _main(
        ["batch-detect", str(m), "--stripes", "1",
         "--output", str(tmp_path / "o.jsonl")],
        capsys,
    )
    assert rc == 1
    assert "multi-host" in out.err


def test_cli_stripe_worker_flags_validated(tmp_path, capsys):
    m = tmp_path / "m.txt"
    m.write_text("/nope\n")
    rc, out = _main(
        ["batch-detect", str(m), "--stripe-index", "0"], capsys
    )
    assert rc == 1
    assert "--stripe-count" in out.err
    rc, out = _main(
        ["batch-detect", str(m), "--stripe-index", "2",
         "--stripe-count", "2",
         "--output", str(tmp_path / "o.jsonl")],
        capsys,
    )
    assert rc == 1
    assert "out of range" in out.err


def test_cli_stripes_refuses_config_mismatch_resume(tmp_path, capsys):
    """A striped rerun over an existing output whose sidecar records a
    different row-shaping config must refuse (the single-process
    ResumeConfigError contract) — even when the output is complete and
    no worker would otherwise run.  The preflight runs the REAL
    _check_resume_config, so the corpus fingerprint is covered too."""
    from licensee_tpu_torch.projects.batch_project import BatchProject

    m = tmp_path / "m.txt"
    m.write_text("/nope\n")
    output = tmp_path / "o.jsonl"
    output.write_text('{"path": "/nope", "key": null}\n')
    meta = tmp_path / "o.jsonl.meta.json"
    config = BatchProject([], mesh=None, device="cpu")._run_config()
    meta.write_text(json.dumps(config))

    # changed --mode refuses
    rc, out = _main(
        ["batch-detect", str(m), "--stripes", "1", "--device", "cpu",
         "--output", str(output), "--mode", "readme"],
        capsys,
    )
    assert rc == 1
    assert "configuration differs" in out.err
    assert "mode" in out.err

    # a changed CORPUS (same keys/vocab, different template content —
    # only the fingerprint knows) refuses too
    bad = dict(config)
    bad["corpus"] = dict(config["corpus"], content_sha1="0" * 40)
    meta.write_text(json.dumps(bad))
    rc, out = _main(
        ["batch-detect", str(m), "--stripes", "1",
         "--output", str(output)],
        capsys,
    )
    assert rc == 1
    assert "corpus" in out.err

    # matching config passes preflight (and no-ops: output complete)
    meta.write_text(json.dumps(config))
    rc, out = _main(
        ["batch-detect", str(m), "--stripes", "1",
         "--output", str(output)],
        capsys,
    )
    assert rc == 0
    assert "already complete" in out.err


def test_cli_batch_detect_requires_manifest_or_selftest(capsys):
    rc, out = _main(["batch-detect"], capsys)
    assert rc == 1
    assert "--selftest" in out.err


def test_cli_stripes_runs_stub_end_to_end(tmp_path, capsys, monkeypatch):
    """The full CLI path (`batch-detect --stripes 2 --output ...`) over
    stub children: monkeypatch stripe_argv so the spawned argv is the
    stub, keeping the runner/merge/summary plumbing real."""
    stub = tmp_path / "stub_worker.py"
    stub.write_text(STUB)
    paths = [f"/nope/L_{i}" for i in range(9)]
    manifest = tmp_path / "m.txt"
    manifest.write_text("\n".join(paths) + "\n")
    output = tmp_path / "out.jsonl"

    import licensee_tpu_torch.parallel.stripes as stripes_mod

    def stub_argv(man, out, index, count, forward=(), resume=True):
        return [
            sys.executable, str(stub), man, out, str(index), str(count),
        ]

    monkeypatch.setattr(stripes_mod, "stripe_argv", stub_argv)
    stats_file = tmp_path / "merged.stats.json"
    rc, out = _main(
        ["batch-detect", str(manifest), "--stripes", "2",
         "--output", str(output), "--stats",
         "--stats-file", str(stats_file)],
        capsys,
    )
    assert rc == 0
    rows = [json.loads(l) for l in open(output, encoding="utf-8")]
    assert [r["path"] for r in rows] == paths
    assert "stripes: done: 9 rows" in out.err
    # an operator-passed --stats-file gets the MERGED stats (the
    # per-shard dumps are the runner's internal inputs)
    merged = json.loads(stats_file.read_text())
    assert merged["total"] == len(paths)


def test_chips_per_stripe_lanes_forward_respects_explicit_mesh(
    tmp_path, capsys, monkeypatch
):
    """`--chips-per-stripe K` auto-forwards `--device-lanes auto` to
    each worker — but lanes are mutually exclusive with an explicit
    numeric `--mesh` (BatchClassifier raises), so an operator who
    pinned per-dispatch sharding must NOT get lanes forwarded on top
    of it (every stripe would die at startup)."""
    stub = tmp_path / "stub_worker.py"
    stub.write_text(STUB)
    manifest = tmp_path / "m.txt"
    manifest.write_text("\n".join(f"/nope/L_{i}" for i in range(6)) + "\n")

    import licensee_tpu_torch.parallel.stripes as stripes_mod

    captured: list[list[str]] = []

    def stub_argv(man, out, index, count, forward=(), resume=True):
        captured.append(list(forward))
        return [
            sys.executable, str(stub), man, out, str(index), str(count),
        ]

    monkeypatch.setattr(stripes_mod, "stripe_argv", stub_argv)

    for case, (extra, want_lanes) in enumerate((
        ([], True),                      # default: lanes auto-forward
        (["--mesh", "auto"], True),      # "auto" is overridden by lanes
        (["--mesh", "2,1"], False),      # explicit shard: no lanes
    )):
        captured.clear()
        rc, _out = _main(
            ["batch-detect", str(manifest), "--stripes", "2",
             "--chips-per-stripe", "2",
             "--output", str(tmp_path / f"out-{case}.jsonl"),
             "--no-resume", *extra],
            capsys,
        )
        assert rc == 0
        assert captured, "stripe_argv never called"
        for fwd in captured:
            has_lanes = "--device-lanes" in fwd
            assert has_lanes == want_lanes, (extra, fwd)
            if want_lanes:
                assert fwd[fwd.index("--device-lanes") + 1] == "auto"


# -- real children, against the JAX package --


def _real_manifest(tmp_path):
    """Loose LICENSE files of the fixtures and a tar of some of them, so
    the stripes split expanded rows, one container across both."""
    import glob
    import io
    import tarfile

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(repo, "tests", "fixtures", "*",
                                          "LICENSE*")))[:16]
    tar = tmp_path / "a.tar"
    with tarfile.open(tar, "w") as tf:
        for i, path in enumerate(files[:6]):
            data = open(path, "rb").read()
            info = tarfile.TarInfo(name=f"m{i}/LICENSE")
            info.size = len(data)
            info.mtime = 1_600_000_000
            tf.addfile(info, io.BytesIO(data))
    manifest = tmp_path / "m.txt"
    manifest.write_text("\n".join(files[6:11] + [f"{tar}::*"]
                                  + files[11:]) + "\n")
    return str(manifest)


def _bytes(out):
    return tuple(open(f"{out}{s}", "rb").read()
                 for s in ("", ".containers.jsonl", ".meta.json"))


def test_real_two_stripe_run_matches_jax_and_unstriped(tmp_path, capsys):
    from licensee_tpu.cli.main import main as jax_main
    from licensee_tpu_torch.cli.main import main as port_main

    manifest = _real_manifest(tmp_path)
    common = ["--batch-size", "8", "--mesh", "none"]
    outs = {}
    for name, main, argv in (
        ("port2", port_main, ["--stripes", "2", "--device", "cpu"]),
        ("jax2", jax_main, ["--stripes", "2"]),
        ("port1", port_main, ["--device", "cpu"]),
    ):
        out = tmp_path / f"{name}.jsonl"
        assert main(["batch-detect", manifest, "--output", str(out),
                     *common, *argv]) == 0, capsys.readouterr().err
        outs[name] = _bytes(out)
    assert outs["port2"] == outs["jax2"] == outs["port1"]
    # the workers by hand: each stripe's shard, in stripe order, is the
    # merged output
    shards = b""
    for index in (0, 1):
        out = tmp_path / "worker.jsonl"
        assert port_main(["batch-detect", manifest, "--output", str(out),
                          *common, "--device", "cpu", "--stripe-index",
                          str(index), "--stripe-count", "2"]) == 0
        shards += open(f"{out}.shard-{index:05d}-of-00002", "rb").read()
    assert shards == outs["port1"][0]


@pytest.mark.timeout(60)
@pytest.mark.parametrize("child_start_s", [0.0, 4.0])
def test_elastic_drill_scales_up_and_down(child_start_s, monkeypatch):
    """`batch-detect --selftest-autoscale`: stub stripes under the real
    drain, respawn and resume machinery scale up on a saturated lane and
    back down on an idle one, and merge to the static run's bytes.

    At 4 s the stubs start slower than the drill's cooldown, as a JAX
    import (~3.5 s) or a card child (8-13 s) does: each rescale returns
    to a stripe count whose heartbeat files an earlier generation left,
    and a runner that read them as its new children's pressure would
    flap between 1 and 2 stripes without end."""
    import io

    from licensee_tpu_torch.parallel import stripes

    monkeypatch.setattr(
        stripes, "_AUTOSCALE_STUB",
        f"import time\ntime.sleep({child_start_s})\n"
        + stripes._AUTOSCALE_STUB,
    )
    log = io.StringIO()
    assert stripes.selftest_autoscale(stream=log) == 0, log.getvalue()
    assert "scaled up then down" in log.getvalue()
