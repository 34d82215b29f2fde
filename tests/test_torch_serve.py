"""The port's `serve` against the JAX package's, on the CPU.

The same seeded inputs go through the JAX package's `MicroBatcher` and
the port's (``device="cpu"``, the plain PyTorch scorers): whole JSONL
sessions (classification, error, `stats`, `trace` and `diff` rows), the
four modes over a mixed crawl manifest and a 608-template synthetic SPDX
corpus (also against the port's own `batch-detect` rows), the bucket
ladder and `pad_to`, the drain flushes' counters, corpus reload with its
cache fence and refusals, the injected device failure's fallback, the
socket transport with `diff --socket` through both CLIs, the two
selftests through the port's CLI, and the leaf modules (`word_diff`,
`ResultCache`, `LatencyStats`).  Verdicts are exact integer scores
finished in float64 by the same arithmetic, so every comparison is
equality; only the random trace IDs, and what depends on timing
(`cached`, which flush a request rode), are left out.  Small
``max_batch`` keeps the JAX package's jit compiles short, and every wait
is bounded."""

import contextlib
import io
import json
import os
import re
import threading

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import chip_smoke
from licensee_tpu.cli.main import main as jax_main
from licensee_tpu.corpus import spdx as jax_spdx
from licensee_tpu.normalize.worddiff import word_diff as jax_word_diff
from licensee_tpu.obs import check_exposition as jax_check_exposition
from licensee_tpu.serve.cache import ResultCache as JaxResultCache
from licensee_tpu.serve.scheduler import MicroBatcher as JaxMicroBatcher
from licensee_tpu.serve.server import UnixServer as JaxUnixServer
from licensee_tpu.serve.server import serve_session as jax_serve_session
from licensee_tpu.serve.stats import LatencyStats as JaxLatencyStats
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.corpus import spdx, spdx_synth
from licensee_tpu_torch.corpus.artifact import write_artifact
from licensee_tpu_torch.corpus.license import License
from licensee_tpu_torch.kernels.batch import BlobResult
from licensee_tpu_torch.normalize.worddiff import word_diff
from licensee_tpu_torch.obs import check_exposition
from licensee_tpu_torch.serve.cache import ResultCache
from licensee_tpu_torch.serve.scheduler import MicroBatcher
from licensee_tpu_torch.serve.server import UnixServer, serve_session
from licensee_tpu_torch.serve.stats import LatencyStats

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
WAIT_S = 60.0  # the bound of every wait in this file
SPDX_T = 608

BODY = re.sub(r"\[(\w+)\]", "example", License.find("mit").content)


def both(**kwargs):
    """(JAX batcher, port batcher) built alike; the port's on the CPU."""
    return (JaxMicroBatcher(**kwargs),
            MicroBatcher(device="cpu", **kwargs))


@contextlib.contextmanager
def batchers(**kwargs):
    jb, pb = both(**kwargs)
    try:
        yield jb, pb
    finally:
        jb.close()
        pb.close()


def session(batcher, run, lines) -> list:
    out = []
    counts = run(batcher, lines, out.append)
    assert counts == {"requests": len(lines), "responses": len(lines)}
    return [json.loads(line) for line in out]


def families(exposition: str) -> set:
    return {line.split()[2] for line in exposition.splitlines()
            if line.startswith("# TYPE ")}


def verdict(result) -> tuple:
    return (result.key, result.matcher, result.confidence, result.error)


# -- whole sessions ---------------------------------------------------------

SESSION = [
    {"id": 1, "content": BODY, "filename": "LICENSE"},
    {"id": 2, "content": BODY + "\nzqxa zqxb\n", "filename": "LICENSE"},
    {"id": 3, "content": BODY + "\nzqxa zqxb\n", "filename": "LICENSE"},
    "this is not json",
    "[1, 2]",
    {"id": 6, "content": BODY, "trace": "NOT-HEX"},
    {"id": 7, "content": BODY, "filename": 7},
    {"id": 8, "content": BODY, "deadline_ms": -1},
    {"id": 9, "op": "frobnicate"},
    {"id": 10, "content_b64": "bm90IGJhc2U2NA=="},
    {"id": 11, "content_b64": "!!"},
    {"id": 12, "content": "Copyright (c) 2020 Someone\n"},
    {"id": 13, "content": ""},
    {"id": 14},
    {"id": 15, "op": "stats"},
    {"id": 16, "op": "stats", "format": "prometheus"},
    {"id": 17, "op": "stats", "format": "xml"},
    {"id": 18, "op": "trace", "n": 50},
    {"id": 19, "op": "trace", "n": -1},
    {"id": 20, "op": "diff", "content": BODY + "\nzqxa\n", "license": "mit"},
    {"id": 21, "op": "diff", "content": BODY + "\nzqxa\n"},
    {"id": 22, "op": "diff", "content": BODY, "license": "no-such"},
    {"id": 23, "op": "diff", "content": "x" * (64 * 1024 + 1)},
    {"id": 24, "op": "diff", "content": BODY, "trace": "0123456789abcdef"},
    {"id": 25, "op": "reload"},
    {"id": 26, "content": BODY + "\nzqxc\n", "trace": "0123456789abcdef"},
]


def test_session_matches_jax():
    """Every row of one session: classification and error rows equal
    without ``trace`` (and each classification row carries one), the
    ``diff`` payloads equal, the ``stats`` keys equal, both expositions
    grammatical with the same metric families, the retained traces of
    the same statuses and spans."""
    lines = [x if isinstance(x, str) else json.dumps(x) for x in SESSION]
    with batchers(max_batch=16, max_delay_ms=5.0, trace_sample=1.0) as (
            jb, pb):
        want = session(jb, jax_serve_session, lines)
        got = session(pb, serve_session, lines)
    assert len(got) == len(want) == len(SESSION)
    for w, g in zip(want, got):
        if "stats" in w:
            assert set(g["stats"]) == set(w["stats"])
            for part in ("scheduler", "config", "corpus", "cache"):
                assert set(g["stats"][part]) == set(w["stats"][part]), part
            assert g["stats"]["corpus"] == w["stats"]["corpus"]
        elif "prometheus" in w:
            assert check_exposition(g["prometheus"]) == []
            assert jax_check_exposition(w["prometheus"]) == []
            assert families(g["prometheus"]) == families(w["prometheus"])
        elif "traces" in w:
            # the tail is read when the row is written, so it may hold
            # requests after the verb too; and the duplicate rides its
            # twin's device slot or, if the twin's flush already answered,
            # the cache: timing decides both, so neither is compared
            dedup = {"coalesced": "dedup", "cache_hit": "dedup"}

            def shape(traces):
                return sorted((dedup.get(t["status"], t["status"]),
                               tuple(sorted(s["name"] for s in t["spans"])))
                              for t in traces if t["id"] < w["id"])
            assert shape(g["traces"]) == shape(w["traces"])
            assert len(shape(g["traces"])) == 7  # ids 1-3, 10-13
        else:
            if w.get("key") is not None or "cached" in w:
                assert re.fullmatch(r"[0-9a-f]{16}", g["trace"])
            if w.get("id") not in (24, 26):  # the adopted upstream IDs
                w.pop("trace", None)
                g.pop("trace", None)
            assert g == w
    by_id = {r.get("id"): r for r in got}
    assert (by_id[1]["matcher"], by_id[2]["matcher"]) == ("exact", "dice")
    assert by_id[3]["cached"] and by_id[20]["diff"]["key"] == "mit"
    assert by_id[26]["trace"] == "0123456789abcdef"


# -- the four modes, and T=608 ------------------------------------------------


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """A ~200-file mixed crawl manifest (chip_smoke's, 50 repositories):
    (paths, contents) of its readable files."""
    root = str(tmp_path_factory.mktemp("mixed"))
    manifest = chip_smoke.write_mixed_manifest(np, root, seed=8, n_repos=50)
    with open(manifest, encoding="utf-8") as fh:
        paths = [p for p in fh.read().splitlines() if os.path.exists(p)]
    contents = []
    for p in paths:
        with open(p, "rb") as fh:
            contents.append(fh.read())
    return manifest, paths, contents


@pytest.fixture(scope="module")
def spdx608(tmp_path_factory):
    """A 608-template synthetic SPDX directory, its corpus in both
    packages, and a manifest of its rendered templates and mutations."""
    root = tmp_path_factory.mktemp("spdx")
    src = spdx_synth.synth_spdx_dir(str(root / "src"), SPDX_T, seed=4)
    # 40 rendered templates and 119 seeded mutations of them
    bases = [(f"{t.key}.LICENSE", t.content)
             for t in spdx.load_spdx_dir(src)[::15]]
    manifest = chip_smoke.write_rows(np, str(root / "rows"), bases, seed=5,
                                     n_files=160)
    with open(manifest, encoding="utf-8") as fh:
        paths = [p for p in fh.read().splitlines() if os.path.exists(p)]
    contents = []
    for p in paths:
        with open(p, "rb") as fh:
            contents.append(fh.read())
    return (src, spdx.spdx_corpus(src), jax_spdx.spdx_corpus(src), manifest,
            paths, contents)


def serve_all(batcher, paths, contents) -> list:
    reqs = [batcher.submit(c, os.path.basename(p))
            for p, c in zip(paths, contents)]
    return [verdict(r.wait(WAIT_S)) for r in reqs]


def batch_detect_rows(argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_main(argv) == 0
    rows = {}
    for line in out.getvalue().splitlines():
        row = json.loads(line)
        if "path" in row:
            rows[row["path"]] = (row["key"], row["matcher"],
                                 row["confidence"], row.get("error"))
    return rows


@pytest.mark.parametrize("mode", ["license", "readme", "package", "auto",
                                  "spdx608"])
def test_modes_match_jax_and_batch_detect(mixed, spdx608, mode):
    """Each file of the manifest as one request: the port's verdicts
    equal the JAX batcher's and the port's own `batch-detect` rows."""
    if mode == "spdx608":
        src, port_corpus, jax_corpus, manifest, paths, contents = spdx608
        jb = JaxMicroBatcher(corpus=jax_corpus, max_batch=16)
        pb = MicroBatcher(corpus=port_corpus, max_batch=16, device="cpu")
        argv = ["--corpus", src]
    else:
        manifest, paths, contents = mixed
        jb, pb = both(mode=mode, max_batch=16)
        argv = ["--mode", mode]
    try:
        want = serve_all(jb, paths, contents)
        got = serve_all(pb, paths, contents)
    finally:
        jb.close()
        pb.close()
    assert got == want
    rows = batch_detect_rows(["batch-detect", manifest, "--device", "cpu",
                              *argv])
    assert [rows[p] for p in paths] == got
    if mode in ("license", "auto", "spdx608"):
        assert sum(v[1] == "dice" for v in got) > 0


# -- buckets, pad_to and the flush counters -------------------------------------


@pytest.mark.parametrize("max_batch, buckets", [
    (256, None), (16, None), (100, None), (16, (4, 12)), (1, None),
    (33, (40, 8))])
def test_bucket_ladder_matches_jax(max_batch, buckets):
    with batchers(max_batch=max_batch, buckets=buckets, start=False) as (
            jb, pb):
        assert pb.buckets == jb.buckets
        assert [pb.bucket_for(n) for n in range(1, max_batch + 1)] == \
            [jb.bucket_for(n) for n in range(1, max_batch + 1)]


@pytest.mark.parametrize("kwargs", [
    {"max_batch": 0}, {"max_delay_ms": -1.0}, {"max_delay_ms": float("nan")},
    {"queue_depth": 0}, {"pipeline_depth": 0}, {"buckets": (0, 4)}])
def test_bad_batcher_options_refused_as_jax(kwargs):
    with pytest.raises(ValueError) as want:
        JaxMicroBatcher(start=False, **kwargs)
    with pytest.raises(ValueError) as got:
        MicroBatcher(start=False, device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


def test_mesh_refused():
    """A mesh over the pallas methods is refused in the JAX package's
    words (a mesh the other methods take is served: test_torch_parallel)."""
    with pytest.raises(ValueError) as want:
        JaxMicroBatcher(start=False, method="pallas", mesh=(2, 1))
    with pytest.raises(ValueError) as got:
        MicroBatcher(start=False, device="cpu", method="pallas", mesh=(2, 1))
    assert str(got.value) == str(want.value)
    assert "single-device" in str(got.value)


@pytest.mark.parametrize("pad_to", [0, -3])
def test_pad_to_refused_as_jax(pad_to):
    with batchers(max_batch=8, start=False) as (jb, pb):
        got = {}
        for name, b in (("jax", jb), ("port", pb)):
            clf = b.classifier
            prepared = clf.prepare_batch([BODY + "\nzqpad\n"])
            with pytest.raises(ValueError) as exc:
                clf.dispatch_chunks_async(prepared, pad_to=pad_to)
            got[name] = str(exc.value)
    assert got["port"] == got["jax"] == f"pad_to must be >= 1, got {pad_to}"


def test_drain_flushes_match_jax():
    """37 distinct Dice-bound requests into unstarted batchers, drained
    by close(): flushes of 16, 16 and 5 rows in buckets 16, 16 and 8, the
    same scheduler counters and per-bucket dispatch stats as the JAX
    package's, and the same verdicts."""
    texts = [BODY + f"\nzqdrain{i}\n" for i in range(37)]
    out = {}
    for name, b in zip(("jax", "port"), both(max_batch=16, start=False)):
        reqs = [b.submit(t, "LICENSE") for t in texts]
        b.close()
        stats = b.stats()
        sched = stats["scheduler"]
        out[name] = (
            [verdict(r.wait(WAIT_S)) for r in reqs],
            {k: sched[k] for k in ("device_batches", "device_rows",
                                   "padded_rows", "flush", "buckets",
                                   "completed", "submitted")},
            {int(k): v["compiles"] + v["dispatches"]
             for k, v in stats["device"]["per_shape"].items()},
        )
    assert out["port"] == out["jax"]
    assert out["port"][1]["buckets"] == {"8": 1, "16": 2}
    assert out["port"][1]["padded_rows"] == 3


def test_warm_start_sets_up_every_bucket():
    b = MicroBatcher(max_batch=64, device="cpu", warm_start=True)
    try:
        per_shape = b.stats()["device"]["per_shape"]
        assert sorted(per_shape) == [8, 32, 64]
        assert all(v["compiles"] == 1 and v["dispatches"] == 0
                   for v in per_shape.values())
        assert b.classify(BODY + "\nzqwarm\n", "LICENSE",
                          timeout=WAIT_S).matcher == "dice"
    finally:
        b.close()
    assert b.stats()["device"]["compiles"] == 3


# -- reload --------------------------------------------------------------------


def test_reload_matches_jax(tmp_path):
    """The swap (fingerprints, response), the cache fence, and the
    refusals of a corrupt artifact, a missing source and a corpus-less
    mode, as session rows of both packages."""
    artifact = str(tmp_path / "spdx.corpus.npz")
    write_artifact(artifact, spdx.spdx_corpus(None), source="spdx")
    corrupt = str(tmp_path / "corrupt.corpus.npz")
    with open(corrupt, "wb") as fh:
        fh.write(b"not a corpus artifact at all")
    seed = BODY + "\nzqfence zqfence2\n"
    lines = [json.dumps(x) for x in (
        {"id": 1, "content": seed, "filename": "LICENSE"},
        {"id": 2, "op": "reload", "corpus": artifact},
        {"id": 3, "content": seed, "filename": "LICENSE"},
        {"id": 4, "op": "reload", "corpus": corrupt},
        {"id": 5, "op": "reload", "corpus": str(tmp_path / "missing.npz")},
        {"id": 6, "content": BODY + "\nzqafter\n", "filename": "LICENSE"},
    )]
    rows = {}
    with batchers(max_batch=16, corpus_source="vendored") as (jb, pb):
        for name, b, run in (("jax", jb, jax_serve_session),
                             ("port", pb, serve_session)):
            fp_old = b.corpus_fingerprint
            # one line at a time: the reload must land between requests
            got = []
            for line in lines:
                got += session(b, run, [line])
            for r in got:
                r.pop("trace", None)
                if "reload" in r:
                    assert r["reload"].pop("elapsed_s") >= 0
            rows[name] = got
            assert got[1]["reload"]["previous"] == fp_old
            assert b.corpus_fingerprint == got[1]["reload"]["fingerprint"]
            assert got[2]["cached"] is False  # the fence
            assert got[0]["corpus"] != got[2]["corpus"]
            sched = b.stats()["scheduler"]
            assert (sched["reloads"], sched["reload_failed"]) == (1, 2)
    assert rows["port"] == rows["jax"]
    with batchers(mode="package", start=False) as (jb, pb):
        problems = []
        for b in (jb, pb):
            with pytest.raises(Exception) as exc:
                b.reload_corpus(artifact)
            problems.append(exc.value.problems)
    assert problems[0] == problems[1] and "host-only" in problems[1][0]


# -- the injected device failure ----------------------------------------------


def _raise_injected(*_a, **_k):
    raise RuntimeError("injected device failure")


def test_injected_device_failure_matches_jax():
    """A submit that raises falls back to the host algebra: the verdict
    equals the JAX package's, one fallback counted, and the request's
    trace carries all five spans."""
    out = []
    with batchers(max_batch=16, trace_sample=1.0, trace_slow_ms=0.0) as (
            jb, pb):
        for b in (jb, pb):
            b.classifier.dispatch_chunks_async = _raise_injected
            res = b.classify(BODY + "\nzqfb zqfc\n", "LICENSE",
                             timeout=WAIT_S)
            spans = [{s["name"] for s in t["spans"]}
                     for t in b.trace_tail(50)]
            assert {"cache_probe", "featurize", "queue_wait", "device",
                    "fallback"} in spans
            sched = b.stats()["scheduler"]
            out.append((res.as_dict(), sched["fallbacks"],
                        sched["completion_errors"]))
    assert out[1] == out[0]
    assert out[1][0]["matcher"] == "dice" and out[1][1:] == (1, 0)


# -- sockets and diff --socket ---------------------------------------------------


def run_cli(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@contextlib.contextmanager
def worker(server_cls, batcher, path):
    server = server_cls(path, batcher)
    thread = threading.Thread(target=server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        thread.join(timeout=WAIT_S)
        server.server_close()
        assert not thread.is_alive()
        batcher.close()


DIFF_CASES = [
    ("bsd-2-author", None), ("mit", "mit"), ("bsd-2-author", "mit"),
    ("apache-2.0_markdown", None), ("mit", "no-such-license"),
]


def test_diff_socket_matches_jax_cli(tmp_path):
    """`diff --socket` through the port's CLI against the port's worker
    gives the JAX CLI's stdout against a JAX worker byte for byte (and
    its exit code and stderr), and the socket carries whole sessions."""
    jb, pb = both(max_batch=16)
    jsock, psock = str(tmp_path / "jax.sock"), str(tmp_path / "port.sock")
    with worker(JaxUnixServer, jb, jsock), worker(UnixServer, pb, psock):
        for name, key in DIFF_CASES:
            args = ["diff", os.path.join(FIXTURES, name)]
            if key:
                args += ["--license", key]
            want = run_cli(jax_main, [*args, "--socket", jsock])
            got = run_cli(port_main, [*args, "--socket", psock])
            assert got == want, (name, key)
            assert got[0] == (1 if key == "no-such-license" else 0)
        from licensee_tpu_torch.fleet.wire import oneshot

        row = oneshot(psock, {"id": 9, "content": BODY}, WAIT_S)
        assert (row["id"], row["matcher"]) == (9, "exact")
    missing = run_cli(port_main, ["diff", os.path.join(FIXTURES, "mit"),
                                  "--socket", str(tmp_path / "gone.sock")])
    assert missing[0] == 1 and "cannot reach worker" in missing[2]


# -- the CLI -----------------------------------------------------------------------


@pytest.mark.parametrize("flag, key", [("--selftest", "selftest"),
                                       ("--selftest-reload",
                                        "reload_selftest")])
def test_selftests_pass_through_the_cli(flag, key):
    rc, out, _err = run_cli(port_main, ["serve", flag, "--device", "cpu"])
    summary = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and summary[key] == "ok" and summary["problems"] == []


def test_serve_stdio_stats_and_refusals(monkeypatch):
    """A piped session through `serve --device cpu --stats`, and the
    refusals: no card without --device cpu, a bad corpus, bad buckets."""
    lines = "".join(json.dumps(x) + "\n" for x in SESSION[:3])
    monkeypatch.setattr("sys.stdin", io.StringIO(lines))
    rc, out, err = run_cli(port_main, ["serve", "--device", "cpu",
                                       "--stats"])
    rows = [json.loads(x) for x in out.splitlines()]
    stats = json.loads(err.strip().splitlines()[-1])
    assert rc == 0 and [r["id"] for r in rows] == [1, 2, 3]
    assert stats["scheduler"]["fallbacks"] == 0
    assert stats["scheduler"]["completed"] == 3
    refusals = [
        (["serve"], "CUDA is not available"),
        (["serve", "--device", "cpu", "--corpus", "/no/such"],
         "cannot load corpus"),
        (["serve", "--device", "cpu", "--buckets", "8,x"], "bad --buckets"),
    ]
    if torch.cuda.is_available():
        refusals = refusals[1:]
    for argv, msg in refusals:
        rc, out, err = run_cli(port_main, argv)
        assert rc == 1 and not out and msg in err, argv


# -- leaf modules -----------------------------------------------------------------


@pytest.mark.parametrize("left, right", [
    ("a b c", "a b c"), ("a b c", "a x c"), ("", "new words"),
    (None, "x"), ("one two three four", "one three five four six"),
    ("line one\nline two", "line one\nline 2 two"),
])
def test_word_diff_matches_jax(left, right):
    assert word_diff(left, right) == jax_word_diff(left, right)


def test_result_cache_matches_jax():
    from licensee_tpu.kernels.batch import BlobResult as JaxBlobResult

    caches = (JaxResultCache(4, max_bytes=2000), ResultCache(4, max_bytes=2000))
    results = ((JaxBlobResult, caches[0]), (BlobResult, caches[1]))
    rng = np.random.default_rng(3)
    seen = [[], []]
    for _ in range(200):
        k = int(rng.integers(8))
        put = rng.random() < 0.5
        for j, (cls, cache) in enumerate(results):
            if put:
                cache.put(("fp", k), cls(f"k{k}", "dice", 99.0 - k,
                                         closest=[("x" * k, 1.0)]))
            else:
                got = cache.get(("fp", k))
                seen[j].append(None if got is None else got.key)
    assert seen[0] == seen[1]
    assert caches[1].stats() == caches[0].stats()


def test_latency_stats_match_jax():
    want, got = JaxLatencyStats(capacity=64), LatencyStats(capacity=64)
    for s in np.random.default_rng(2).exponential(0.01, 500):
        want.record(float(s))
        got.record(float(s))
    assert got.snapshot() == want.snapshot()


def _exposition(registry_cls, k):
    reg = registry_cls()
    events = reg.counter("serve_requests_total", "events", labels=("event",))
    events.labels(event="completed").inc(10 + k)
    events.labels(event="rejected").inc(k)
    stage = reg.histogram("serve_stage_seconds", "stages", labels=("stage",))
    for s in np.random.default_rng(k).exponential(0.01, 50):
        stage.labels(stage="total").observe(float(s))
    reg.gauge("serve_queue_depth", "depth").set(3 * k)
    return reg


def test_merge_expositions_matches_jax():
    """Two workers' expositions merge into one as the JAX package's do,
    and the merged text keeps the text-format grammar."""
    from licensee_tpu.obs import merge_expositions as jax_merge
    from licensee_tpu_torch.obs import (
        MetricsRegistry,
        merge_expositions,
        render_prometheus,
    )

    per_source = {f"w{k}": render_prometheus(_exposition(MetricsRegistry, k))
                  for k in range(2)}
    merged = merge_expositions(per_source, label="host")
    assert merged == jax_merge(per_source, label="host")
    assert check_exposition(merged) == jax_check_exposition(merged) == []
    assert 'host="w1"' in merged


def test_flight_dump_loads_as_jax(tmp_path):
    """A flight recorder's dump, a torn file, a non-object and a missing
    file read back as the JAX package's reader reads them."""
    from licensee_tpu.obs import load_flight_dump as jax_load
    from licensee_tpu_torch.obs import FlightRecorder, load_flight_dump

    box = str(tmp_path / "w.flight")
    rec = FlightRecorder(box, capacity=4, proc="w0")
    for i in range(6):
        rec.record("device_await", rows=i, bucket=8)
    assert rec.dump() == box
    (tmp_path / "torn").write_text('{"proc": "w')
    (tmp_path / "list").write_text("[1, 2]")
    paths = [box, str(tmp_path / "torn"), str(tmp_path / "list"),
             str(tmp_path / "absent")]
    got = [load_flight_dump(p) for p in paths]
    assert got == [jax_load(p) for p in paths]
    assert got[0]["dropped"] == 2 and got[1:] == [None, None, None]


def test_router_objectives_match_jax():
    """The router's objectives read the same burn from the same fleet
    counters and latencies as the JAX package's."""
    from licensee_tpu.obs import MetricsRegistry as JaxRegistry
    from licensee_tpu.obs import SLOEngine as JaxSLOEngine
    from licensee_tpu.obs import router_objectives as jax_router_objectives
    from licensee_tpu_torch.obs import (
        MetricsRegistry,
        SLOEngine,
        router_objectives,
    )

    reports = []
    for reg_cls, engine_cls, objectives in (
            (JaxRegistry, JaxSLOEngine, jax_router_objectives),
            (MetricsRegistry, SLOEngine, router_objectives)):
        reg = reg_cls()
        engine = engine_cls(reg, objectives(latency_threshold_s=0.05))
        events = reg.counter("fleet_requests_total", labels=("event",))
        for event, n in (("ok", 970), ("no_backend", 20),
                         ("queue_full_returned", 5), ("hedges", 40)):
            events.labels(event=event).inc(n)
        lat = reg.histogram("fleet_request_seconds")
        for s in np.random.default_rng(5).exponential(0.02, 400):
            lat.observe(float(s))
        report = engine.evaluate(now=engine._t0 + 60.0)
        reports.append(report)
    assert reports[1] == reports[0]
    assert set(reports[1]["objectives"]) == {"availability", "latency_p99"}


def test_device_failure_on_the_card_answers_an_error_row(monkeypatch):
    """On the card a failed device submit answers a ``device_error``
    row, counted under ``fallbacks``, and never runs the host fallback
    (whose verdicts equal K1's and would hide the broken kernel).  The
    card's branch is taken on the CPU batcher here by making it report
    itself on the card."""
    from licensee_tpu_torch.serve import scheduler

    monkeypatch.setattr(scheduler, "_on_card", lambda clf: True)

    def no_host(*_a, **_k):
        raise AssertionError("host fallback on the card")

    b = MicroBatcher(device="cpu", max_batch=16, trace_sample=1.0,
                     trace_slow_ms=0.0)
    try:
        monkeypatch.setattr(b, "_scalar_fallback", no_host)
        b.classifier.dispatch_chunks_async = _raise_injected
        res = b.classify(BODY + "\nzqfb zqfc\n", "LICENSE", timeout=WAIT_S)
        spans = [{s["name"] for s in t["spans"]} for t in b.trace_tail(50)]
        sched = b.stats()["scheduler"]
    finally:
        b.close()
    assert (res.key, res.matcher, res.error) == (
        None, None, "device_error: injected device failure")
    assert {"cache_probe", "featurize", "queue_wait", "device"} in spans
    assert (sched["fallbacks"], sched["completion_errors"]) == (1, 0)
    assert sched["cache_hits"] == 0 and len(b.cache) == 0


def test_chip_smoke_serve_phase_on_cpu(tmp_path):
    """chip_smoke.py's phase 9 on the CPU at a small size: its in-process
    and socket runs, reload under load and the checks of its counters
    (the card's launch counts aside)."""
    report = chip_smoke.phase_serve(np, torch, seed=0, device="cpu",
                                    scale=chip_smoke.ServeScale.tiny(),
                                    root=str(tmp_path))
    assert report["runs"] and all(r["fallbacks"] == 0 for r in report["runs"])


def test_launch_counts_lose_no_update_across_threads():
    """The serve scheduler and a reload's validation launch from two
    threads: the launch counts they share lose no increment."""
    import sys

    from licensee_tpu_torch.kernels import dice_cuda

    saved = dict(dice_cuda.LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        dice_cuda.reset_launches()
        threads = [threading.Thread(
            target=lambda: [dice_cuda._count("best_match_fused")
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert dice_cuda.LAUNCHES["best_match_fused"] == 16 * 2000
    finally:
        sys.setswitchinterval(interval)
        dice_cuda.LAUNCHES.update(saved)
