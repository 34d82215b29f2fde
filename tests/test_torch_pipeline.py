"""The port's batch-detect pipeline against the JAX package's, on the CPU.

Worker threads or processes, coalescing, the overlap pipeline over the
device future and the writer thread must not change a byte: the JSONL
and the ``.meta.json`` sidecar are held byte-identical to the JAX
package's `BatchProject.run` at every pipeline depth, worker count and
coalescing setting, over the vendored corpus (T=47) and a 608-template
synthetic SPDX directory.  Resume is held to the full run's sha256
across the two packages and after a torn tail.  The cross-batch dedupe
races the writer thread in both packages (the rows are the same either
way), so ``dedupe_hits`` is only bounded, at one worker and depth 1."""

import hashlib
import json
import os
import sys

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import chip_smoke
from licensee_tpu.corpus import spdx as jax_spdx
from licensee_tpu.projects.batch_project import BatchProject as JaxBatchProject
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.corpus import spdx, spdx_synth
from licensee_tpu_torch.corpus.compiler import default_corpus
from licensee_tpu_torch.kernels.batch import (
    BatchClassifier,
    BlobResult,
    DeviceFuture,
)
from licensee_tpu_torch.projects.batch_project import (
    BatchProject,
    ResumeConfigError,
)
from licensee_tpu_torch.serve.featurize import content_key

torch.set_num_threads(1)

BATCH = 32


def repeated(paths, seed):
    """Every path, then every path again in a seeded order: the second
    pass is all verbatim repeats, some in the same batch as their first."""
    rng = np.random.default_rng(seed)
    return list(paths) + [paths[i] for i in rng.permutation(len(paths))]


class Case:
    """One manifest, its corpus in each package, and the JAX package's
    output, sidecar and stats for it."""

    def __init__(self, root, name, paths, corpus, jax_corpus):
        self.paths, self.corpus, self.jax_corpus = paths, corpus, jax_corpus
        ref = str(root / f"{name}.jax.jsonl")
        self.jax_stats = self.jax_run(ref)
        with open(ref, "rb") as f, open(ref + ".meta.json", "rb") as g:
            self.want, self.want_meta = f.read(), g.read()

    def jax_run(self, out: str):
        kwargs = {} if self.jax_corpus is None else {"corpus": self.jax_corpus}
        return JaxBatchProject(self.paths, batch_size=BATCH, mesh=None,
                               tracer=False, **kwargs).run(out)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The vendored slice's inputs (rendered templates, fixtures, seeded
    mutations, one unreadable path) and a 608-template synthetic SPDX
    directory's (rendered templates and their mutations), each listed
    twice."""
    root = tmp_path_factory.mktemp("pipeline")
    manifest = chip_smoke.write_manifest(np, str(root / "v"), 1, n_files=160)
    with open(manifest, encoding="utf-8") as f:
        vendored = repeated(f.read().split(), 1)
    spdx_dir = spdx_synth.synth_spdx_dir(str(root / "spdx-src"), 608, seed=2)
    bases = [(f"{t.key}.LICENSE", t.content)
             for t in spdx.load_spdx_dir(spdx_dir)[:45]]
    manifest = chip_smoke.write_rows(np, str(root / "s"), bases, 2, 91)
    with open(manifest, encoding="utf-8") as f:
        wide = repeated(f.read().split(), 2)
    return {
        "vendored": Case(root, "vendored", vendored, default_corpus(), None),
        "spdx608": Case(root, "spdx608", wide, spdx.spdx_corpus(spdx_dir),
                        jax_spdx.spdx_corpus(spdx_dir)),
    }


def port_run(tmp_path, paths, corpus, name="port.jsonl", resume=True,
             **kwargs):
    out = str(tmp_path / name)
    project = BatchProject(paths, corpus=corpus, batch_size=BATCH,
                           device="cpu", **kwargs)
    stats = project.run(out, resume=resume)
    with open(out, "rb") as f, open(out + ".meta.json", "rb") as g:
        return f.read(), g.read(), stats, out


COUNTS = ("total", "prefiltered_copyright", "prefiltered_exact",
          "dice_matched", "unmatched", "read_errors", "featurize_errors",
          "skipped_oversized")


@pytest.mark.parametrize("coalesce", [1, 32])
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("case", ["vendored", "spdx608"])
def test_jsonl_and_sidecar_match_jax(cases, tmp_path, case, depth, workers,
                                     coalesce):
    c = cases[case]
    paths, corpus, want, want_meta = c.paths, c.corpus, c.want, c.want_meta
    got, meta, stats, _out = port_run(
        tmp_path, paths, corpus, workers=workers, pipeline_depth=depth,
        coalesce_batches=coalesce)
    assert got == want
    assert meta == want_meta
    for name in COUNTS:
        assert getattr(stats, name) == getattr(c.jax_stats, name), name
    assert stats.total == len(paths)
    assert set(stats.pipeline["occupancy"]) == {"featurize", "device",
                                                "writer"}
    assert stats.pipeline["inflight_chunks"] == 0
    if workers == 1 and depth == 1:
        # every in-batch repeat is a hit; no distinct content's first row
        # can be one
        keys, in_batch = [], 0
        for start in range(0, len(paths), BATCH):
            seen = set()
            for p in paths[start : start + BATCH]:
                if not os.path.exists(p):
                    continue
                with open(p, "rb") as f:
                    k = content_key("license", os.path.basename(p), f.read())
                in_batch += k in seen
                seen.add(k)
                keys.append(k)
        assert in_batch <= stats.dedupe_hits <= len(keys) - len(set(keys))
        assert in_batch > 0


@pytest.mark.parametrize("case", ["vendored", "spdx608"])
def test_featurize_procs_match_jax(cases, tmp_path, case):
    """Two spawned worker processes, each with a host-only classifier."""
    c = cases[case]
    paths, corpus, want, want_meta = c.paths, c.corpus, c.want, c.want_meta
    got, meta, stats, _out = port_run(tmp_path, paths, corpus,
                                      featurize_procs=2)
    assert (got, meta) == (want, want_meta)
    assert stats.stage_seconds["featurize"] > 0


def test_many_threads_with_short_switch_interval(cases, tmp_path):
    """More worker threads than cores, a thread switch every few
    microseconds, four groups in flight and no coalescing: the writer's
    order and the shared dedupe cache still give the same bytes."""
    c = cases["vendored"]
    paths, corpus, want = c.paths, c.corpus, c.want
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got, *_ = port_run(tmp_path, paths, corpus, workers=16, inflight=8,
                           pipeline_depth=4, coalesce_batches=1)
    finally:
        sys.setswitchinterval(interval)
    assert got == want


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def cut_mid_line(path: str, full: bytes, frac: float) -> int:
    """Leave a prefix of ``full`` that ends inside a line; returns the
    number of whole lines kept."""
    cut = int(len(full) * frac)
    while full[cut - 1 : cut] == b"\n":
        cut += 1
    with open(path, "wb") as f:
        f.write(full[:cut])
    return full[:cut].count(b"\n")


def test_port_resumes_a_jax_partial_output(cases, tmp_path):
    c = cases["vendored"]
    paths, corpus, want, want_meta = c.paths, c.corpus, c.want, c.want_meta
    out = str(tmp_path / "out.jsonl")
    c.jax_run(out)
    kept = cut_mid_line(out, want, 0.43)
    assert 0 < kept < len(paths)
    got, meta, stats, _out = port_run(tmp_path, paths, corpus, "out.jsonl")
    assert sha(got) == sha(want) and meta == want_meta
    assert stats.total == len(paths) - kept


def test_jax_resumes_a_port_partial_output(cases, tmp_path):
    c = cases["spdx608"]
    paths, corpus, want, want_meta = c.paths, c.corpus, c.want, c.want_meta
    _got, _meta, _stats2, out = port_run(tmp_path, paths, corpus)
    kept = cut_mid_line(out, want, 0.61)
    stats = c.jax_run(out)
    with open(out, "rb") as f, open(out + ".meta.json", "rb") as g:
        assert sha(f.read()) == sha(want) and g.read() == want_meta
    assert stats.total == len(paths) - kept


@pytest.mark.parametrize("depth", [1, 2])
def test_torn_tail_resumes_to_the_full_runs_bytes(cases, tmp_path, depth):
    c = cases["vendored"]
    paths, corpus, want, want_meta = c.paths, c.corpus, c.want, c.want_meta
    _got, _meta, _stats2, out = port_run(tmp_path, paths, corpus)
    kept = cut_mid_line(out, want, 0.77)
    got, meta, stats, _out = port_run(tmp_path, paths, corpus,
                                      pipeline_depth=depth)
    assert sha(got) == sha(want) and meta == want_meta
    assert stats.total == len(paths) - kept
    # --no-resume starts over
    got, _meta, stats, _out = port_run(tmp_path, paths, corpus, resume=False)
    assert got == want and stats.total == len(paths)


def test_resume_refuses_another_configuration(cases, tmp_path, capsys):
    c = cases["vendored"]
    paths, corpus, want = c.paths, c.corpus, c.want
    _got, _meta2, _stats2, out = port_run(tmp_path, paths, corpus)
    cut_mid_line(out, want, 0.5)
    with pytest.raises(ResumeConfigError, match="threshold"):
        port_run(tmp_path, paths, corpus, threshold=90.0)
    with pytest.raises(ResumeConfigError, match="corpus fingerprint"):
        port_run(tmp_path, paths, cases["spdx608"].corpus)
    with open(out + ".meta.json", encoding="utf-8") as f:
        sidecar = json.load(f)
    sidecar["mode"] = "readme"
    with open(out + ".meta.json", "w", encoding="utf-8") as f:
        json.dump(sidecar, f)
    with pytest.raises(ResumeConfigError, match="mode"):
        port_run(tmp_path, paths, corpus)
    manifest = tmp_path / "manifest.txt"
    manifest.write_text("\n".join(paths) + "\n", encoding="utf-8")
    assert port_main(["batch-detect", str(manifest), "--output", out,
                      "--device", "cpu"]) == 1
    assert "cannot resume" in capsys.readouterr().err
    # the refusal touched nothing: the same run without resume completes
    assert port_main(["batch-detect", str(manifest), "--output", out,
                      "--device", "cpu", "--no-resume",
                      "--batch-size", str(BATCH)]) == 0
    with open(out, "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("argv", [
    ["--pipeline-depth", "0"], ["--coalesce-batches", "0"],
    ["--featurize-procs", "-1"], ["--pipeline-depth", "nan"],
])
def test_cli_bounds(tmp_path, argv):
    with pytest.raises(SystemExit):
        port_main(["batch-detect", "m.txt", "--output",
                   str(tmp_path / "o.jsonl"), *argv])


def prepared_with_todo(clf, n):
    contents = [chip_smoke.mutate("The quick brown fox " * 30,
                                  np.random.default_rng(i), 0.3).encode()
                for i in range(n)]
    prepared = clf.prepare_batch(contents)
    assert len(prepared.todo) == n
    return prepared


def test_staging_ring_recycles_only_after_resolve():
    clf = BatchClassifier(pad_batch_to=4, device="cpu")
    prepared = prepared_with_todo(clf, 6)  # two chunks a dispatch
    first = clf.dispatch_chunks_async(prepared)
    second = clf.dispatch_chunks_async(prepared)
    slots = [s for f in (first, second) for _c, s, _d in f._parts]
    assert len({id(s) for s in slots}) == 4  # nothing recycled in flight
    assert first.ready() and len(first) == 2
    outs = first.result()
    assert [len(c) for c, _out in outs] == [4, 2]
    # first's slots are free again and the next dispatch takes them
    third = clf.dispatch_chunks_async(prepared)
    again = {id(s) for _c, s, _d in third._parts}
    assert again == {id(s) for s in slots[:2]}
    # a resolved future's rows are its own, not the recycled slot's
    for _c, slot, _d in third._parts:
        slot.out[:] = -7
    assert all((a != -7).all() for _c, out in outs for a in out)
    assert outs == first.result()  # idempotent
    second.result()
    third.result()
    stats = clf.dispatch_stats()
    assert stats["compiles"] == 1 and stats["dispatches"] == 5
    assert stats["shapes"] == [4] and stats["per_shape"][4]["compiles"] == 1


def test_host_only_classifier_prepares_but_cannot_dispatch():
    host = BatchClassifier(device=None)
    assert host.tensors is None and host.device is None
    prepared = prepared_with_todo(host, 3)
    with pytest.raises(RuntimeError, match="host-only"):
        host.dispatch_chunks_async(prepared)
    empty = host.prepare_batch([b"Copyright (c) 2020 Foo"])
    fut = host.dispatch_chunks_async(empty)
    assert isinstance(fut, DeviceFuture) and fut.result() == []


def test_produce_batch_read_hook_and_stage_seconds():
    """A read hook addresses blobs by (path, index): bytes, None (a
    read_error row) or a SkippedBlob (a row with its reason); a repeat
    in the batch is marked against its first row, and a cached row comes
    back rendered."""
    from licensee_tpu_torch.ingest import SkippedBlob
    from licensee_tpu_torch.serve.featurize import (
        IN_BATCH_DUP,
        jsonl_row,
        produce_batch,
    )

    mit = b"Copyright (c) 2020 Foo"
    blobs = [mit, None, SkippedBlob(), mit, b"Some other text"]
    chunk = [f"d{i}/LICENSE" for i in range(len(blobs))]
    clf = BatchClassifier(device=None)
    cached = BlobResult("mit", "dice", 98.5, 197, 200)
    cache = {content_key("license", "LICENSE", b"Some other text"): cached}
    (read_errs, keys, preset, dup_of, routes, prepared, kept, pre_rows,
     (read_s, feat_s)) = produce_batch(
        clf, chunk, "license", True, cache=cache,
        read=lambda path, i: blobs[i])
    assert routes is None and kept is None  # no auto mode, no attribution
    assert read_errs == [None, "read_error", "oversized", None, None]
    assert keys[1] is keys[2] is None and keys[0] == keys[3]
    assert dup_of == {3: 0} and preset[3] is IN_BATCH_DUP
    assert preset[4] is cached
    assert pre_rows == [None] * 4 + [jsonl_row(chunk[4], cached, None)]
    assert prepared.results[0].matcher == "copyright"
    assert read_s >= 0 and feat_s > 0
