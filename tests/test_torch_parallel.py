"""The port's scale-out pieces against the JAX package's, on the CPU.

* K5, `licensee_tpu_torch/parallel/mesh.py`: `make_sharded_scorer` over
  (data, model) meshes that repeat the CPU device, against
  `licensee_tpu.parallel.mesh.make_sharded_scorer` on the 8 virtual CPU
  devices `tests/conftest.py` gives JAX, at T=47 (the vendored corpus)
  and T=608 (W=132: the model axis pads each lane slice), top-1 and
  top-3, triples bit-identical; the batch split unevenly; the refusals.
* `BatchClassifier(lanes=2)` and `(mesh=(2, 2))` rows against the JAX
  package's.
* `parallel/distributed.py`: a real 2-process gloo handshake whose
  shards equal a real 2-process `jax.distributed` run's; the chip
  partition over a dict env.
* `parallel/autoscale.py`: decisions and `capacity_plan` over one gauge
  series, equal to the JAX package's.
* `batch-detect --stats-file`/`--prom-file`/`--progress` against the
  JAX CLI's (time fields excluded by name); `obs.merge_expositions`.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licensee_tpu.kernels import dice_xla
from licensee_tpu.parallel import autoscale as jax_autoscale
from licensee_tpu.parallel import mesh as jax_mesh
from licensee_tpu_torch.corpus.compiler import default_corpus
from licensee_tpu_torch.kernels import dice_cuda
from licensee_tpu_torch.kernels.dice_ref import CorpusTensors
from licensee_tpu_torch.parallel import autoscale, mesh
from licensee_tpu_torch.parallel.distributed import (
    apply_visible_chips,
    chips_for_worker,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("bits", "n_wf", "n_fieldset", "field_count", "alt_count",
          "length", "cc_flag")
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)]


def corpus_arrays(T: int) -> dict:
    """numpy corpus columns: the vendored corpus at T=47, a seeded
    random one of W=132 lanes at T=608."""
    if T == 47:
        c = default_corpus()
        return {n: np.asarray(getattr(c, n)) for n in FIELDS}
    rng = np.random.default_rng(608)
    W = 132
    return {
        "bits": rng.integers(0, 2**32, (T, W), dtype=np.uint32)
        & rng.integers(0, 2**32, (T, W), dtype=np.uint32),
        "n_wf": rng.integers(200, 2000, T).astype(np.int32),
        "n_fieldset": rng.integers(0, 6, T).astype(np.int32),
        "field_count": rng.integers(0, 8, T).astype(np.int32),
        "alt_count": rng.integers(0, 4, T).astype(np.int32),
        "length": rng.integers(1000, 40000, T).astype(np.int32),
        "cc_flag": rng.random(T) < 0.1,
    }


def features(arrays: dict, B: int, seed: int):
    """Blobs: copies of templates (ties across equal templates), random
    bits, and rows under the CC flag."""
    rng = np.random.default_rng(seed)
    bits = arrays["bits"]
    T, W = bits.shape
    fb = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
    src = rng.integers(0, T, B)
    fb[::2] = bits[src[::2]]
    n_words = rng.integers(50, 3000, B).astype(np.int32)
    n_words[::2] = arrays["n_wf"][src[::2]]
    lengths = rng.integers(100, 60000, B).astype(np.int32)
    return fb, n_words, lengths, rng.random(B) < 0.3


def port_corpus(arrays) -> CorpusTensors:
    T = arrays["bits"].shape[0]
    return CorpusTensors(
        bits=torch.from_numpy(arrays["bits"].view(np.int32).copy()),
        **{n: torch.from_numpy(np.ascontiguousarray(arrays[n]))
           for n in FIELDS[1:]},
        valid=torch.ones(T, dtype=torch.bool),
    )


def jax_corpus(arrays) -> dice_xla.CorpusArrays:
    T = arrays["bits"].shape[0]
    return dice_xla.CorpusArrays(
        **{n: jnp.asarray(arrays[n]) for n in FIELDS},
        valid=jnp.ones(T, bool))


@pytest.mark.parametrize("T", [47, 608])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k5_matches_jax_mesh(T, shape):
    arrays = corpus_arrays(T)
    feats = features(arrays, 64, T + shape[0] * 10 + shape[1])
    jmesh = jax_mesh.build_mesh(*shape)
    want = jax_mesh.make_sharded_scorer(
        jax_corpus(arrays), jmesh, method="popcount", topk=3)(
        *jax_mesh.shard_batch(jmesh, *(jnp.asarray(f) for f in feats)))
    want = [np.asarray(w) for w in want]
    pmesh = mesh.build_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    ct = port_corpus(arrays)
    tensors = (torch.from_numpy(feats[0].view(np.int32)),
               *(torch.from_numpy(f) for f in feats[1:]))
    for topk, n_out in ((0, 3), (3, 6)):
        got = mesh.make_sharded_scorer(ct, pmesh, "popcount", topk)(*tensors)
        assert len(got) == n_out
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_k5_routes_and_uneven_shards():
    """One model shard runs the unsharded scorer per data row (K1's
    `best_match_fused` or `topk_fused`); several run K2 per (row, model
    shard), then the algebra and the first-max or `topk_exact`.  A batch
    the rows do not divide gives a short last shard (here one row over
    two rows of the mesh: an empty one).  The launches per shard are
    counted on the card (tests/test_torch_cuda.py)."""
    arrays = corpus_arrays(47)
    ct = port_corpus(arrays)
    feats = features(arrays, 7, 1)
    tensors = (torch.from_numpy(feats[0].view(np.int32)),
               *(torch.from_numpy(f) for f in feats[1:]))
    single = dice_cuda.BestMatchScorer(ct, "popcount")._best(*tensors)
    for shape, topk, route in (
        ((2, 1), 0, "K5 mesh 2x1 over K1"),
        ((2, 1), 3, "K5 mesh 2x1 over K1, top-k (k=3)"),
        ((2, 2), 0, "K5 mesh 2x2 over K2 lane slices"),
        ((2, 2), 3, "K5 mesh 2x2 over K2 lane slices, top-k (k=3)"),
        ((4, 1), 0, "K5 mesh 4x1 over K1"),
    ):
        pmesh = mesh.build_mesh(*shape, devices=["cpu"] * 8)
        fn = mesh.make_sharded_scorer(ct, pmesh, "popcount", topk)
        assert fn.route == route
        got = fn(*tensors)
        for g, s in zip(got[:3], single):
            assert torch.equal(g, s)
    one = tuple(t[:1] for t in tensors)
    got = mesh.make_sharded_scorer(
        ct, mesh.build_mesh(2, 1, devices=["cpu"] * 2))(*one)
    assert [g.tolist() for g in got] == [s[:1].tolist() for s in single]


def test_k5_refusals_match_jax():
    arrays = corpus_arrays(47)  # W=112: a model axis of 3 does not divide
    with pytest.raises(Exception):
        jmesh = jax_mesh.build_mesh(1, 3)
        feats = features(arrays, 8, 0)
        jax_mesh.make_sharded_scorer(jax_corpus(arrays), jmesh)(
            *jax_mesh.shard_batch(jmesh, *(jnp.asarray(f) for f in feats)))
    with pytest.raises(ValueError, match="must divide"):
        mesh.make_sharded_scorer(port_corpus(arrays),
                                 mesh.build_mesh(1, 3, devices=["cpu"] * 3))
    for m in (jax_mesh, mesh):
        with pytest.raises(ValueError, match="unknown scoring method"):
            m.make_sharded_scorer(
                jax_corpus(arrays) if m is jax_mesh else port_corpus(arrays),
                m.build_mesh(1, 1) if m is jax_mesh
                else mesh.build_mesh(1, 1, devices=["cpu"]),
                method="pallas")
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh.build_mesh(2, 2, devices=["cpu"])


# -- BatchClassifier over lanes and a mesh --


def blobs():
    import glob

    files = sorted(glob.glob(os.path.join(REPO, "tests", "fixtures", "*",
                                          "LICENSE*")))[:20]
    return [open(p, "rb").read() for p in files] + [b"no license here"]


@pytest.mark.parametrize("kw", [{"lanes": 2}, {"mesh": (2, 2)},
                                {"mesh": (2, 1), "closest": 3}],
                         ids=["lanes2", "mesh2x2", "mesh2x1-closest3"])
def test_batch_classifier_rows_match_jax(kw):
    from licensee_tpu.kernels.batch import BatchClassifier as JaxClassifier
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    contents = blobs()
    want = JaxClassifier(pad_batch_to=8, **kw).classify_blobs(contents)
    clf = BatchClassifier(pad_batch_to=8, device="cpu", **kw)
    if "lanes" in kw:
        assert len(clf._lanes) == 2 and clf.mesh is None
    else:
        assert clf.mesh.shape == {"data": kw["mesh"][0],
                                  "model": kw["mesh"][1]}
    got = clf.classify_blobs(contents)
    assert [g.as_dict() for g in got] == [w.as_dict() for w in want]


def test_batch_classifier_refusals_match_jax():
    from licensee_tpu.kernels.batch import BatchClassifier as JaxClassifier
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    for kw in ({"lanes": 2, "mesh": (2, 1)},
               {"lanes": 2, "method": "pallas"},
               {"mesh": (2, 1), "method": "pallas"},
               {"mesh": (3, 1)},
               {"mode": "package", "mesh": (2, 1)}):
        with pytest.raises(ValueError) as want:
            JaxClassifier(pad_batch_to=8, **kw)
        with pytest.raises(ValueError) as got:
            BatchClassifier(pad_batch_to=8, device="cpu", **kw)
        assert str(got.value) == str(want.value), kw


# -- the multi-process bootstrap --


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_world_matches_jax_cluster(tmp_path):
    """Two port processes join one gloo world through the coordinator
    and each writes its stripe's shard; so do two JAX processes through
    `jax.distributed`.  The shards are the same bytes, and together the
    unstriped run's."""
    import glob

    files = sorted(glob.glob(os.path.join(REPO, "tests", "fixtures", "*",
                                          "LICENSE*")))[:9]
    manifest = tmp_path / "m.txt"
    manifest.write_text("\n".join(files) + "\n")
    procs = []
    for pkg, extra in (("licensee_tpu_torch", ["--device", "cpu"]),
                       ("licensee_tpu", ["--mesh", "none"])):
        port = _free_port()
        for rank in (0, 1):
            env = {
                **os.environ,
                "JAX_PLATFORMS": "cpu",
                "PYTHONPATH": REPO,
                "LICENSEE_TPU_COORDINATOR": f"127.0.0.1:{port}",
                "LICENSEE_TPU_NUM_PROCESSES": "2",
                "LICENSEE_TPU_PROCESS_ID": str(rank),
            }
            procs.append(subprocess.Popen(
                [sys.executable, "-m", f"{pkg}.cli.main", "batch-detect",
                 str(manifest), "--output", str(tmp_path / f"{pkg}.jsonl"),
                 "--batch-size", "4", *extra],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    for p in procs:
        _out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
    shards = {}
    for pkg in ("licensee_tpu_torch", "licensee_tpu"):
        shards[pkg] = [
            open(tmp_path / f"{pkg}.jsonl.shard-{i:05d}-of-00002",
                 "rb").read()
            for i in (0, 1)
        ]
    assert shards["licensee_tpu_torch"] == shards["licensee_tpu"]
    from licensee_tpu_torch.cli.main import main as port_main

    single = tmp_path / "single.jsonl"
    assert port_main(["batch-detect", str(manifest), "--output",
                      str(single), "--batch-size", "4", "--device",
                      "cpu"]) == 0
    assert b"".join(shards["licensee_tpu_torch"]) == single.read_bytes()


def test_chip_partition_on_a_dict_env():
    before = dict(os.environ)
    env = {"LICENSEE_TPU_VISIBLE_CHIPS": " 2, 3 "}
    assert apply_visible_chips(env) == ["2", "3"]
    assert env["CUDA_VISIBLE_DEVICES"] == "2,3"
    assert dict(os.environ) == before
    with pytest.raises(RuntimeError, match="conflicts"):
        apply_visible_chips({"LICENSEE_TPU_VISIBLE_CHIPS": "0",
                             "CUDA_VISIBLE_DEVICES": "1"})
    with pytest.raises(ValueError, match="no chip ids"):
        apply_visible_chips({"LICENSEE_TPU_VISIBLE_CHIPS": " , "})
    assert apply_visible_chips({}) is None
    assert chips_for_worker(2, 3) == ["6", "7", "8"]


# -- the autoscaler --


def test_autoscale_decisions_match_jax():
    rng = np.random.default_rng(5)
    series = np.concatenate([np.full(12, 0.95), rng.random(30),
                             np.full(12, 0.1), [np.nan] * 3,
                             np.full(8, 0.9)])
    kw = dict(min_units=1, max_units=4, up_at=0.8, down_at=0.3,
              confirm_ticks=2, cooldown_s=1.5, payoff_min=0.1)
    got, want = [], []
    for mod, out in ((autoscale, got), (jax_autoscale, want)):
        decider = mod.AutoscaleDecider(mod.AutoscaleConfig(**kw), 1)
        for i, p in enumerate(series):
            pressure = None if np.isnan(p) else float(p)
            out.append(decider.observe(0.5 * i, pressure,
                                       throughput=100.0 + (i % 7)))
        out.append(decider.units)
    assert got == want and any(d is not None for d in got)
    for units in range(1, 20):
        for max_stripes in (1, 3, 8):
            for base in (0, 2):
                assert autoscale.capacity_plan(
                    units, max_stripes=max_stripes,
                    base_featurize_procs=base,
                ) == jax_autoscale.capacity_plan(
                    units, max_stripes=max_stripes,
                    base_featurize_procs=base)


# -- the run's files --


TIME_KEYS = ("stage_seconds", "pipeline")
# the port's --stats line has carried the device rows and the dispatch
# split since its fourth slice; they are not in the JAX package's
PORT_KEYS = ("device_rows", "dispatch")


def _samples(text: str, family: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith(family + "{") or line.startswith(family + " "):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def test_stats_prom_and_progress_files_match_jax(tmp_path, capsys):
    from licensee_tpu.cli.main import main as jax_main
    from licensee_tpu.obs import check_exposition as jax_check
    from licensee_tpu_torch.cli.main import main as port_main
    from licensee_tpu_torch.obs import check_exposition

    import glob

    files = sorted(glob.glob(os.path.join(REPO, "tests", "fixtures", "*",
                                          "LICENSE*")))[:12]
    big = tmp_path / "LICENSE.big"
    big.write_bytes(b"MIT License\n" * 6000)  # skipped: past the cap
    manifest = tmp_path / "m.txt"
    manifest.write_text("\n".join(files + [str(big), files[0]]) + "\n")
    got = {}
    for name, main, extra in (("jax", jax_main, ["--mesh", "none"]),
                              ("port", port_main, ["--device", "cpu"])):
        capsys.readouterr()
        out = tmp_path / f"{name}.jsonl"
        assert main(["batch-detect", str(manifest), "--output", str(out),
                     "--batch-size", "4", "--progress", "0.000001",
                     "--stats-file", str(tmp_path / f"{name}.stats"),
                     "--prom-file", str(tmp_path / f"{name}.prom"),
                     *extra]) == 0
        progress = [json.loads(line) for line in
                    capsys.readouterr().err.splitlines()
                    if line.startswith('{"progress"')]
        stats = json.loads((tmp_path / f"{name}.stats").read_text())
        prom = (tmp_path / f"{name}.prom").read_text()
        got[name] = (out.read_bytes(), stats, prom, progress)
    jrows, jstats, jprom, jprog = got["jax"]
    prows, pstats, pprom, pprog = got["port"]
    assert prows == jrows
    assert set(pstats) - set(PORT_KEYS) == set(jstats)
    for key in jstats:
        if key not in TIME_KEYS:
            assert pstats[key] == jstats[key], key
    assert set(pstats["stage_seconds"]) == set(jstats["stage_seconds"])
    assert set(pstats["pipeline"]) == set(jstats["pipeline"])
    assert check_exposition(pprom) == [] and jax_check(jprom) == []
    assert _samples(pprom, "batch_rows") == _samples(jprom, "batch_rows")
    assert (set(_samples(pprom, "batch_stage_seconds"))
            == set(_samples(jprom, "batch_stage_seconds")))
    for family in ("pipeline_featurize_busy", "pipeline_device_busy",
                   "pipeline_writer_busy"):
        assert _samples(pprom, family) and _samples(jprom, family)
    assert jprog and pprog
    assert [set(p) for p in pprog] == [set(p) for p in jprog[:len(pprog)]]
    assert set(pprog[0]) == {"progress", "of", "files_per_sec",
                             "dedupe_hits"}


def test_merge_expositions_matches_jax():
    from licensee_tpu.obs import merge_expositions as jax_merge
    from licensee_tpu_torch.obs import merge_expositions

    parts = {
        "stripe0": "# HELP x_total X\n# TYPE x_total counter\n"
                   "x_total 3\nx_total{k=\"a\"} 1\n",
        "stripe1": "# HELP x_total X\n# TYPE x_total counter\n"
                   "x_total 4\n# TYPE g gauge\ng 0.5\n",
    }
    assert merge_expositions(parts, label="stripe") == jax_merge(
        parts, label="stripe")


def test_profile_writes_a_torch_profiler_trace(tmp_path, capsys):
    """`--profile DIR` writes a torch.profiler trace of the run; a striped
    run refuses it, as the JAX CLI does."""
    from licensee_tpu_torch.cli.main import main as port_main

    manifest = tmp_path / "m.txt"
    manifest.write_text(os.path.join(REPO, "tests", "fixtures", "mit",
                                     "LICENSE.txt") + "\n")
    prof = tmp_path / "prof"
    assert port_main(["batch-detect", str(manifest), "--output",
                      str(tmp_path / "o.jsonl"), "--device", "cpu",
                      "--profile", str(prof)]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    assert port_main(["batch-detect", str(manifest), "--output",
                      str(tmp_path / "s.jsonl"), "--stripes", "1",
                      "--profile", str(prof)]) == 1
    assert "--profile traces one process" in capsys.readouterr().err
