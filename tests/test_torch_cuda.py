"""The port on the card: both CUDA kernels against their plain versions,
and `batch-detect` through each kernel against the `--device cpu` run,
over the vendored corpus and over a synthetic SPDX directory.

These need a CUDA device and skip elsewhere.  They import neither JAX nor
the JAX package, so they run on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import os

import numpy as np
import pytest
import torch

from licensee_tpu_torch import convert
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.corpus.compiler import default_corpus
from licensee_tpu_torch.corpus.spdx_synth import synth_spdx_dir
from licensee_tpu_torch.kernels import dice_cuda, dice_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the machine with the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("B", [1, 1000, 4096])
def test_kernels_match_plain_versions(card, B):
    ct = convert.corpus_tensors(default_corpus(), card)
    rng = np.random.default_rng(B)
    W = ct.bits.shape[1]
    feats = (
        torch.from_numpy(
            rng.integers(0, 2**32, (B, W), dtype=np.uint32).view(np.int32)
        ).to(card),
        torch.from_numpy(rng.integers(0, 3000, B).astype(np.int32)).to(card),
        torch.from_numpy(rng.integers(0, 60000, B).astype(np.int32)).to(card),
        torch.from_numpy(rng.random(B) < 0.2).to(card),
    )
    meta = dice_cuda.pack_meta(ct)
    got = dice_cuda.score_pairs_fused(meta, ct.bits, *feats)
    want = dice_cuda.score_pairs_fused_plain(meta, ct.bits, *feats)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tpl = dice_cuda.pack_templates_mma(ct)
    assert torch.equal(
        dice_cuda.overlap_pairs_mma(tpl, feats[0], ct.n_templates),
        dice_cuda.overlap_pairs_mma_plain(tpl, feats[0], ct.n_templates),
    )


@pytest.mark.parametrize("W", [4, 112, 132])
@pytest.mark.parametrize("T", [1, 8, 47, 48, 49, 608])
@pytest.mark.parametrize("B", [1, 63, 64, 65, 4097])
def test_mma_kernel_matches_plain_at_ragged_shapes(card, B, T, W):
    """K2 on random bits at ragged B, T and W, with the V stages split
    over blocks (small grids) and not (B=4097 at T=608)."""
    rng = np.random.default_rng(B * 1000 + T * 10 + W)
    bits = torch.from_numpy(
        rng.integers(0, 2**32, (T, W), dtype=np.uint32).view(np.int32)).to(card)
    fb = torch.from_numpy(
        rng.integers(0, 2**32, (B, W), dtype=np.uint32).view(np.int32)).to(card)
    zeros = torch.zeros(T, dtype=torch.int32, device=card)
    ct = dice_ref.CorpusTensors(bits, zeros, zeros, zeros, zeros, zeros,
                                zeros.bool(), ~zeros.bool())
    tpl = dice_cuda.pack_templates_mma(ct)
    got = dice_cuda.overlap_pairs_mma(tpl, fb, T)
    want = dice_cuda.overlap_pairs_mma_plain(tpl, fb, T)
    assert torch.equal(got, want)
    n_sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits = dice_cuda.mma_schedule(B, T, W, n_sms)[1]
    if (B, T, W) == (4097, 608, 132):
        assert splits == 1
    if (B, T, W) == (1, 47, 112):
        assert splits > 1


def k1_case(card, rng, B, T, W, valid_p=0.95, cc_p=0.1):
    """Seeded K1 inputs on the card: random bitsets, a meta table with
    some invalid and some CC templates, and blob columns."""
    bits = rng.integers(0, 2**32, (T, W), dtype=np.uint32)
    fb = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
    meta = np.zeros((T, dice_cuda.META_COLS), np.int32)
    meta[:, dice_cuda.N_WF] = rng.integers(50, 3000, T)
    meta[:, dice_cuda.N_FIELDSET] = rng.integers(0, 4, T)
    meta[:, dice_cuda.FIELD_COUNT] = rng.integers(0, 6, T)
    meta[:, dice_cuda.ALT_COUNT] = rng.integers(0, 40, T)
    meta[:, dice_cuda.LENGTH] = rng.integers(100, 60000, T)
    meta[:, dice_cuda.CC_FLAG] = rng.random(T) < cc_p
    meta[:, dice_cuda.VALID] = rng.random(T) < valid_p

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    return (dev(meta), dev(bits.view(np.int32)), dev(fb.view(np.int32)),
            dev(rng.integers(0, 3000, B).astype(np.int32)),
            dev(rng.integers(0, 60000, B).astype(np.int32)),
            dev(rng.random(B) < 0.3))


def assert_k1_matches_plain(args):
    got = dice_cuda.best_match_fused(*args)
    want = dice_cuda.best_match_fused_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    planes = dice_cuda.score_pairs_fused(*args)
    for a, b in zip(planes, dice_cuda.score_pairs_fused_plain(*args)):
        assert torch.equal(a, b)
    # every launch leaves its stream's tickets zero
    assert not dice_cuda._tickets(args[0].device, 1).any()
    return got


@pytest.mark.parametrize("W", [4, 112, 132])
@pytest.mark.parametrize("T", [1, 47, 63, 608])
@pytest.mark.parametrize("B", [1, 347, 1565, 4097])
def test_fused_k1_matches_plain_at_ragged_shapes(card, B, T, W):
    """K1's best and planes epilogues on random bits at ragged B, T and W,
    with the templates split over blocks (small B) and not."""
    args = k1_case(card, np.random.default_rng(B * 1000 + T * 10 + W),
                   B, T, W)
    dice_cuda._tickets(args[0].device, 1)  # checked below, even unsplit
    before = dice_cuda.LAUNCHES["best_match_fused"]
    assert_k1_matches_plain(args)
    assert dice_cuda.LAUNCHES["best_match_fused"] == before + 1


@pytest.mark.parametrize("B, T", [(347, 608), (4096, 47), (33, 200)])
def test_fused_k1_ties_and_exclusions(card, B, T):
    """Blobs equal to templates whose every slice of the kernel's split
    repeats the first (exact ties across split boundaries, which the
    lowest index must win), and rows where every template is excluded
    (the CC guard, invalid templates)."""
    rng = np.random.default_rng(T + B)
    meta, bits, *_ = k1_case(card, rng, B, T, 132)
    n_sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits, per_split, _ = dice_cuda.fused_schedule(B, T, 132, n_sms)
    assert splits > 1
    # template t repeats template t mod per_split, rounded down to even:
    # ties inside a slice and across every split boundary
    dup = (torch.arange(T, device=card) % per_split) // 2 * 2
    bits = bits[dup].contiguous()
    meta = meta[dup].contiguous()
    meta[:, dice_cuda.VALID] = 1
    meta[:, dice_cuda.CC_FLAG] = 0
    src = torch.from_numpy(rng.integers(0, T, B)).to(card)
    fb = bits[src].contiguous()
    nw = meta[src, dice_cuda.N_WF].contiguous()
    ln = meta[src, dice_cuda.LENGTH].contiguous()
    cf = torch.zeros(B, dtype=torch.bool, device=card)
    cf[::3] = True
    idx, num, den = assert_k1_matches_plain((meta, bits, fb, nw, ln, cf))
    assert (idx < per_split).all() and (idx % 2 == 0).all()
    assert (num >= 0).all()
    # every template CC: the flagged rows have nothing left
    meta_cc = meta.clone()
    meta_cc[:, dice_cuda.CC_FLAG] = 1
    idx, num, den = assert_k1_matches_plain((meta_cc, bits, fb, nw, ln, cf))
    assert (idx[cf] == 0).all() and (num[cf] == -1).all()
    assert (den[cf] == 1).all() and (num[~cf] >= 0).all()
    meta_cc[:, dice_cuda.VALID] = 0
    idx, num, den = assert_k1_matches_plain((meta_cc, bits, fb, nw, ln, cf))
    assert (idx == 0).all() and (num == -1).all() and (den == 1).all()


# the batches `detect`'s DiceXLA matcher (one file a call) and small
# stdout `batch-detect` runs give K1: far below a 64-row block, where the
# template splits fill the card and one ticket serves the split merge
DETECT_B = [1, 2, 7, 8, 9, 16, 17, 63, 64, 65]


@pytest.mark.parametrize("T, W", [(47, 112), (608, 132)])
@pytest.mark.parametrize("B", DETECT_B)
def test_fused_k1_at_detect_batches(card, B, T, W):
    """K1's first-max against its plain version at the small batches, on
    random bits, on blobs that are copies of templates (exact ties across
    the split boundaries), and with every template excluded (the CC
    guard on flagged rows, then no valid template at all)."""
    k1_small_batch_cases(card, B, T, W)


# the flush sizes of `serve` around its schedule's changes at T=608: one
# 64-row tile more at 128, 192 and 256, and 76 splits of 8 templates up
# to B=192, 38 of 16 from B=193 (with a partial last tile below 256)
SERVE_B = [127, 128, 129, 192, 193, 255, 256]


@pytest.mark.parametrize("T, W", [(47, 112), (608, 132)])
@pytest.mark.parametrize("B", SERVE_B)
def test_fused_k1_at_serve_flush_sizes(card, B, T, W):
    """K1's first-max at the flush sizes the serve micro-batcher launches
    it at (its real row count, 1 to 256), random and ties, as at the
    detect batches."""
    n_sms = torch.cuda.get_device_properties(card).multi_processor_count
    if (T, n_sms) == (608, 132):
        splits, per_split, _ = dice_cuda.fused_schedule(B, T, W, n_sms)
        assert (splits, per_split) == ((76, 8) if B <= 192 else (38, 16))
    k1_small_batch_cases(card, B, T, W)


def k1_small_batch_cases(card, B, T, W):
    rng = np.random.default_rng(B * 10 + T)
    args = k1_case(card, rng, B, T, W)
    n_sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits, per_split, _ = dice_cuda.fused_schedule(B, T, W, n_sms)
    assert splits > 1
    assert_k1_matches_plain(args)
    meta, bits, _fb, _nw, ln, _cf = args
    dup = (torch.arange(T, device=card) % per_split) // 2 * 2
    bits = bits[dup].contiguous()
    meta = meta[dup].contiguous()
    meta[:, dice_cuda.VALID] = 1
    meta[:, dice_cuda.CC_FLAG] = 1
    src = torch.from_numpy(rng.integers(0, T, B)).to(card)
    fb = bits[src].contiguous()
    nw = meta[src, dice_cuda.N_WF].contiguous()
    cf = torch.zeros(B, dtype=torch.bool, device=card)
    cf[::2] = True
    idx, num, den = assert_k1_matches_plain((meta, bits, fb, nw, ln, cf))
    assert (idx[cf] == 0).all() and (num[cf] == -1).all()
    assert (den[cf] == 1).all() and (idx[~cf] % 2 == 0).all()
    meta[:, dice_cuda.VALID] = 0
    idx, num, den = assert_k1_matches_plain((meta, bits, fb, nw, ln, cf))
    assert (idx == 0).all() and (num == -1).all() and (den == 1).all()


def test_dice_xla_on_the_card_matches_dice(card):
    """The DiceXLA matcher on the card (its default device) gives the
    scalar Dice's (key, confidence) on every fixture's license file, one
    `best_match_fused` launch a file."""
    from licensee_tpu_torch.matchers import Dice, DiceXLA, dice_xla_matcher
    from licensee_tpu_torch.projects import FSProject

    dice_xla_matcher.use_device("cuda")
    dice_cuda.reset_launches()
    n_files = 0
    for name in sorted(os.listdir(FIXTURES)):
        if not os.path.isdir(os.path.join(FIXTURES, name)):
            continue
        lf = FSProject(os.path.join(FIXTURES, name), detect_packages=False,
                       detect_readme=False).license_file
        if lf is None:
            continue
        dice, xla = Dice(lf), DiceXLA(lf)
        assert (xla.match, xla.confidence) == (dice.match, dice.confidence)
        n_files += 1
    assert n_files > 40
    assert dice_cuda.LAUNCHES["best_match_fused"] == n_files
    assert dice_xla_matcher._shared_classifier().device.type == "cuda"


def test_wrappers_refuse_what_the_kernels_cannot_take(card):
    ct = convert.corpus_tensors(default_corpus(), card)
    meta = dice_cuda.pack_meta(ct)
    fb = ct.bits[:, :-1].contiguous()  # W not a multiple of 4
    ones = torch.ones(fb.shape[0], dtype=torch.int32, device=card)
    flags = torch.zeros(fb.shape[0], dtype=torch.bool, device=card)
    with pytest.raises(ValueError):
        dice_cuda.score_pairs_fused(meta, ct.bits, fb, ones, ones, flags)
    with pytest.raises(TypeError):
        dice_cuda.score_pairs_fused(
            meta, ct.bits, ct.bits, ones.float(), ones, flags)
    with pytest.raises(ValueError, match="multiple of 4"):
        dice_cuda.overlap_pairs_mma(
            dice_cuda.pack_templates_mma(ct), fb, ct.n_templates)
    B, W = 5, ct.bits.shape[1]
    cols = (ones[:B], ones[:B], flags[:B])
    good = ct.bits[:B].contiguous()
    with pytest.raises(ValueError, match="multiple of 4"):
        dice_cuda.best_match_fused(meta, fb, fb[:B].contiguous(), *cols)
    shifted = torch.empty(B * W + 1, dtype=torch.int32, device=card)[1:]
    shifted = shifted.view(B, W)  # 4 bytes past a 16-byte boundary
    shifted.copy_(good)
    with pytest.raises(ValueError, match="aligned"):
        dice_cuda.best_match_fused(meta, ct.bits, shifted, *cols)
    with pytest.raises(TypeError):
        dice_cuda.best_match_fused(meta, ct.bits, good.float(), *cols)
    with pytest.raises(TypeError):
        dice_cuda.best_match_fused(meta, ct.bits, good, ones[:B],
                                   ones[:B], ones[:B])
    with pytest.raises(ValueError, match="on cpu"):
        dice_cuda.best_match_fused(meta, ct.bits, good, ones[:B].cpu(),
                                   ones[:B], flags[:B])
    with pytest.raises(ValueError, match="at least one template"):
        dice_cuda.best_match_fused(meta[:0], ct.bits[:0], good, *cols)


def test_batch_detect_corpus_dir_on_the_card_matches_cpu(card, tmp_path):
    """`batch-detect --corpus DIR` over a 300-template synthetic SPDX
    directory (two 208-wide K2 tiles) on the card and on the CPU."""
    import chip_smoke

    spdx_dir = synth_spdx_dir(str(tmp_path / "src"), 300, seed=1)
    manifest = chip_smoke.write_spdx_manifest(np, str(tmp_path / "rows"),
                                              spdx_dir, seed=2, n_files=400)
    for method, kernel in (("pallas", "best_match_fused"),
                           ("pallas-mxu", "overlap_pairs_mma")):
        outs = []
        for device in ("cpu", "cuda"):
            dice_cuda.reset_launches()
            out = tmp_path / f"{method}.{device}.jsonl"
            assert port_main(["batch-detect", manifest, "--output", str(out),
                              "--corpus", spdx_dir, "--method", method,
                              "--device", device]) == 0
            outs.append(out.read_bytes())
        assert dice_cuda.LAUNCHES[kernel] > 0
        assert outs[0] == outs[1]


def test_batch_detect_on_the_card_matches_cpu(card, tmp_path):
    paths = sorted(
        os.path.join(d, f)
        for d, _dirs, files in os.walk(FIXTURES)
        if os.path.relpath(d, FIXTURES).split(os.sep)[0] != "analysis"
        for f in files
        if not f.endswith((".json", ".yml"))
    )
    manifest = tmp_path / "manifest.txt"
    manifest.write_text("\n".join(paths) + "\n", encoding="utf-8")
    for method, kernel in (("pallas", "best_match_fused"),
                           ("pallas-mxu", "overlap_pairs_mma")):
        outs = []
        for device in ("cpu", "cuda"):
            dice_cuda.reset_launches()
            out = tmp_path / f"{method}.{device}.jsonl"
            assert port_main(["batch-detect", str(manifest), "--output",
                              str(out), "--method", method,
                              "--device", device]) == 0
            outs.append(out.read_bytes())
        assert dice_cuda.LAUNCHES[kernel] > 0
        assert outs[0] == outs[1]


# -- the asynchronous dispatch: pinned staging, one stream, the future ----


def dispatchable(clf, n, seed):
    """A prepared batch of ``n`` Dice-bound rows of seeded features."""
    from licensee_tpu_torch.kernels.batch import PreparedBatch

    rng = np.random.default_rng(seed)
    W = clf.corpus.n_lanes
    return PreparedBatch(
        results=[None] * n,
        bits=rng.integers(0, 2**32, (n, W), dtype=np.uint32),
        n_words=rng.integers(0, 3000, n).astype(np.int32),
        lengths=rng.integers(0, 60000, n).astype(np.int32),
        cc_fp=rng.random(n) < 0.2,
        todo=list(range(n)),
    )


@pytest.fixture()
def launch_streams(monkeypatch):
    """The raw stream every kernel launch went to, meanwhile."""
    seen = []
    launch = dice_cuda._launch

    def recorded(dev, entry, *args):
        seen.append(torch._C._cuda_getCurrentRawStream(dev.index))
        return launch(dev, entry, *args)

    monkeypatch.setattr(dice_cuda, "_launch", recorded)
    return seen


@pytest.mark.parametrize("method", ["pallas", "pallas-mxu"])
def test_groups_in_flight_match_sync_and_plain(card, launch_streams, method):
    """Six groups of two chunks in flight at once, awaited in order: the
    same (idx, num, den) as the synchronous dispatch and the plain
    scorer on the CPU, every launch on the device's dispatch stream."""
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    clf = BatchClassifier(method=method, pad_batch_to=1000, device="cuda")
    cpu = BatchClassifier(method=method, pad_batch_to=1000, device="cpu")
    batches = [dispatchable(clf, 1500 + 37 * k, k) for k in range(6)]
    futures = [clf.dispatch_chunks_async(p) for p in batches]
    for fut, p in zip(futures, batches):
        got = fut.result()
        for out_got, out_sync, out_cpu in zip(
                got, clf.dispatch_chunks(p), cpu.dispatch_chunks(p)):
            assert out_got[0] == out_sync[0] == out_cpu[0]
            for a, b, c in zip(out_got[1], out_sync[1], out_cpu[1]):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
    stream = dice_cuda.dispatch_stream(card.index or 0).cuda_stream
    assert launch_streams and set(launch_streams) == {stream}
    assert stream != torch.cuda.current_stream().cuda_stream


def test_pinned_slot_released_only_after_its_event(card, monkeypatch):
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    clf = BatchClassifier(pad_batch_to=512, device="cuda")
    pending = {}
    release = clf._staging.release

    def checked(slot):
        assert pending.pop(id(slot)).query(), "slot freed before its event"
        release(slot)

    monkeypatch.setattr(clf._staging, "release", checked)
    futures = []
    for k in range(8):
        fut = clf.dispatch_chunks_async(dispatchable(clf, 1100, k))
        for _chunk, slot, done in fut._parts:
            assert all(t.is_pinned() for t in slot.tensors)
            assert id(slot) not in pending, "a slot in flight was refilled"
            pending[id(slot)] = done
        futures.append(fut)
        if len(futures) > 2:
            futures.pop(0).result()
    for fut in futures:
        fut.result()
    assert not pending


def test_dispatch_stats_one_setup_per_shape(card):
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    clf = BatchClassifier(pad_batch_to=256, device="cuda")
    for k in range(3):
        clf.dispatch_chunks(dispatchable(clf, 600, k))  # 3 chunks each
    stats = clf.dispatch_stats()
    assert stats["compiles"] == 1 and stats["dispatches"] == 8
    assert stats["shapes"] == [256]
    assert stats["per_shape"][256]["compiles"] == 1


def test_pipeline_on_the_card_matches_cpu_at_every_depth(card, tmp_path,
                                                         launch_streams):
    import chip_smoke

    manifest = chip_smoke.write_manifest(np, str(tmp_path / "rows"), 3,
                                         n_files=600)
    outs = {}
    for device, depth, workers in (("cpu", 1, 1), ("cuda", 1, 1),
                                   ("cuda", 2, 8), ("cuda", 4, 3)):
        out = tmp_path / f"{device}.{depth}.jsonl"
        assert port_main(["batch-detect", manifest, "--output", str(out),
                          "--device", device, "--batch-size", "64",
                          "--coalesce-batches", "2",
                          "--pipeline-depth", str(depth),
                          "--workers", str(workers)]) == 0
        outs[device, depth] = out.read_bytes()
    assert len(set(outs.values())) == 1
    assert len(set(launch_streams)) == 1 and len(launch_streams) > 3


# -- serve --------------------------------------------------------------------


def serve_texts(n):
    """``n`` distinct Dice-bound requests: a rendered MIT template with a
    made-up word appended."""
    import re

    from licensee_tpu_torch.corpus.license import License

    body = re.sub(r"\[(\w+)\]", "example", License.find("mit").content)
    return [body + f"\nzqserve{i}\n" for i in range(n)]


def test_serve_on_the_card_matches_cpu(card):
    """A card MicroBatcher at the CLI's defaults (warm start) under 16
    concurrent clients gives the CPU batcher's verdicts, with no
    fallback, and launches `best_match_fused` once per bucket at warm-up
    and once per flush, and nothing else."""
    import threading

    from licensee_tpu_torch.serve.scheduler import MicroBatcher

    texts = serve_texts(2000)
    results = {}
    for device in ("cpu", "cuda"):
        dice_cuda.reset_launches()
        b = MicroBatcher(device=device, warm_start=True)
        warm = dice_cuda.LAUNCHES["best_match_fused"]
        got = [None] * len(texts)

        def client(k, b=b, got=got):
            for i in range(k, len(texts), 16):
                got[i] = b.classify(texts[i], "LICENSE", timeout=120.0)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(16)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300.0)
        finally:
            b.close()
        assert not any(t.is_alive() for t in threads)
        sched = b.stats()["scheduler"]
        assert sched["fallbacks"] == sched["completion_errors"] == 0
        results[device] = [(r.key, r.matcher, r.confidence) for r in got]
        if device == "cuda":
            assert warm == len(b.buckets)
            assert dice_cuda.LAUNCHES["best_match_fused"] == \
                warm + sched["device_batches"]
            assert sum(dice_cuda.LAUNCHES.values()) == \
                dice_cuda.LAUNCHES["best_match_fused"]
            per_shape = b.stats()["device"]["per_shape"]
            assert sorted(per_shape) == list(b.buckets)
            assert all(v["compiles"] == 1 for v in per_shape.values())
    assert results["cuda"] == results["cpu"]


def test_serve_warmup_sets_up_each_bucket_on_the_card(card):
    from licensee_tpu_torch.serve.scheduler import MicroBatcher

    b = MicroBatcher(device="cuda", warm_start=True, max_batch=64)
    try:
        before = b.stats()["device"]
        for text in serve_texts(40):
            b.classify(text, "LICENSE", timeout=60.0)
        after = b.stats()["device"]
    finally:
        b.close()
    assert before["shapes"] == [8, 32, 64] and before["compiles"] == 3
    assert before["dispatches"] == 0
    assert after["compiles"] == 3 and after["dispatches"] > 0


def test_serve_device_failure_on_the_card_is_an_error_row(card):
    """A card batcher whose device submit raises answers a
    ``device_error`` row, counted under ``fallbacks``; it does not score
    on the host, whose verdicts would hide the failing kernel."""
    from licensee_tpu_torch.serve.scheduler import MicroBatcher

    def boom(*_a, **_k):
        raise RuntimeError("injected device failure")

    b = MicroBatcher(device="cuda", warm_start=True, max_batch=64)
    try:
        b.classifier.dispatch_chunks_async = boom
        res = b.classify(serve_texts(1)[0], "LICENSE", timeout=60.0)
        sched = b.stats()["scheduler"]
    finally:
        b.close()
    assert (res.key, res.matcher, res.error) == (
        None, None, "device_error: injected device failure")
    assert (sched["fallbacks"], sched["completion_errors"]) == (1, 0)


def test_validate_classifier_on_the_card(card):
    """The reload gate runs the candidate's real scorer, K1 on the card,
    against the host algebra: a sound classifier passes with one launch,
    one whose matrix on the card was zeroed is refused."""
    from licensee_tpu_torch.kernels.batch import BatchClassifier
    from licensee_tpu_torch.serve import reload

    clf = BatchClassifier(device="cuda", pad_batch_to=256)
    dice_cuda.reset_launches()
    assert reload.validate_classifier(clf) == []
    assert dice_cuda.LAUNCHES["best_match_fused"] == 1
    clf.tensors.bits.zero_()
    problems = reload.validate_classifier(clf)
    assert problems and any("parity probe" in p or "self-probe" in p
                            for p in problems)


# -- K4's top-k and the --closest / mode paths -------------------------------


def random_planes(card, rng, B, T, excluded_p=0.1, tie_every=0):
    """(num, den) planes as the score algebra gives them: num in
    [-1, 3000), den >= 1, some pairs excluded to (-1, 1); with
    ``tie_every`` > 0, template t copies template t mod ``tie_every``
    (exact ties across the lanes' columns)."""
    num = rng.integers(0, 3000, (B, T)).astype(np.int32)
    den = rng.integers(1, 6000, (B, T)).astype(np.int32)
    if tie_every:
        src = np.arange(T) % tie_every
        num, den = num[:, src], den[:, src]
    out = rng.random((B, T)) < excluded_p
    num[out], den[out] = -1, 1
    return (torch.from_numpy(np.ascontiguousarray(num)).to(card),
            torch.from_numpy(np.ascontiguousarray(den)).to(card))


@pytest.mark.parametrize("k", [1, 4, 47])
@pytest.mark.parametrize("T", [1, 31, 47, 608, 7000])
@pytest.mark.parametrize("B", [1, 9, 4096])
def test_topk_matches_plain(card, B, T, k):
    """`topk_exact` against `dice_ref.topk_candidates`, bit for bit, at
    ragged B and T (T=7000: one row a block, over 48 KB of shared
    memory) and at k past T (the repeat rounds)."""
    rng = np.random.default_rng(B * 100 + T + k)
    num, den = random_planes(card, rng, B, T)
    before = dice_cuda.LAUNCHES["topk_exact"]
    got = dice_cuda.topk_exact(num, den, k)
    want = dice_cuda.topk_exact_plain(num, den, k)
    assert dice_cuda.LAUNCHES["topk_exact"] == before + 1
    for a, b in zip(got, want):
        assert a.shape == (B, k) and torch.equal(a, b)


@pytest.mark.parametrize("tie_every", [1, 2, 5])
def test_topk_ties_and_all_excluded_rows(card, tie_every):
    """Exact ties go to the lower index in every round; a row whose
    every entry is excluded gives template 0 at (-1, 1) in every round,
    as the reference's masked rounds do."""
    rng = np.random.default_rng(tie_every)
    num, den = random_planes(card, rng, 300, 608, tie_every=tie_every)
    num[::3], den[::3] = -1, 1
    got = dice_cuda.topk_exact(num, den, 608)
    want = dice_cuda.topk_exact_plain(num, den, 608)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    idx, knum, kden = got
    assert (idx[::3] == 0).all() and (knum[::3] == -1).all()
    assert (kden[::3] == 1).all()


def test_topk_refuses_what_it_cannot_take(card):
    num = torch.zeros((4, 8), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        dice_cuda.topk_exact(num.float(), num, 2)
    with pytest.raises(ValueError):
        dice_cuda.topk_exact(num, num[:, :4].contiguous(), 2)
    with pytest.raises(ValueError, match="k >= 0"):
        dice_cuda.topk_exact(num, num, -1)
    with pytest.raises(ValueError, match="too wide"):
        dice_cuda.topk_schedule(1, 30000, 30000)
    with pytest.raises(ValueError, match="too wide"):
        wide = torch.zeros((1, 30000), dtype=torch.int32, device=card)
        dice_cuda.topk_exact(wide, wide, 17)


@pytest.mark.parametrize("method", ["popcount", "matmul"])
def test_topk_scorer_matches_plain(card, method):
    """The --closest scorer on the card (K1's planes or K2 and the
    algebra, then the top-k) against the same scorer on the CPU: no
    best_match_fused and no argmax."""
    corpus = default_corpus()
    rng = np.random.default_rng(7)
    W = corpus.n_lanes
    feats = (rng.integers(0, 2**32, (1000, W), dtype=np.uint32),
             rng.integers(0, 3000, 1000).astype(np.int32),
             rng.integers(0, 60000, 1000).astype(np.int32),
             rng.random(1000) < 0.2)
    cpu = dice_cuda.make_best_match_fn(
        convert.corpus_tensors(corpus, torch.device("cpu")), method, k=4)
    gpu = dice_cuda.make_best_match_fn(
        convert.corpus_tensors(corpus, card), method, k=4)
    dice_cuda.reset_launches()
    got = gpu(*feats)
    fused = method == "popcount"  # k=4 fuses into K1's epilogue
    assert dice_cuda.LAUNCHES["topk_fused"] == fused
    assert dice_cuda.LAUNCHES["topk_exact"] == (not fused)
    assert dice_cuda.LAUNCHES["score_pairs_fused"] == 0
    assert dice_cuda.LAUNCHES["best_match_fused"] == 0
    assert len(got) == 6
    for a, b in zip(got, cpu(*feats)):
        assert np.array_equal(a, b)


def test_batch_detect_modes_on_the_card_match_cpu(card, tmp_path):
    """`batch-detect` over a mixed crawl manifest in the auto mode with
    --closest 3 --attribution, and in the readme and package modes, on
    the card and on the CPU."""
    import chip_smoke

    manifest = chip_smoke.write_mixed_manifest(np, str(tmp_path / "rows"), 4,
                                               n_repos=150)
    for flags in (["--mode", "auto", "--closest", "3", "--attribution"],
                  ["--mode", "readme"], ["--mode", "package"]):
        outs = []
        for device in ("cpu", "cuda"):
            dice_cuda.reset_launches()
            out = tmp_path / f"{flags[1]}.{device}.jsonl"
            assert port_main(["batch-detect", manifest, "--output", str(out),
                              "--device", device, *flags]) == 0
            outs.append(out.read_bytes())
        if "--closest" in flags:
            assert dice_cuda.LAUNCHES["topk_fused"] > 0
            assert dice_cuda.LAUNCHES["topk_exact"] == 0
            assert dice_cuda.LAUNCHES["score_pairs_fused"] == 0
            assert dice_cuda.LAUNCHES["best_match_fused"] == 0
        assert outs[0] == outs[1]


# -- K1's fused top-k and the redesigned topk_exact -------------------------


@pytest.mark.parametrize("k", [1, 4, 5, 8])
@pytest.mark.parametrize("T", [1, 47, 63, 608])
@pytest.mark.parametrize("B", [1, 347, 1565, 4097])
def test_topk_fused_matches_plain_at_ragged_shapes(card, B, T, k):
    """K1's top-k epilogue on random bits at ragged B and T, with the
    templates split over blocks (small B) and not, at both list lengths
    (k <= 4 and k <= 8) and k past T."""
    args = k1_case(card, np.random.default_rng(B * 100 + T + k), B, T, 132)
    before = dice_cuda.LAUNCHES["topk_fused"]
    got = dice_cuda.topk_fused(*args, k)
    want = dice_cuda.topk_fused_plain(*args, k)
    assert dice_cuda.LAUNCHES["topk_fused"] == before + 1
    for a, b in zip(got, want):
        assert a.shape == (B, k) and torch.equal(a, b)
    assert torch.equal(got[0][:, 0], dice_cuda.best_match_fused(*args)[0])
    assert not dice_cuda._tickets(args[0].device, 1).any()


@pytest.mark.parametrize("B, T", [(347, 608), (4096, 47), (33, 200)])
def test_topk_fused_ties_and_exclusions(card, B, T):
    """Exact ties across the kernel's template splits, rows where every
    template is excluded (template 0 at (-1, 1) in every round) and rows
    with fewer real entries than k."""
    rng = np.random.default_rng(T * B)
    meta, bits, fb, nw, ln, cf = k1_case(card, rng, B, T, 132)
    n_sms = torch.cuda.get_device_properties(card).multi_processor_count
    per_split = dice_cuda.topk_fused_schedule(B, T, 132, n_sms)[1]
    dup = (torch.arange(T, device=card) % per_split) // 2 * 2
    bits, meta = bits[dup].contiguous(), meta[dup].contiguous()
    meta[:, dice_cuda.CC_FLAG] = 1
    meta[: T // 2, dice_cuda.VALID] = 0  # half the templates invalid
    src = torch.from_numpy(rng.integers(0, T, B)).to(card)
    fb = bits[src].contiguous()
    cf = torch.zeros(B, dtype=torch.bool, device=card)
    cf[::3] = True
    args = (meta, bits, fb, nw, ln, cf)
    for k in (4, dice_cuda.K_FUSED_MAX):
        got = dice_cuda.topk_fused(*args, k)
        for a, b in zip(got, dice_cuda.topk_fused_plain(*args, k)):
            assert torch.equal(a, b)
        idx, num, den = got
        assert (idx[cf] == 0).all() and (num[cf] == -1).all()
        assert (den[cf] == 1).all()


def test_topk_fused_refuses_what_it_cannot_take(card):
    args = k1_case(card, np.random.default_rng(0), 8, 47, 112)
    with pytest.raises(ValueError, match="1 <= k"):
        dice_cuda.topk_fused(*args, dice_cuda.K_FUSED_MAX + 1)
    with pytest.raises(ValueError, match="1 <= k"):
        dice_cuda.topk_fused(*args, 0)


@pytest.mark.parametrize("k", [2, 9, 16, 17, 100])
@pytest.mark.parametrize("T", [3, 47, 608, 2049])
def test_topk_exact_both_designs_match_plain(card, T, k):
    """`topk_exact`'s lane groups (k <= 16) and its bitonic sort (k > 16)
    at ragged T, rows of ties and rows with every entry excluded."""
    rng = np.random.default_rng(T + k)
    num, den = random_planes(card, rng, 77, T, tie_every=3 if k % 2 else 0)
    num[::5], den[::5] = -1, 1
    got = dice_cuda.topk_exact(num, den, k)
    for a, b in zip(got, dice_cuda.topk_exact_plain(num, den, k)):
        assert torch.equal(a, b)



# -- K5, device lanes and stripes on the card --


def k5_corpus(card, T):
    """The vendored corpus at T=47; a seeded random one of W=132 lanes at
    T=608 (the model axis pads its lane slices to whole stages)."""
    if T == 47:
        return convert.corpus_tensors(default_corpus(), card)
    rng = np.random.default_rng(608)
    W = 132
    bits = (rng.integers(0, 2**32, (T, W), dtype=np.uint32)
            & rng.integers(0, 2**32, (T, W), dtype=np.uint32))
    cols = {
        "n_wf": rng.integers(200, 2000, T), "n_fieldset": rng.integers(0, 6, T),
        "field_count": rng.integers(0, 8, T), "alt_count": rng.integers(0, 4, T),
        "length": rng.integers(1000, 40000, T),
    }
    return dice_ref.CorpusTensors(
        bits=torch.from_numpy(bits.view(np.int32)).to(card),
        **{n: torch.from_numpy(v.astype(np.int32)).to(card)
           for n, v in cols.items()},
        cc_flag=torch.from_numpy(rng.random(T) < 0.1).to(card),
        valid=torch.ones(T, dtype=torch.bool, device=card),
    )


def k5_features(card, ct, B, seed):
    rng = np.random.default_rng(seed)
    bits = ct.bits.cpu().numpy()
    T, W = bits.shape
    fb = rng.integers(0, 2**32, (B, W), dtype=np.uint32).view(np.int32)
    src = rng.integers(0, T, B)
    fb[::2] = bits[src[::2]]
    n_words = rng.integers(50, 3000, B).astype(np.int32)
    n_words[::2] = ct.n_wf.cpu().numpy()[src[::2]]
    return (torch.from_numpy(fb).to(card),
            torch.from_numpy(n_words).to(card),
            torch.from_numpy(rng.integers(100, 60000, B).astype(np.int32)
                             ).to(card),
            torch.from_numpy(rng.random(B) < 0.3).to(card))


@pytest.mark.parametrize("T", [47, 608])
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_k5_mesh_on_the_card_matches_plain(card, shape, T):
    """`make_sharded_scorer` over ``[cuda:0] * n`` against the plain
    scorer, top-1 and top-3, with one K1 launch per data shard (one
    model shard) or one K2 launch per (data, model) block."""
    from licensee_tpu_torch.parallel.mesh import build_mesh, make_sharded_scorer

    ct = k5_corpus(card, T)
    feats = k5_features(card, ct, 4096, T + shape[0] + shape[1])
    num, den = dice_ref.score_pairs(ct, *feats)
    want1 = dice_ref.argmax_exact(num, den)
    want3 = dice_ref.topk_candidates(num, den, 3)
    m = build_mesh(*shape, devices=[card] * (shape[0] * shape[1]))
    D, M = shape
    for topk, want, kernel in ((0, want1, "best_match_fused"),
                               (3, (*(w[:, 0] for w in want3), *want3),
                                "topk_fused")):
        fn = make_sharded_scorer(ct, m, "popcount", topk)
        dice_cuda.reset_launches()
        got = fn(*feats)
        torch.cuda.synchronize()
        launched = {k: v for k, v in dice_cuda.LAUNCHES.items() if v}
        assert launched.pop("make_sharded_scorer") == 1
        if M == 1:
            assert launched == {kernel: D}
        else:
            assert launched.pop("overlap_pairs_mma") == D * M
            assert launched == ({"topk_exact": D} if topk else {})
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("B", [1, 4097])
def test_k5_uneven_last_shard_on_the_card(card, B):
    from licensee_tpu_torch.parallel.mesh import build_mesh, make_sharded_scorer

    ct = k5_corpus(card, 47)
    feats = k5_features(card, ct, B, B)
    want = dice_ref.argmax_exact(*dice_ref.score_pairs(ct, *feats))
    got = make_sharded_scorer(ct, build_mesh(2, 1, devices=[card] * 2))(
        *feats)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_two_device_lanes_on_one_card(card):
    """Two lanes on cuda:0: two dispatch streams, two staging rings,
    chunks round-robin; the rows equal the CPU classifier's."""
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    contents = serve_texts(200)
    lanes = BatchClassifier(pad_batch_to=16, lanes=[card, card])
    assert len(lanes._lanes) == 2
    streams = {sc.stream for sc, _ring in lanes._lanes}
    assert len(streams) == 2
    host = BatchClassifier(pad_batch_to=16, device="cpu")
    got = lanes.classify_blobs(contents)
    want = host.classify_blobs(contents)
    assert [g.as_dict() for g in got] == [w.as_dict() for w in want]
    assert lanes._rr > 1


def test_stripe_child_without_a_card_exits_nonzero(card, tmp_path):
    """A stripe child under --device cuda that sees no card exits non-zero
    (never reruns on the CPU), and the runner counts and reports it."""
    import sys

    from licensee_tpu_torch.parallel.stripes import StripeError, StripeRunner

    files = [os.path.join(FIXTURES, "mit", "LICENSE.txt")] * 4
    manifest = tmp_path / "m.txt"
    manifest.write_text("\n".join(files) + "\n")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": REPO}
    out = tmp_path / "o.jsonl"
    child = __import__("subprocess").run(
        [sys.executable, "-m", "licensee_tpu_torch.cli.main",
         "batch-detect", str(manifest), "--output", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert child.returncode != 0 and "CUDA" in child.stderr
    runner = StripeRunner(str(manifest), str(out), 2, max_restarts=1,
                          base_env=env)
    with pytest.raises(StripeError):
        runner.run()
    assert all(h.exit_codes and h.exit_codes[0] != 0 for h in runner.handles)
    assert not out.exists()


@pytest.fixture(scope="module")
def card_fleet():
    """chip_smoke.py's phase 11 at its tiny size on the card: a 2-worker
    `fleet --socket --http` whose every run's rows it holds against a
    device='cpu' batcher's, with a worker SIGKILLed mid-run and a
    rolling reload."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the machine with the card)")
    import chip_smoke

    return chip_smoke.phase_fleet(np, torch, seed=0, device="cuda",
                                  scale=chip_smoke.FleetScale.tiny())


def test_fleet_on_the_card_answers_as_the_cpu_batcher(card_fleet):
    assert [r["run"] for r in card_fleet["timing"]["runs"]] == [
        "front T=47", "edge T=47", "front T=608", "edge T=608"]
    assert card_fleet["timing"]["roll"]["rows_new"] > 0


def test_fleet_workers_export_their_k1_launches(card_fleet):
    workers = card_fleet["timing"]["workers"]
    assert set(workers) == {"w0", "w1"}
    assert all(w["k1_launches"] > 0 for w in workers.values())
    assert all(n > 0 for n in card_fleet["launches"].values())


def test_fleet_sigkilled_worker_comes_back_on_the_card(card_fleet):
    kill = card_fleet["timing"]["kill"]
    assert kill["restarts"] == 1
    assert card_fleet["timing"]["victim_k1_launches"] > 0


# -- the jobs and tenancy tiers on the card -------------------------------------


def job_inputs(root, T):
    """A manifest of license texts of the corpus at width T (the vendored
    templates at T=47, the synthetic SPDX directory's at T=608), each
    with a marker that keeps it off the Exact prefilter; and the corpus
    option naming the directory."""
    from licensee_tpu_torch.corpus.license import License
    from licensee_tpu_torch.corpus.spdx import load_spdx_dir

    if T == 47:
        texts = [lic.content for lic in License.all(hidden=True)
                 if lic.content]
        options = {}
    else:
        spdx_dir = synth_spdx_dir(str(root / "spdx"), T, 0)
        texts = [t.content for t in load_spdx_dir(spdx_dir)][:200]
        options = {"corpus": spdx_dir, "method": "matmul"}
    paths = []
    for i, text in enumerate(texts):
        path = root / f"LICENSE_{i}"
        path.write_text(f"{text}\nzqjob{i}\n")
        paths.append(str(path))
    return paths, options


def run_job(root, device, spec, **kwargs):
    """One job through a `JobExecutor` on ``device``: (status row, results
    bytes or None, the merged exposition's kernel launches)."""
    import time

    from licensee_tpu_torch.jobs.executor import (
        TERMINAL_STATES,
        JobExecutor,
        validate_spec,
    )

    normalized, reason = validate_spec(spec)
    assert reason is None
    ex = JobExecutor(str(root), device=device, **kwargs)
    ex.start()
    try:
        job, _ = ex.submit(normalized)
        deadline = time.monotonic() + 600
        while ex.status(job.job_id)["state"] not in TERMINAL_STATES:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        row = ex.status(job.job_id)
    finally:
        ex.close()
    path = ex.results_path(job.job_id)
    if path is None:
        return row, None, {}
    launches = {}
    with open(f"{path}.prom", encoding="utf-8") as f:
        for line in f:
            if line.startswith("device_kernel_launches{"):
                kernel = line.split('kernel="')[1].split('"')[0]
                launches[kernel] = launches.get(kernel, 0) + int(
                    float(line.split()[-1]))
    with open(path, "rb") as f:
        return row, f.read(), launches


@pytest.mark.parametrize("T, kernel", [(47, "best_match_fused"),
                                       (608, "overlap_pairs_mma")])
def test_job_on_the_card_matches_cpu(card, tmp_path, T, kernel):
    """A 2-stripe job on the card gives the bytes of the same job on the
    CPU, and its stripes launched only the kernel its options route to:
    K1 at T=47 by default, K2 at T=608 under `method: matmul`."""
    paths, options = job_inputs(tmp_path, T)
    spec = {"manifest": paths, "stripes": 2, "options": options}
    row, got, launches = run_job(tmp_path / "card", "cuda", spec)
    _row, want, _ = run_job(tmp_path / "cpu", "cpu", spec)
    assert row["state"] == "completed" and got == want
    assert len(got.splitlines()) == len(paths)
    assert launches.get(kernel, 0) > 0
    assert {k for k, n in launches.items() if n} == {kernel}


def test_job_whose_stripe_cannot_open_the_card_fails(card, tmp_path):
    """A stripe child that sees no card exits non-zero and the job lands
    in `failed` with its error: it is never rerun on the CPU."""
    paths, _options = job_inputs(tmp_path, 47)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": REPO}
    row, got, _ = run_job(tmp_path / "jobs", "cuda",
                          {"manifest": paths[:4]}, base_env=env)
    assert row["state"] == "failed" and got is None
    assert "CUDA" in row["error"]


def test_tenant_pool_worker_on_the_card_answers_its_fingerprint(
        card, tmp_path):
    """One tenant pool of one `serve` worker on the card behind a
    pool-aware router: a tagged classify lands on the pool's worker,
    stamps the pool's corpus fingerprint and launches K1."""
    from licensee_tpu_torch.corpus.artifact import (
        corpus_fingerprint,
        short_fingerprint,
    )
    from licensee_tpu_torch.fleet.router import Router
    from licensee_tpu_torch.fleet.supervisor import Supervisor
    from licensee_tpu_torch.fleet.wire import oneshot
    from licensee_tpu_torch.tenancy import (
        CorpusOnboarder,
        Tenant,
        TenantPools,
        TenantRegistry,
    )

    sock = str(tmp_path / "acme0.sock")
    pools = TenantPools({"acme": Supervisor(
        {"acme0": sock}, serve_args=("--device", "cuda", "--corpus",
                                     "vendored"))})
    registry = TenantRegistry(str(tmp_path / "tenants.json"), create=True)
    registry.set_tenant(Tenant("acme", "tok-acme", "vendored"))
    fp = corpus_fingerprint(default_corpus())
    try:
        pools.start()
        assert pools.wait_healthy(300.0), pools.status()
        with Router(pools.workers, supervisor=pools,
                    pools=pools.worker_pools(), default_pool="acme",
                    request_timeout_s=60.0) as router:
            CorpusOnboarder(registry, pools, router,
                            staging_dir=str(tmp_path / "staging")
                            ).sync_routes(fingerprints={"acme": fp})
            text = (open(os.path.join(FIXTURES, "mit", "LICENSE.txt"))
                    .read() + "\nzqtenant\n")
            row = router.dispatch({"id": 1, "content": text,
                                   "corpus": "acme"})
            assert row.get("worker") == "acme0" and row["key"] == "mit", row
            assert row["corpus"] in (fp, short_fingerprint(fp))
            text = oneshot(sock, {"op": "stats", "format": "prometheus"},
                           60.0)["prometheus"]
            import re

            assert re.search(r'^device_kernel_launches\{[^}]*kernel='
                             r'"best_match_fused"[^}]*\} [1-9]', text, re.M)
    finally:
        pools.stop()
        registry.close()


def test_graft_entry_on_the_card_is_one_k1_launch(card):
    """`graft_entry.entry()`'s step launches `best_match_fused` once and
    gives the triples of its plain version and of `dice_ref.best_match`."""
    from licensee_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    assert all(a.device.type == "cuda" for a in args)
    torch.cuda.synchronize()
    dice_cuda.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    assert {n: c for n, c in dice_cuda.LAUNCHES.items() if c} == {
        "best_match_fused": 1}
    ct = convert.corpus_tensors(default_corpus(), card)
    for want in (dice_cuda.best_match_fused_plain(dice_cuda.pack_meta(ct),
                                                  ct.bits, *args),
                 dice_ref.best_match(ct, *args)):
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_graft_dryrun_multichip_on_the_card(card, n_devices):
    """`dryrun_multichip(n)` on a mesh that repeats the card: every blob
    on the device path and right, through K5 over K1 (one model shard)
    or K2 lane slices, with no other kernel."""
    from licensee_tpu_torch import graft_entry

    n_model = 2 if n_devices % 2 == 0 else 1
    n_data = n_devices // n_model
    torch.cuda.synchronize()
    dice_cuda.reset_launches()
    rows = graft_entry.dryrun_multichip(n_devices)
    torch.cuda.synchronize()
    got = {n: c for n, c in dice_cuda.LAUNCHES.items() if c}
    assert len(rows) == max(n_data * 8, 16)
    assert all(r.matcher == "dice" for r in rows)
    calls = got.get("make_sharded_scorer", 0)
    kernel, per_call = (("best_match_fused", n_data) if n_model == 1
                        else ("overlap_pairs_mma", n_data * n_model))
    assert calls and got == {"make_sharded_scorer": calls,
                             kernel: calls * per_call}
