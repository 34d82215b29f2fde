"""The port's Dice scorers against the JAX package's, bit for bit.

`kernels/dice_ref.py` (the plain PyTorch versions) against
`kernels/dice_xla.py`; the plain versions of the hand-written kernels
(what `kernels/dice_cuda.py`'s wrappers run for CPU tensors) against the
Pallas kernels of `kernels/dice_pallas.py` in interpret mode, as
tests/test_dice_pallas.py runs them.  The same numpy inputs, made from
a seed, go to both packages; every comparison is exact (integers)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from licensee_tpu.corpus.compiler import default_corpus
from licensee_tpu.kernels import dice_pallas, dice_xla
from licensee_tpu_torch import convert
from licensee_tpu_torch.kernels import dice_cuda, dice_ref

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core would crowd them
torch.set_num_threads(1)


# the JAX side jitted once per shape: eager dispatch would compile every
# op of the tournament anew for each shape
jax_score_pairs = jax.jit(dice_xla.score_pairs, static_argnames="method")
jax_argmax = jax.jit(dice_xla._argmax_exact)


def jax_best_match(arrays, *feats):
    return jax_argmax(*jax_score_pairs(arrays, *feats))


@pytest.fixture(scope="module")
def corpus():
    return default_corpus()


_ARRAYS: dict = {}


def jax_arrays(corpus):
    """The JAX package's device constants, built once per corpus."""
    if id(corpus) not in _ARRAYS:
        _ARRAYS[id(corpus)] = (corpus, dice_xla.CorpusArrays.from_compiled(corpus))
    return _ARRAYS[id(corpus)][1]


def to_port(corpus, pad_to=None):
    """The JAX corpus carried into the port as numpy, then onto the CPU."""
    carried = convert.corpus_from_numpy(
        corpus.keys, corpus.vocab,
        {n: np.asarray(getattr(corpus, n)) for n in convert.ARRAY_FIELDS},
    )
    return dice_ref.CorpusTensors.from_compiled(carried, "cpu", pad_to=pad_to)


def random_features(n_lanes, B, seed, cc=True):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=(B, n_lanes), dtype=np.uint32)
    n_words = rng.integers(50, 3000, size=B).astype(np.int32)
    lengths = rng.integers(100, 60000, size=B).astype(np.int32)
    cc_fp = rng.integers(0, 2, size=B).astype(bool) if cc else np.zeros(B, bool)
    return bits, n_words, lengths, cc_fp


def torch_features(bits, n_words, lengths, cc_fp):
    return (
        torch.from_numpy(np.ascontiguousarray(bits).view(np.int32)),
        torch.from_numpy(n_words),
        torch.from_numpy(lengths),
        torch.from_numpy(cc_fp),
    )


def assert_same(port_out, jax_out):
    for a, b in zip(port_out, jax_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("method", ["popcount", "matmul"])
@pytest.mark.parametrize("B", [1, 7, 129, 300])
def test_score_pairs_matches_dice_xla(corpus, B, method):
    feats = random_features(corpus.n_lanes, B, seed=B)
    ref = jax_score_pairs(jax_arrays(corpus), *feats, method=method)
    ours = dice_ref.score_pairs(to_port(corpus), *torch_features(*feats),
                                method=method)
    assert_same(ours, ref)


@pytest.mark.parametrize("B", [1, 7, 129, 300])
def test_best_match_matches_dice_xla(corpus, B):
    feats = random_features(corpus.n_lanes, B, seed=100 + B)
    ref = jax_best_match(jax_arrays(corpus), *feats)
    ours = dice_ref.best_match(to_port(corpus), *torch_features(*feats))
    assert_same(ours, ref)


def test_padded_templates_and_lanes(corpus):
    """Padding templates (valid=False) are masked to (-1, 1), and zero
    lanes past the vocabulary change nothing."""
    wide = dataclasses.replace(
        corpus, bits=np.pad(np.asarray(corpus.bits), ((0, 0), (0, 20))))
    T = corpus.n_templates
    feats = random_features(wide.n_lanes, 130, seed=3)
    arrays = dice_xla.CorpusArrays.from_compiled(wide, pad_to=T + 9)
    ref = jax_score_pairs(arrays, *feats)
    ours = dice_ref.score_pairs(to_port(wide, pad_to=T + 9),
                                *torch_features(*feats))
    assert_same(ours, ref)
    assert (ours[0][:, T:] == -1).all() and (ours[1][:, T:] == 1).all()
    assert_same(dice_ref.argmax_exact(*ours), jax_argmax(*ref))


def test_cc_guard_and_template_rows(corpus):
    """Each template's own bitset through both packages, with and without
    the CC false-positive flag: CC templates must lose under the flag."""
    T = corpus.n_templates
    bits = np.asarray(corpus.bits)
    n_words = np.asarray(corpus.n_wf)
    lengths = np.asarray(corpus.length)
    arrays = jax_arrays(corpus)
    ct = to_port(corpus)
    for flag in (False, True):
        cc_fp = np.full(T, flag)
        ref = jax_best_match(arrays, bits, n_words, lengths, cc_fp)
        ours = dice_ref.best_match(
            ct, *torch_features(bits, n_words, lengths, cc_fp))
        assert_same(ours, ref)
    cc_rows = np.flatnonzero(np.asarray(corpus.cc_flag))
    assert len(cc_rows) and not (ours[0].numpy()[cc_rows] == cc_rows).any()


def test_nonpositive_denominator_gives_one(corpus):
    feats = list(random_features(corpus.n_lanes, 64, seed=5))
    feats[1] = -np.abs(feats[1]) - 4000  # n_words so low that denom <= 0
    ref = jax_score_pairs(jax_arrays(corpus), *feats)
    ours = dice_ref.score_pairs(to_port(corpus), *torch_features(*feats))
    assert_same(ours, ref)
    num, den = (t.numpy() for t in ours)
    assert ((den == 1) & (num >= 0)).any()


def test_forced_ties_go_to_the_lower_index(corpus):
    """Duplicate template rows tie exactly; both packages pick the first."""
    order = np.r_[np.arange(corpus.n_templates), [3, 3, 10, 0]]
    dup = dataclasses.replace(
        corpus,
        keys=tuple(corpus.keys[i] for i in order),
        **{n: np.asarray(getattr(corpus, n))[order]
           for n in convert.ARRAY_FIELDS},
    )
    rows = [3, 10, 0]
    bits = np.asarray(dup.bits)[rows]
    n_words = np.asarray(dup.n_wf)[rows]
    lengths = np.asarray(dup.length)[rows]
    cc_fp = np.zeros(3, bool)
    ref = jax_best_match(dice_xla.CorpusArrays.from_compiled(dup),
                         bits, n_words, lengths, cc_fp)
    ours = dice_ref.best_match(
        to_port(dup), *torch_features(bits, n_words, lengths, cc_fp))
    assert_same(ours, ref)
    assert ours[0].tolist() == rows
    # an all-tied row of (-1, 1): the first template wins
    idx, num, den = dice_ref.argmax_exact(
        torch.full((2, 5), -1, dtype=torch.int32),
        torch.ones((2, 5), dtype=torch.int32))
    assert idx.tolist() == [0, 0] and num.tolist() == [-1, -1]


def test_argmax_exact_matches_tournament_on_near_ties():
    """Fractions that differ below float32 resolution, and odd widths."""
    rng = np.random.default_rng(9)
    for T in (1, 2, 5, 97):
        den = rng.integers(1, 5000, size=(33, T)).astype(np.int32)
        num = (den * rng.integers(0, 3, size=(33, T)) // 2).astype(np.int32)
        num[:, -1] = num[:, 0]
        den[:, -1] = den[:, 0]
        ref = jax_argmax(num, den)
        ours = dice_ref.argmax_exact(torch.from_numpy(num), torch.from_numpy(den))
        assert_same(ours, ref)


@pytest.mark.parametrize("B", [1, 129])
def test_fused_score_plain_matches_pallas_kernel(corpus, B):
    """K1's plain version (the CPU path of `score_pairs_fused`) against
    the Pallas kernel it replaces, run in interpret mode."""
    feats = random_features(corpus.n_lanes, B, seed=200 + B)
    ref = dice_pallas.score_pairs_pallas(
        jax_arrays(corpus), *feats, interpret=True)
    ct = to_port(corpus)
    ours = dice_cuda.score_pairs_fused(
        dice_cuda.pack_meta(ct), ct.bits, *torch_features(*feats))
    assert_same(ours, ref)


@pytest.mark.parametrize("B", [100])
def test_best_fused_plain_matches_pallas_kernel(corpus, B):
    """K1's fused first-max (the CPU path of `best_match_fused`) against
    the Pallas kernel and its argmax (`best_match_pallas`) in interpret
    mode, on blobs half of which copy templates."""
    bits, n_words, lengths, cc_fp = random_features(corpus.n_lanes, B,
                                                    seed=400 + B)
    src = np.arange(B) % corpus.n_templates
    bits[::2] = np.asarray(corpus.bits)[src[::2]]
    n_words[::2] = np.asarray(corpus.n_wf)[src[::2]]
    feats = (bits, n_words, lengths, cc_fp)
    # `best_match_pallas`, its tournament jitted (eager, it compiles per op)
    ref = jax_argmax(*dice_pallas.score_pairs_pallas(
        jax_arrays(corpus), *feats, interpret=True))
    ct = to_port(corpus)
    ours = dice_cuda.best_match_fused(
        dice_cuda.pack_meta(ct), ct.bits, *torch_features(*feats))
    assert_same(ours, ref)
    assert_same(ours, jax_best_match(jax_arrays(corpus), *feats))


@pytest.mark.parametrize("B", [7, 129])
def test_mma_overlap_plain_matches_pallas_kernel(corpus, B):
    """K2's plain version (the CPU path of `overlap_pairs_mma`) against
    the Pallas MXU kernel it replaces, run in interpret mode."""
    bits = random_features(corpus.n_lanes, B, seed=300 + B)[0]
    ref = dice_pallas.overlap_pairs_mxu(
        jax_arrays(corpus), bits, interpret=True)
    ct = to_port(corpus)
    tpl = dice_cuda.pack_templates_mma(ct)
    ours = dice_cuda.overlap_pairs_mma(
        tpl, torch.from_numpy(bits.view(np.int32)), ct.n_templates)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_mma_template_operand_layout(corpus):
    """K2's template operand is the lane-major unpack of dice_xla, with T
    padded to wgmma's steps of 16 (47 -> 48) and zero padding rows; a
    width that is not whole 4-word stages is refused, as the kernel
    refuses it."""
    ct = to_port(corpus)
    tpl = dice_cuda.pack_templates_mma(ct).numpy()
    T, W = corpus.n_templates, corpus.n_lanes
    assert (T, W) == (47, 112)
    assert tpl.shape == (48, 32 * W)
    want = np.asarray(dice_xla._unpack_bits(np.asarray(corpus.bits)))
    np.testing.assert_array_equal(tpl[:T], want)
    assert not tpl[T:].any()
    narrow = dataclasses.replace(ct, bits=ct.bits[:5, :6].contiguous())
    with pytest.raises(ValueError, match="multiple of 4"):
        dice_cuda.pack_templates_mma(narrow)


def spread_nibble(x):
    """csrc/dice_overlap_mma.cu's spread_nibble on uint32 numpy arrays."""
    return ((x & 0xF) * np.uint32(0x00204081)) & np.uint32(0x01010101)


def test_mma_a_fragments_reassemble_the_unpacked_blobs():
    """K2's register-A operand built from packed words exactly as the
    kernel builds it, per (warp, lane, k-step) of a 128-row block, then
    placed where wgmma's m64nNk32 fragment layout puts each byte: every
    element of the unpacked block is written once, equal to unpack_bits."""
    rng = np.random.default_rng(4)
    W = 8  # two 128-column stages
    words = rng.integers(0, 2**32, size=(dice_cuda.MMA_BLOCK_B, W),
                         dtype=np.uint32)
    got = np.full((dice_cuda.MMA_BLOCK_B, 32 * W), -1, dtype=np.int64)
    for stage in range(W // dice_cuda.MMA_STAGE_WORDS):
        tile = words[:, 4 * stage: 4 * stage + 4]  # the TMA'd [128, 4] words
        for warp in range(8):
            for lane in range(32):
                g, tig = lane >> 2, lane & 3
                r = (warp // 4) * 64 + (warp % 4) * 16 + g
                for kk in range(4):
                    lo, hi = tile[r, kk], tile[r + 8, kk]
                    a = [spread_nibble(lo >> (4 * tig)),
                         spread_nibble(hi >> (4 * tig)),
                         spread_nibble(lo >> (16 + 4 * tig)),
                         spread_nibble(hi >> (16 + 4 * tig))]
                    # register q holds 4 consecutive K elements of row
                    # g (+8 for odd q), columns 4*tig (+16 for q >= 2)
                    for q, reg in enumerate(a):
                        row = r + 8 * (q & 1)
                        col = stage * 128 + kk * 32 + 16 * (q >> 1) + 4 * tig
                        for i in range(4):
                            assert got[row, col + i] == -1
                            got[row, col + i] = (int(reg) >> (8 * i)) & 0xFF
    want = dice_ref.unpack_bits(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("bn", dice_cuda.MMA_TILE_N)
def test_mma_accumulator_stores_cover_the_tile_once(bn):
    """K2's epilogue: d[4j..4j+3] of each consumer thread go to rows r and
    r + 8, columns 8j + 2*tig (+1); together they cover [128, bn] once."""
    seen = np.zeros((dice_cuda.MMA_BLOCK_B, bn), dtype=np.int64)
    for warp in range(8):
        for lane in range(32):
            g, tig = lane >> 2, lane & 3
            r = (warp // 4) * 64 + (warp % 4) * 16 + g
            for j in range(bn // 8):
                for row in (r, r + 8):
                    seen[row, 8 * j + 2 * tig: 8 * j + 2 * tig + 2] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("B, T, W, want", [
    (4096, 47, 112, (48, 4)),     # the main path: V split over 4 blocks
    (4096, 608, 132, (208, 1)),   # three tiles of 208 templates
    (262144, 47, 112, (48, 1)),
    (262144, 608, 132, (208, 1)),
    (65, 49, 132, (64, 33)),
    (1, 1, 4, (16, 1)),
    (4097, 300, 8, (208, 2)),
])
def test_mma_schedule(B, T, W, want):
    bn, splits = got = dice_cuda.mma_schedule(B, T, W, n_sms=132)
    assert got == want
    n_tiles = -(-T // bn)
    assert bn in dice_cuda.MMA_TILE_N and n_tiles == -(-T // 208)
    stages = W // dice_cuda.MMA_STAGE_WORDS
    per = -(-stages // splits)
    assert (splits - 1) * per < stages  # no split is empty


def test_best_match_fn_methods_agree(corpus):
    """The scorer the batch path dispatches, for every --method, on the
    CPU: the same top-1 as dice_xla."""
    feats = random_features(corpus.n_lanes, 129, seed=11)
    ref = jax_best_match(jax_arrays(corpus), *feats)
    ct = to_port(corpus)
    for method in dice_cuda.K1_METHODS + dice_cuda.K2_METHODS:
        ours = dice_cuda.make_best_match_fn(ct, method)(*feats)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
    for method in ("closest", "auto"):  # auto is resolved before this
        with pytest.raises(ValueError):
            dice_cuda.make_best_match_fn(ct, method)


def test_plain_versions_count_no_launches(corpus):
    dice_cuda.reset_launches()
    ct = to_port(corpus)
    feats = torch_features(*random_features(corpus.n_lanes, 3, seed=1))
    dice_cuda.score_pairs_fused(dice_cuda.pack_meta(ct), ct.bits, *feats)
    dice_cuda.best_match_fused(dice_cuda.pack_meta(ct), ct.bits, *feats)
    dice_cuda.overlap_pairs_mma(
        dice_cuda.pack_templates_mma(ct), feats[0], ct.n_templates)
    dice_cuda.topk_exact(*dice_cuda.score_pairs_fused_plain(
        dice_cuda.pack_meta(ct), ct.bits, *feats), 4)
    dice_cuda.topk_fused(dice_cuda.pack_meta(ct), ct.bits, *feats, 4)
    from licensee_tpu_torch.parallel.mesh import (
        build_mesh,
        make_sharded_scorer,
    )

    make_sharded_scorer(ct, build_mesh(1, 2, devices=["cpu"] * 2))(*feats)
    assert dice_cuda.LAUNCHES == {"score_pairs_fused": 0,
                                  "best_match_fused": 0,
                                  "topk_fused": 0,
                                  "overlap_pairs_mma": 0,
                                  "topk_exact": 0,
                                  "make_sharded_scorer": 0}
