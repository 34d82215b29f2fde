"""K1's fused first-max on the CPU, bit for bit against the JAX package.

`dice_cuda.best_match_fused` on CPU tensors (its plain version) against
the interpret-mode Pallas kernel and tournament of
`dice_pallas.best_match_pallas` and against `dice_xla`'s scorer and tournament, on the vendored corpus
and at the synthetic-SPDX width (T=608, W=132), with forced ties across
the kernel's template splits, excluded rows, non-positive denominators
and denominators near 2^31.  Then CPU models of what the CUDA kernel
does that no CPU can run: its split-and-merge schedule (partial bests
merged in shuffled order), its m16n8k256 single-bit fragment layout and
its shared-memory stride.  Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licensee_tpu.corpus.compiler import default_corpus
from licensee_tpu.kernels import dice_pallas, dice_xla
from licensee_tpu_torch.kernels import dice_cuda, dice_ref

torch.set_num_threads(1)

N_SMS = 132  # an H100 SXM's; the schedule's tests also take other counts
INT_MAX = 2**31 - 1

jax_score_pairs = jax.jit(dice_xla.score_pairs)
jax_argmax = jax.jit(dice_xla._argmax_exact)


def make_corpus(rng, T, W):
    """Seeded template constants as numpy arrays (the JAX `CorpusArrays`
    fields)."""
    return {
        "bits": rng.integers(0, 2**32, (T, W), dtype=np.uint32),
        "n_wf": rng.integers(50, 3000, T).astype(np.int32),
        "n_fieldset": rng.integers(0, 4, T).astype(np.int32),
        "field_count": rng.integers(0, 6, T).astype(np.int32),
        "alt_count": rng.integers(0, 40, T).astype(np.int32),
        "length": rng.integers(100, 60000, T).astype(np.int32),
        "cc_flag": rng.random(T) < 0.2,
        "valid": rng.random(T) < 0.9,
    }


def vendored():
    c = default_corpus()
    out = {n: np.asarray(getattr(c, n)) for n in (
        "bits", "n_wf", "n_fieldset", "field_count", "alt_count", "length")}
    out["cc_flag"] = np.asarray(c.cc_flag).astype(bool)
    out["valid"] = np.ones(c.n_templates, bool)
    return out


def features(rng, arrays, B):
    """Blobs: half copies of templates (near-ties), half random bits."""
    T, W = arrays["bits"].shape
    bits = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
    src = rng.integers(0, T, B)
    bits[::2] = arrays["bits"][src[::2]]
    n_words = rng.integers(50, 3000, B).astype(np.int32)
    n_words[::2] = arrays["n_wf"][src[::2]]
    lengths = rng.integers(100, 60000, B).astype(np.int32)
    cc_fp = rng.random(B) < 0.3
    return bits, n_words, lengths, cc_fp


def port_best(arrays, feats):
    ct = dice_ref.CorpusTensors(
        bits=torch.from_numpy(arrays["bits"].view(np.int32)),
        **{n: torch.from_numpy(arrays[n]) for n in (
            "n_wf", "n_fieldset", "field_count", "alt_count", "length",
            "cc_flag", "valid")},
    )
    bits, n_words, lengths, cc_fp = feats
    return dice_cuda.best_match_fused(
        dice_cuda.pack_meta(ct), ct.bits,
        torch.from_numpy(np.ascontiguousarray(bits).view(np.int32)),
        torch.from_numpy(n_words), torch.from_numpy(lengths),
        torch.from_numpy(cc_fp))


def jax_arrays(arrays):
    return dice_xla.CorpusArrays(**{n: jnp.asarray(a)
                                    for n, a in arrays.items()})


def dup_across_splits(arrays, B):
    """Template t repeats template t - per_split (the previous slice of
    the kernel's split at this B), so equal scores straddle every split
    boundary."""
    T, W = arrays["bits"].shape
    splits, per_split, _ = dice_cuda.fused_schedule(B, T, W, N_SMS)
    assert splits > 1
    src = np.arange(T) % per_split
    return {n: a[src] for n, a in arrays.items()}


def wide():
    return make_corpus(np.random.default_rng(608), 608, 132)


CASES = {
    # name: (corpus arrays, B, feature tweak, also run the Pallas kernel)
    # (the vendored corpus against the Pallas kernel: test_torch_kernels.py,
    # which compiles that kernel's shape once for all its tests)
    "vendored": (vendored, 128, None, False),
    "wide608": (wide, 40, None, True),
    "ties-across-splits": (lambda: dup_across_splits(vendored(), 64), 64,
                           None, False),
    "ties-across-splits-608": (lambda: dup_across_splits(wide(), 24), 24,
                               None, False),
    "all-excluded": (lambda: {**vendored(), "cc_flag": np.ones(47, bool)},
                     33, "cc", False),
    "none-valid": (lambda: {**wide(), "valid": np.zeros(608, bool)}, 9,
                   None, False),
    "denom<=0": (vendored, 64, "negative", False),
    "den-near-2^31": (lambda: {**vendored(), "n_wf": np.full(
        47, INT_MAX - 30000, np.int32)}, 64, "few-words", False),
    "B=1": (vendored, 1, None, False),
    "T=1": (lambda: make_corpus(np.random.default_rng(1), 1, 8), 17, None,
            False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_best_match_fused_matches_jax(name):
    make, B, tweak, pallas = CASES[name]
    arrays = make()
    rng = np.random.default_rng(len(name))
    bits, n_words, lengths, cc_fp = features(rng, arrays, B)
    if tweak == "cc":
        cc_fp[:] = True
    if tweak == "negative":
        n_words = -np.abs(n_words) - 4000
    if tweak == "few-words":  # no wrap: denominators just below 2^31
        n_words = rng.integers(50, 3000, B).astype(np.int32)
    feats = (bits, n_words, lengths, cc_fp)
    ours = [t.numpy() for t in port_best(arrays, feats)]
    ref = jax_argmax(*jax_score_pairs(jax_arrays(arrays), *feats))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    if pallas:  # `best_match_pallas`, its tournament jitted as
        # `make_padded_best_match_fn` runs it (eager, it compiles per op)
        ref = jax_argmax(*dice_pallas.score_pairs_pallas(
            jax_arrays(arrays), *feats, interpret=True))
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
    idx, num, den = ours
    if tweak == "cc" or name == "none-valid":
        assert (idx == 0).all() and (num == -1).all() and (den == 1).all()
    if tweak == "negative":
        assert ((den == 1) & (num >= 0)).any()
    if name.startswith("ties"):  # the first copy wins every tie
        per_split = dice_cuda.fused_schedule(B, *arrays["bits"].shape,
                                             N_SMS)[1]
        assert (idx < per_split).all()
    if name == "den-near-2^31":
        assert (den > 2**31 - 40000).all()


# -- the kernel's schedule and merge, modelled -----------------------------


def better(r, l):
    """csrc/dice_score_fused.cu's merge comparator, in Python ints."""
    rp, lp = r[1] * l[2], l[1] * r[2]
    return rp > lp or (rp == lp and r[0] < l[0])


def kernel_model(num, den, W, n_sms, rng):
    """The fused kernel's first-max, step by step as the CUDA source runs
    it: per template slice of the split, each quad lane scans its columns
    chunk by chunk with a strict compare from the (-2, 1) sentinel; the
    quad's lanes merge by xor-shuffles; the slices' partial bests merge
    in shuffled order."""
    B, T = num.shape
    splits, per_split, tc = dice_cuda.fused_schedule(B, T, W, n_sms)
    out = []
    for b in range(B):
        partials = []
        for s in range(splits):
            t_lo = s * per_split
            t_hi = min(T, t_lo + per_split)
            assert t_lo < t_hi  # no slice is empty
            lanes = []
            for t in range(4):
                best = (INT_MAX, -2, 1)
                for t0 in range(t_lo, t_hi, tc):
                    nt = min(tc, t_hi - t0)
                    for j in range(tc // 8):
                        for e in range(2):
                            col = 8 * j + 2 * t + e
                            if col >= nt:
                                continue
                            c = (t0 + col, int(num[b, t0 + col]),
                                 int(den[b, t0 + col]))
                            if c[1] * best[2] > best[1] * c[2]:
                                best = c
                lanes.append(best)
            for mask in (1, 2):
                lanes = [lanes[i ^ mask] if better(lanes[i ^ mask], lanes[i])
                         else lanes[i] for i in range(4)]
            partials.append(lanes[0])
        best = (INT_MAX, -2, 1)
        for s in rng.permutation(splits):
            if better(partials[s], best):
                best = partials[s]
        out.append(best)
    return np.array(out, dtype=np.int64).T


@pytest.mark.parametrize("B, T, W, n_sms", [
    (70, 47, 112, N_SMS),   # 2 blob tiles x 6 slices of 8
    (5, 608, 132, N_SMS),   # 76 slices of 8
    (300, 608, 132, 4),     # one slice, 19 chunks of 32
    (3, 1, 4, N_SMS),
    (9, 33, 8, 2),          # two slices of 24, chunks of 24 and 9
])
def test_split_merge_model_equals_argmax_exact(B, T, W, n_sms):
    """Exact ties everywhere, excluded pairs, and nums and dens near
    2^31 (products near 2^62): any merge order gives the first-max."""
    rng = np.random.default_rng(B * T)
    num = rng.choice([-1, 0, 3, 7, INT_MAX - 1, INT_MAX], (B, T))
    den = rng.choice([1, 2, 6, 14, INT_MAX - 2, INT_MAX], (B, T))
    den[num == -1] = 1
    want = dice_ref.argmax_exact(torch.from_numpy(num).int(),
                                 torch.from_numpy(den).int())
    ref = jax_argmax(num.astype(np.int32), den.astype(np.int32))
    got = kernel_model(num, den, W, n_sms, rng)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(g, np.asarray(r))


@pytest.mark.parametrize("B, T, W, want", [
    (4096, 47, 112, (3, 16, 16)),    # the main path: 64 tiles x 3 slices
    (4096, 608, 132, (5, 128, 32)),
    (262144, 47, 112, (1, 48, 32)),
    (262144, 608, 132, (1, 608, 32)),
    (347, 608, 132, (38, 16, 16)),   # the wide slice's Dice-bound rows
    (1565, 47, 112, (6, 8, 8)),      # the vendored slice's
    (512, 47, 112, (6, 8, 8)),
    (512, 608, 132, (26, 24, 24)),
    (1, 1, 4, (1, 8, 8)),
])
def test_fused_schedule(B, T, W, want):
    splits, per_split, tc = got = dice_cuda.fused_schedule(B, T, W, N_SMS)
    assert got == want
    assert per_split % 8 == 0 and tc % 8 == 0 and tc <= dice_cuda.K1_TC
    assert (splits - 1) * per_split < T <= splits * per_split
    tiles = -(-B // dice_cuda.K1_BM)
    assert tiles * splits >= min(N_SMS, tiles * -(-T // 8))  # fills the card
    assert dice_cuda.k1_smem_bytes(W, tc) <= dice_cuda.K1_SMEM_CAP


def test_fused_schedule_refuses_too_wide_rows():
    assert dice_cuda.fused_schedule(64, 47, 700, N_SMS)[2] == 8
    with pytest.raises(ValueError, match="too wide"):
        dice_cuda.fused_schedule(64, 47, 800, N_SMS)


def popc(x):
    return bin(int(x)).count("1")


def test_b1_fragments_rebuild_the_packed_operands():
    """One warp's m16n8k256 products as the kernel feeds them: lane
    (g, t) loads words (8k + 2t, 8k + 2t + 1) of blob rows g and g + 8
    and of template row 8j + g from shared memory.  Placed where the
    PTX fragment layout puts each register (a0: row g, 32-bit chunk t;
    a1: row g + 8; a2/a3: chunk 4 + t; b0/b1: column g, chunks t and
    4 + t; c0..c3: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)),
    every chunk of each operand is filled once per k-step, and the
    accumulated tile equals `overlap_popcount` on the unpadded rows."""
    rng = np.random.default_rng(7)
    W = 20  # not a multiple of 8: the last k-step is half zero padding
    Wp = dice_cuda.k1_row_stride(W)
    blobs = rng.integers(0, 2**32, (16, W), dtype=np.uint32)
    tpls = rng.integers(0, 2**32, (8, W), dtype=np.uint32)
    s_blob = np.zeros((16, Wp), np.uint32)  # words past W zeroed
    s_blob[:, :W] = blobs
    s_tpl = rng.integers(0, 2**32, (8, Wp), dtype=np.uint32)  # garbage pad
    s_tpl[:, :W] = tpls
    acc = np.zeros((16, 8), np.int64)
    for k in range(-(-W // 8)):
        a_log = np.full((16, 8), -1, np.int64)
        b_log = np.full((8, 8), -1, np.int64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            lo = s_blob[g, 8 * k + 2 * t: 8 * k + 2 * t + 2]
            hi = s_blob[g + 8, 8 * k + 2 * t: 8 * k + 2 * t + 2]
            b = s_tpl[g, 8 * k + 2 * t: 8 * k + 2 * t + 2]
            regs_a = [(g, t, lo[0]), (g + 8, t, hi[0]), (g, 4 + t, lo[1]),
                      (g + 8, 4 + t, hi[1])]
            for row, chunk, v in regs_a:
                assert a_log[row, chunk] == -1
                a_log[row, chunk] = v
            for chunk, v in ((t, b[0]), (4 + t, b[1])):
                assert b_log[g, chunk] == -1
                b_log[g, chunk] = v
        assert (a_log >= 0).all() and (b_log >= 0).all()
        c = np.array([[sum(popc(a_log[m, q] & b_log[n, q]) for q in range(8))
                       for n in range(8)] for m in range(16)])
        regs = {}
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            regs[lane] = [c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
                          c[g + 8, 2 * t + 1]]
        for lane, (c0, c1, c2, c3) in regs.items():
            g, t = lane >> 2, lane & 3
            acc[g, 2 * t] += c0
            acc[g, 2 * t + 1] += c1
            acc[g + 8, 2 * t] += c2
            acc[g + 8, 2 * t + 1] += c3
    want = dice_ref.overlap_popcount(torch.from_numpy(blobs.view(np.int32)),
                                     torch.from_numpy(tpls.view(np.int32)))
    np.testing.assert_array_equal(acc, want.numpy())


@pytest.mark.parametrize("W", [4, 20, 112, 132, 256, 700])
def test_row_stride_gives_conflict_free_fragment_loads(W):
    """Each half-warp's 8-byte fragment loads (lanes g = 0..3 or 4..7,
    t = 0..3, words 8k + 2t and 8k + 2t + 1 of row g) fall on 32
    distinct banks of 4 bytes."""
    Wp = dice_cuda.k1_row_stride(W)
    assert Wp >= W and Wp % 8 == 0 and Wp % 32 == 8
    for k in range(-(-W // 8)):
        for half in (range(16), range(16, 32)):
            banks = [((lane >> 2) * Wp + 8 * k + 2 * (lane & 3) + i) % 32
                     for lane in half for i in (0, 1)]
            assert len(set(banks)) == 32
