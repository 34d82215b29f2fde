"""K4's top-k redesigned: the sort form of the k rounds, and CPU models
of the two CUDA designs, against the JAX package.

The k rounds of the masked first-max (`dice_xla.topk_candidates`,
`dice_ref.topk_candidates`) reduce to a sort on the planes the score
algebra gives (real entries num >= 0 and den >= 1, excluded ones exactly
(-1, 1)): the real entries in (value desc, index asc) order, then
(0, -1, 1) once they run out.  The first tests pin that rule on random
planes, forced ties, all-excluded rows, rows with fewer reals than k,
numerators and denominators near 2^31, and every k from 1 past T.  Then
models of what no CPU can run, step by step as the CUDA sources do it:
K1's top-k epilogue (`csrc/dice_score_fused.cu`: a sorted list per lane
and row, the quad's shuffle merge, the template splits' lists merged in
shuffled order) and `topk_exact`'s two designs (`csrc/dice_topk.cu`: a
lane group's lists and its shuffle merge; the bitonic sort network).
Last, the plain versions `topk_fused` and `topk_exact` run on CPU
tensors against `dice_xla`.  Every comparison is exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licensee_tpu.kernels import dice_xla
from licensee_tpu_torch import convert
from licensee_tpu_torch.corpus.compiler import default_corpus
from licensee_tpu_torch.kernels import dice_cuda, dice_ref

torch.set_num_threads(1)

INT_MAX = 2**31 - 1
N_SMS = 132  # an H100 SXM's
EMPTY = (0, -1, 1)

_argmax = jax.jit(dice_xla._argmax_exact)


def jax_rounds(num, den, k):
    """`dice_xla.topk_candidates`'s k masked rounds, each through its
    `_argmax_exact` jitted once per shape (the test below holds this to
    `dice_xla.topk_candidates` itself)."""
    n, d = jnp.asarray(num), jnp.asarray(den)
    col = jnp.arange(n.shape[1], dtype=jnp.int32)[None, :]
    cols = []
    for _ in range(k):
        idx, nn, dd = _argmax(n, d)
        cols.append((idx, nn, dd))
        won = col == idx[:, None]
        n, d = jnp.where(won, -1, n), jnp.where(won, 1, d)
    return tuple(np.stack([np.asarray(c[i]) for c in cols], axis=1)
                 for i in range(3))


def better(a, b):
    """The kernels' order: a before b, on (idx, num, den) triples."""
    lp, rp = a[1] * b[2], b[1] * a[2]
    return lp > rp or (lp == rp and a[0] < b[0])


def sort_form(num, den, k):
    """The rule: each row's real entries in the exact order, the first
    k of them, padded with (0, -1, 1)."""
    out = []
    for nrow, drow in zip(num.tolist(), den.tolist()):
        reals = [(j, n, d) for j, (n, d) in enumerate(zip(nrow, drow))
                 if n >= 0]
        reals.sort(key=functools.cmp_to_key(
            lambda a, b: -1 if better(a, b) else (1 if better(b, a) else 0)))
        out.append((reals + [EMPTY] * k)[:k])
    return np.array(out, dtype=np.int64).reshape(len(out), k, 3)


def as_triples(cols):
    return np.stack([np.asarray(c, dtype=np.int64) for c in cols], axis=-1)


def planes(rng, B, T, case):
    """(num, den) int32[B, T] in the algebra's domain."""
    num = rng.integers(0, 3000, (B, T))
    den = rng.integers(1, 6000, (B, T))
    excluded = rng.random((B, T)) < 0.2
    if case == "ties":
        src = rng.integers(0, max(1, T // 3), T)
        num, den = num[:, src], den[:, src]
        num[0], den[0] = 5, 7  # a row of one value
        num[1], den[1] = 10, 14  # the same value, other terms
    elif case == "all-excluded":
        excluded[:] = True
    elif case == "few-reals":
        excluded = rng.random((B, T)) < 0.85
        excluded[0] = True
        excluded[0, T - 1] = False  # one real entry, the last
    elif case == "near-2^31":
        num = rng.choice([0, 1, INT_MAX - 1, INT_MAX], (B, T))
        den = rng.choice([1, 2, INT_MAX - 2, INT_MAX], (B, T))
    num = np.where(excluded, -1, num).astype(np.int32)
    den = np.where(excluded, 1, den).astype(np.int32)
    return np.ascontiguousarray(num), np.ascontiguousarray(den)


CASES = ["random", "ties", "all-excluded", "few-reals", "near-2^31"]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("T", [1, 2, 7, 13, 19])
@pytest.mark.parametrize("case", CASES)
def test_sort_form_equals_the_rounds(case, T, seed):
    """Every k from 1 to T + 2: the sort form against the port's rounds
    and the JAX package's (k rounds are the first k columns of T + 2)."""
    rng = np.random.default_rng([CASES.index(case), T, seed])
    num, den = planes(rng, 5, T, case)
    K = T + 2
    ref = as_triples(dice_ref.topk_candidates(
        torch.from_numpy(num), torch.from_numpy(den), K))
    np.testing.assert_array_equal(ref, as_triples(jax_rounds(num, den, K)))
    for k in range(1, K + 1):
        np.testing.assert_array_equal(sort_form(num, den, k), ref[:, :k])


@pytest.mark.parametrize("T, k", [(7, 3), (19, 19), (47, 4)])
def test_rounds_equal_dice_xla_topk_candidates(T, k):
    """`jax_rounds` is `dice_xla.topk_candidates` itself."""
    rng = np.random.default_rng(T + k)
    num, den = planes(rng, 6, T, "ties")
    want = [np.asarray(a) for a in jax.jit(
        lambda n, d: dice_xla.topk_candidates(n, d, k))(num, den)]
    for a, b in zip(jax_rounds(num, den, k), want):
        np.testing.assert_array_equal(a, b)


# -- the CUDA designs, modelled ----------------------------------------------


def order(a, i, j):
    """csrc's compare-exchange: a[i] before a[j] afterwards."""
    if better(a[j], a[i]):
        a[i], a[j] = a[j], a[i]


def sort4(a, o=0):
    """Batcher's 5-exchange network on a[o:o + 4]."""
    for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        order(a, o + i, o + j)


def sort8(a):
    """Batcher's 19-exchange network on a[:8]."""
    sort4(a, 0)
    sort4(a, 4)
    for i, j in ((0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5), (1, 2),
                 (3, 4), (5, 6)):
        order(a, i, j)


def bitonic_sort(a):
    n = len(a)
    size = 2
    while size <= n:
        stride = size // 2
        while stride:
            for i in range(n):
                j = i ^ stride
                if j > i:
                    if i & size:
                        order(a, j, i)
                    else:
                        order(a, i, j)
            stride //= 2
        size *= 2


def merge_reversed(lst, rev):
    """csrc's `merge_reversed`: the elementwise better of ``lst`` and the
    other list reversed, then the bitonic half-cleaners."""
    km = len(lst)
    for i in range(km):
        if better(rev[i], lst[i]):
            lst[i] = rev[i]
    j = km // 2
    while j:
        for i in range(km):
            if not i & j:
                order(lst, i, i + j)
        j //= 2


def merge_candidates(lst, cand):
    """csrc's `merge_chunk` / `merge_block`: the candidates' best KM by a
    network (4 of 8: both halves sorted, then merged; 8 of 8: sort8;
    else the bitonic sort), reversed, merged into ``lst``."""
    km, c = len(lst), list(cand)
    if km == 4 and len(c) == 8:
        sort4(c, 0)
        sort4(c, 4)
        top = c[:4]
        merge_reversed(top, c[:3:-1])
    else:
        (sort8 if len(c) == 8 else bitonic_sort)(c)
        top = c[:km]
    merge_reversed(lst, top[::-1])


def list_len(k):
    """The compiled list lengths: K1 takes 4 or 8, `topk_exact` 4, 8 or
    16."""
    return next(km for km in (4, 8, 16) if k <= km)


def topk_fused_model(num, den, W, n_sms, k, rng):
    """K1's top-k epilogue as csrc/dice_score_fused.cu runs it: per
    template slice of the split, each quad lane (t) scores its column
    pairs (8j + 2t, 8j + 2t + 1) of each chunk, and the chunk's real ones
    go through the network into its sorted list; the quad merges over
    xor 1 and 2; the slices' first-k lists merge in shuffled order from
    empty slots."""
    B, T = num.shape
    splits, per_split, tc = dice_cuda.topk_fused_schedule(B, T, W, n_sms)
    km = list_len(k)
    out = []
    for b in range(B):
        partials = []
        for s in range(splits):
            t_lo, t_hi = s * per_split, min(T, (s + 1) * per_split)
            lanes = []
            for t in range(4):
                lst = [EMPTY] * km
                for t0 in range(t_lo, t_hi, tc):
                    nt = min(tc, t_hi - t0)
                    cand = [EMPTY] * 8  # two columns of each of 4 n8 tiles
                    for j in range(tc // 8):
                        for e in range(2):
                            col = 8 * j + 2 * t + e
                            if col < nt and num[b, t0 + col] >= 0:
                                cand[2 * j + e] = (t0 + col,
                                                   int(num[b, t0 + col]),
                                                   int(den[b, t0 + col]))
                    merge_candidates(lst, cand)
                lanes.append(lst)
            for mask in (1, 2):
                lanes = [merged(lanes[i], lanes[i ^ mask]) for i in range(4)]
            assert all(lane == lanes[0] for lane in lanes)
            partials.append(lanes[0][:k])
        acc = [EMPTY] * km
        for s in rng.permutation(splits):
            padded = partials[s] + [EMPTY] * (km - k)
            merge_reversed(acc, padded[::-1])
        out.append(acc[:k])
    return np.array(out, dtype=np.int64)


def merged(lst, other):
    out = list(lst)
    merge_reversed(out, other[::-1])
    return out


def group_model(num, den, k, lanes_n):
    """`topk_exact`'s small-k design as csrc/dice_topk.cu runs it: lane
    ``sub`` of a row's group takes its entries sub, sub + G, ... in
    blocks of max(KM, 8) through the network into its list, then the
    group merges over xor 1, 2, ..., G/2; every lane ends with the same
    list."""
    B, T = num.shape
    km = list_len(k)
    out = []
    for b in range(B):
        lanes = []
        n = max(km, 8)
        for sub in range(lanes_n):
            lst = [EMPTY] * km
            for j0 in range(sub, T, n * lanes_n):
                block = [EMPTY] * n
                for i in range(n):
                    j = j0 + i * lanes_n
                    if j < T and num[b, j] >= 0:
                        block[i] = (j, int(num[b, j]), int(den[b, j]))
                merge_candidates(lst, block)
            lanes.append(lst)
        mask = 1
        while mask < lanes_n:
            lanes = [merged(lanes[i], lanes[i ^ mask])
                     for i in range(lanes_n)]
            mask *= 2
        assert all(lane == lanes[0] for lane in lanes)
        out.append(lanes[0][:k])
    return np.array(out, dtype=np.int64)


def sort_model(num, den, k):
    """`topk_exact`'s large-k design as csrc/dice_topk.cu runs it: each
    row padded to P entries (excluded entries and the padding as empty
    slots), 8 consecutive entries a thread; the bitonic network's
    strides of 8 or more as each entry keeping the better or the worse
    of itself and its partner (`keep`), all at once, the shorter strides
    as compare-exchanges within a thread; then the first k."""
    B, T = num.shape
    lanes, P, _r = dice_cuda.topk_schedule(B, T, k)
    assert lanes == 0 and P >= 8
    out = []
    for row in range(B):
        ent = [(j, int(num[row, j]), int(den[row, j]))
               if j < T and num[row, j] >= 0 else EMPTY for j in range(P)]
        size = 2
        while size <= P:
            stride = size // 2
            while stride >= 8:
                new = []
                for idx, x in enumerate(ent):
                    y = ent[idx ^ stride]
                    first = not idx & stride
                    best_first = not idx & size
                    new.append(y if (first == best_first) == better(y, x)
                               else x)
                ent = new
                stride //= 2
            for stride in (4, 2, 1):
                if stride >= size:
                    continue
                for t0 in range(0, P, 8):
                    for i in range(8):
                        j = i ^ stride
                        if j > i:
                            if (t0 + i) & size:
                                order(ent, t0 + j, t0 + i)
                            else:
                                order(ent, t0 + i, t0 + j)
            size *= 2
        out.append([ent[j] if j < P else EMPTY for j in range(k)])
    return np.array(out, dtype=np.int64)


def reference(num, den, k):
    return as_triples(dice_ref.topk_candidates(
        torch.from_numpy(num), torch.from_numpy(den), k))


@pytest.mark.parametrize("k", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("B, T, W, n_sms", [
    (70, 47, 112, N_SMS),   # 2 blob tiles x 6 slices of 8
    (5, 608, 132, N_SMS),   # 76 slices of 8
    (40, 608, 132, 4),      # one slice, 19 chunks of 32
    (3, 1, 4, N_SMS),
    (9, 33, 8, 2),          # two slices of 24, chunks of 24 and 9
])
def test_topk_fused_model_equals_the_rounds(B, T, W, n_sms, k):
    rng = np.random.default_rng(B * T + k)
    num, den = planes(rng, B, T, "ties" if k % 2 else "near-2^31")
    num[::3] = -1  # rows with every template excluded
    den[::3] = 1
    got = topk_fused_model(num, den, W, n_sms, k, rng)
    np.testing.assert_array_equal(got, reference(num, den, k))


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("k", [1, 4, 8, 9, 16])
@pytest.mark.parametrize("T", [1, 5, 47, 200])
def test_group_model_equals_the_rounds(T, k, lanes):
    """Every lane count the schedule can pick, at ragged T."""
    rng = np.random.default_rng(T * 100 + k + lanes)
    num, den = planes(rng, 3, T, "ties" if T % 2 else "few-reals")
    np.testing.assert_array_equal(group_model(num, den, k, lanes),
                                  reference(num, den, k))


def test_group_model_at_the_schedules_lanes():
    """T=608 at the lanes `topk_schedule` picks for few rows (32) and for
    many (2)."""
    rng = np.random.default_rng(608)
    num, den = planes(rng, 3, 608, "ties")
    for B in (3, 262144):
        lanes = dice_cuda.topk_schedule(B, 608, 4)[0]
        np.testing.assert_array_equal(group_model(num, den, 4, lanes),
                                      reference(num, den, 4))


@pytest.mark.parametrize("T, k", [(1, 17), (5, 20), (19, 19), (47, 47),
                                  (64, 33), (100, 120), (608, 608)])
def test_sort_model_equals_the_rounds(T, k):
    rng = np.random.default_rng(T + k)
    B = 1 if T == 608 else 10
    num, den = planes(rng, B, T, "ties" if T % 2 else "random")
    if B > 1:
        num[1], den[1] = -1, 1
    np.testing.assert_array_equal(sort_model(num, den, k),
                                  reference(num, den, k))


@pytest.mark.parametrize("B, T, k, want", [
    (4096, 47, 4, (8, 0, 0)),       # --closest 3 at B=4096: 8 lanes a row
    (4096, 608, 4, (16, 0, 0)),     # 16 at T=608, 38 entries a lane
    (262144, 47, 4, (2, 0, 0)),     # enough rows: 2 lanes a row
    (262144, 608, 16, (2, 0, 0)),
    (347, 608, 8, (32, 0, 0)),      # few rows: a warp a row
    (9, 3, 4, (1, 0, 0)),           # fewer than 8 entries: one lane
    (4096, 47, 47, (0, 64, 16)),    # k = T: the sort, 16 rows of 64 a block
    (4096, 608, 608, (0, 1024, 1)),
    (5, 1, 17, (0, 8, 128)),        # rows of at least 8 entries
    (7, 8192, 17, (0, 8192, 1)),
])
def test_topk_schedule(B, T, k, want):
    lanes, P, R = got = dice_cuda.topk_schedule(B, T, k)
    assert got == want
    if lanes:
        assert lanes & (lanes - 1) == 0 and lanes <= 32
    else:
        assert P >= T and P & (P - 1) == 0
        assert R * P // 8 <= 1024 and 12 * R * P <= dice_cuda.K1_SMEM_CAP


@pytest.mark.parametrize("B, T, W, want", [
    (4096, 47, 112, (2, 24, 24)),    # the --closest 3 path: 2 slices, not 3
    (4096, 608, 132, (5, 128, 32)),  # as K1's top-1
    (347, 608, 132, (19, 32, 32)),   # the wide slice's Dice-bound rows
    (1565, 47, 112, (2, 24, 24)),
    (262144, 608, 132, (1, 608, 32)),
    (1, 1, 4, (1, 8, 8)),
])
def test_topk_fused_schedule(B, T, W, want):
    splits, per_split, tc = got = dice_cuda.topk_fused_schedule(
        B, T, W, N_SMS)
    assert got == want
    assert (splits - 1) * per_split < T <= splits * per_split
    assert per_split >= min(T, dice_cuda.K1_TC) - 8 or splits == 1


def test_topk_schedule_refuses_too_wide_rows():
    assert dice_cuda.topk_schedule(1, 30000, 16)[0] == 32
    with pytest.raises(ValueError, match="too wide"):
        dice_cuda.topk_schedule(1, 8193, 17)


# -- the plain versions against the JAX package ------------------------------


def features(rng, corpus, B):
    """Blobs: half copies of templates, half random bits; some under the
    CC false-positive flag."""
    bits = np.asarray(corpus.bits)
    T, W = bits.shape
    fb = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
    src = rng.integers(0, T, B)
    fb[::2] = bits[src[::2]]
    n_words = rng.integers(50, 3000, B).astype(np.int32)
    n_words[::2] = np.asarray(corpus.n_wf)[src[::2]]
    return (fb, n_words, rng.integers(100, 60000, B).astype(np.int32),
            rng.random(B) < 0.3)


@pytest.mark.parametrize("k", [1, 4, dice_cuda.K_FUSED_MAX])
def test_topk_fused_plain_matches_jax(k):
    from licensee_tpu.corpus.compiler import default_corpus as jax_corpus

    corpus = default_corpus()
    rng = np.random.default_rng(k)
    feats = features(rng, corpus, 96)
    ct = convert.corpus_tensors(corpus, torch.device("cpu"))
    got = dice_cuda.topk_fused(
        dice_cuda.pack_meta(ct), ct.bits,
        torch.from_numpy(feats[0].view(np.int32)),
        *(torch.from_numpy(f) for f in feats[1:]), k)
    jc = jax_corpus()
    arrays = dice_xla.CorpusArrays(**{
        n: jnp.asarray(getattr(jc, n)) for n in (
            "bits", "n_wf", "n_fieldset", "field_count", "alt_count",
            "length", "cc_flag")}, valid=jnp.ones(jc.n_templates, bool))
    num, den = dice_xla.score_pairs(arrays, *feats)
    want = jax_rounds(np.asarray(num), np.asarray(den), k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("T, k", [(47, 4), (608, 4), (47, 47)])
def test_topk_exact_plain_matches_jax(T, k):
    rng = np.random.default_rng(T * k)
    num, den = planes(rng, 16, T, "ties")
    got = dice_cuda.topk_exact(torch.from_numpy(num), torch.from_numpy(den),
                               k)
    for a, b in zip(got, jax_rounds(num, den, k)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("method, k, route", [
    ("popcount", 4, "K1 + top-k fused (k=4)"),
    ("popcount", 8, "K1 + top-k fused (k=8)"),
    ("popcount", 9, "K1 planes + topk_exact (k=9)"),
    ("matmul", 4, "K2 planes + topk_exact (k=4)"),
    ("popcount", 0, "K1 top-1"),
])
def test_scorer_routes_by_k(method, k, route):
    """The --closest scorer takes the fused top-k up to K_FUSED_MAX and
    K1's planes with `topk_exact` above it, by k; every route gives the
    same candidates."""
    corpus = default_corpus()
    rng = np.random.default_rng(k)
    feats = features(rng, corpus, 40)
    ct = convert.corpus_tensors(corpus, torch.device("cpu"))
    scorer = dice_cuda.make_best_match_fn(ct, method, k)
    assert scorer.route == route
    got = scorer(*feats)
    other = dice_cuda.make_best_match_fn(
        ct, "matmul" if method == "popcount" else "popcount", k)(*feats)
    for a, b in zip(got, other):
        np.testing.assert_array_equal(a, b)
