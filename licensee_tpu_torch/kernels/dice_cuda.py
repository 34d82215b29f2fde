"""The hand-written Hopper Dice kernels and their wrappers.

Counterpart of `licensee_tpu/kernels/dice_pallas.py`, whose two Pallas
TPU kernels become CUDA C++ in `licensee_tpu_torch/csrc/`:

* K1 (csrc/dice_score_fused.cu) replaces `_make_kernel` behind
  `_score_pairs_padded`: the bitset intersection counted on the
  single-bit tensor cores and the exact int32 score algebra in one
  pass.  `best_match_fused`, what the batch path runs, also fuses the
  exact first-max (`dice_xla._argmax_exact`) and gives (idx, num, den)
  int32[B]; `topk_fused`, what the ``--closest`` path runs, fuses K4's
  top-k (k <= `K_FUSED_MAX`) and gives (idx, num, den) int32[B, k];
  `score_pairs_fused` gives the (num, den) int32[B, T] planes.
* K2 `overlap_pairs_mma` (csrc/dice_overlap_mma.cu) replaces
  `_make_mxu_kernel` behind `_overlap_mxu_padded`: the packed blob bits
  spread into wgmma's register operand on chip and contracted against
  the host-unpacked templates (TMA-fed shared memory) on the int8
  tensor cores, giving overlap int32[B, T].
* K4's top-k `topk_exact` (csrc/dice_topk.cu) replaces the XLA graph
  `dice_xla.topk_candidates`: k rounds of the exact first-max over the
  (num, den) planes, each winner masked to (-1, 1), giving (idx, num,
  den) int32[B, k], in one pass over each row (sorting networks into a
  sorted list per lane for small k, a bitonic sort in registers,
  shuffles and shared memory for large k); the
  ``--closest`` path runs it after K2 and the score algebra, and after
  K1's planes where k is above `K_FUSED_MAX`.

Each wrapper runs the kernel for CUDA tensors and its plain PyTorch
version (built on `kernels/dice_ref.py`) for CPU tensors, and counts its
kernel launches in ``LAUNCHES``.  There is no fallback: a CUDA tensor the
kernel cannot take raises.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from licensee_tpu_torch.kernels import dice_ref
from licensee_tpu_torch.kernels.dice_ref import CorpusTensors

# kernel name -> launches since the last reset; a wrapper adds one
# exactly where it launches its kernel
LAUNCHES = {"score_pairs_fused": 0, "best_match_fused": 0,
            "topk_fused": 0, "overlap_pairs_mma": 0, "topk_exact": 0,
            # K5 (`parallel/mesh.py`): one a sharded call on the card,
            # whose shards count their own K1 or K2 launches
            "make_sharded_scorer": 0}
# the serve path launches from its scheduler thread and, during a corpus
# reload, from the reload thread too: the counts and K1's tickets
# (`_tickets`) are shared between them
_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1

# meta-table columns of K1 (int32[T, 8], one row per template), as
# `dice_pallas.pack_corpus` lays them out
N_WF, N_FIELDSET, FIELD_COUNT, ALT_COUNT, LENGTH, CC_FLAG, VALID = range(7)
META_COLS = 8

# K1's tiling, mirrored from csrc/dice_score_fused.cu: 64 blob rows per
# block (four warps of one m16 tile each), templates in chunks of at most
# 32 (four n8 tiles) through a double-buffered shared-memory ring, rows
# strided by `k1_row_stride` words, within 227 KB of shared memory.
K1_BM = 64
K1_TC = 32
K1_SMEM_CAP = 227 * 1024
K1_BLOCKS_PER_SM = 2  # the grid `fused_schedule` aims for at small B

# K2's tiling, mirrored from csrc/dice_overlap_mma.cu.  The unpacked
# template matrix has T rounded up to MMA_TILE_T rows (wgmma's N comes in
# steps of 16; rows past it arrive as TMA's zero fill) and 32 columns per
# packed word; W must be whole 128-column stages of MMA_STAGE_WORDS words.
MMA_TILE_T = 16
MMA_STAGE_WORDS = 4
MMA_BLOCK_B = 128  # blob rows per block
MMA_TILE_N = (16, 48, 64, 128, 208)  # the compiled template tiles

# K1's top-k epilogue (csrc/dice_score_fused.cu): lists of at most 8
# entries per lane and row in registers (ptxas: 210 registers a thread at
# 8, no spills; 16 would not fit)
K_FUSED_MAX = 8

# K4's top-k, mirrored from csrc/dice_topk.cu: at k <= TOPK_LIST_MAX a
# group of lanes per row (`topk_schedule`: enough threads to fill the card
# at small B, TOPK_LANE_ENTRIES entries a lane or more); above, a bitonic
# sort of each row padded to a power of two P, TOPK_SORT_LANE_ENTRIES
# entries a thread in registers, TOPK_SORT_ENTRIES entries a block where
# rows are short, at most TOPK_SORT_MAX entries a row
TOPK_LIST_MAX = 16
TOPK_LANE_ENTRIES = 4
TOPK_THREADS = 1 << 16  # threads the lane groups aim for
TOPK_SORT_LANE_ENTRIES = 8
TOPK_SORT_ENTRIES = 1024
TOPK_SORT_MAX = 8 * 1024


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_meta(ct: CorpusTensors) -> torch.Tensor:
    """K1's per-template constants as one int32[T, 8] table."""
    meta = torch.zeros(
        (ct.n_templates, META_COLS), dtype=torch.int32, device=ct.bits.device
    )
    meta[:, N_WF] = ct.n_wf
    meta[:, N_FIELDSET] = ct.n_fieldset
    meta[:, FIELD_COUNT] = ct.field_count
    meta[:, ALT_COUNT] = ct.alt_count
    meta[:, LENGTH] = ct.length
    meta[:, CC_FLAG] = ct.cc_flag.to(torch.int32)
    meta[:, VALID] = ct.valid.to(torch.int32)
    return meta


def pack_templates_mma(ct: CorpusTensors) -> torch.Tensor:
    """K2's template operand, unpacked once: int8[T_pad, 32·W] with bit
    i of lane w at column 32·w + i (zero padding rows).  W must be whole
    stages of 4 words, as the kernel takes them (lane_align=4)."""
    T, W = ct.bits.shape
    if W % MMA_STAGE_WORDS:
        raise ValueError(
            f"K2 takes whole 128-column stages: W={W} must be a multiple "
            "of 4 (compile the corpus with lane_align=4)"
        )
    out = torch.zeros(
        (_round_up(max(T, 1), MMA_TILE_T), 32 * W),
        dtype=torch.int8,
        device=ct.bits.device,
    )
    out[:T] = dice_ref.unpack_bits(ct.bits)
    return out


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    from licensee_tpu_torch.kernels.build import load_library

    return load_library()


def _launch(dev: torch.device, entry, *args) -> int:
    """Call a C entry point with ``dev``'s current stream as its last
    argument, on ``dev`` (switching the current device only if needed);
    returns its cudaError_t.

    The stream comes from torch's raw accessor (what its own generated
    code launches with), which skips building a `torch.cuda.Stream`
    object on every launch, a large share of a small kernel's host time."""
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(dev, entry, *args)
    return entry(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def _raise_on(err: int, kernel: str) -> None:
    if err == -1:
        raise RuntimeError(f"{kernel}: a TMA tensor map could not be encoded")
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")


# -- K1 ---------------------------------------------------------------------


def k1_row_stride(W: int) -> int:
    """K1's shared-memory row stride in words: W rounded up to whole
    8-word k-steps, then to 8 mod 32, so the 8-byte fragment loads of a
    warp hit 32 distinct banks."""
    w8 = _round_up(W, 8)
    return w8 + (40 - w8 % 32) % 32


def k1_smem_bytes(W: int, tc: int) -> int:
    """K1's dynamic shared memory: the block's blob rows, two template
    chunks of ``tc`` rows and their raw and decoded meta rows."""
    return 4 * k1_row_stride(W) * (K1_BM + 2 * tc) + 4 * 2 * tc * META_COLS \
        + 16 * tc


@functools.lru_cache(maxsize=256)
def fused_schedule(B: int, T: int, W: int, n_sms: int, min_split: int = 8):
    """K1's launch shape: (splits, per_split, tc).

    Where the 64-row blob tiles give fewer than `K1_BLOCKS_PER_SM`
    blocks per SM, the templates are split over that many more blocks
    per tile, in slices of ``per_split`` (whole n8 tiles, none empty,
    and about ``min_split`` templates or more); the main path's B=4096
    at T=47 runs 64 tiles x 3 slices of 16.  Each block streams its
    slice in chunks of ``tc`` templates (at most 32, and less where the
    shared memory would not hold 32).  Raises where W is too wide for
    any chunk."""
    n8 = -(-max(T, 1) // 8)
    tiles = -(-max(B, 1) // K1_BM)
    target = K1_BLOCKS_PER_SM * n_sms
    splits = min(n8, -(-target // tiles)) if tiles < target else 1
    splits = min(splits, -(-max(T, 1) // min_split))
    per_split = 8 * -(-n8 // splits)
    tc = min(K1_TC, per_split)
    while tc > 8 and k1_smem_bytes(W, tc) > K1_SMEM_CAP:
        tc -= 8
    if k1_smem_bytes(W, tc) > K1_SMEM_CAP:
        raise ValueError(
            f"K1 holds a block's 64 blob rows in shared memory: W={W} "
            "words is too wide"
        )
    return -(-max(T, 1) // per_split), per_split, tc


# per (device, stream): one int32 counter per blob tile, zero between
# launches of `best_match_fused` (each launch leaves them zero), so the
# kernel's cross-block merge needs no memset.  Launches that share them
# are ordered on their one stream; launches on two streams (the batch
# path's dispatch stream and a caller's own) each get their own.  Two
# threads may launch on one stream (the serve scheduler and a reload's
# validation): the entry is created and regrown under `_LOCK`, and each
# launch holds the tensor it was given until it has enqueued, so a
# regrow by the other thread cannot free it under the launch.
_TICKETS: dict = {}


def _tickets(dev: torch.device, n: int) -> torch.Tensor:
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    with _LOCK:
        have = _TICKETS.get(key)
        if have is None or have.numel() < n:
            have = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
            _TICKETS[key] = have
    return have


def score_pairs_fused_plain(meta, tpl_bits, file_bits, n_words, lengths,
                            cc_fp):
    """K1's function in plain PyTorch: popcount overlaps, then the score
    algebra on the meta table's columns."""
    overlap = dice_ref.overlap_popcount(file_bits, tpl_bits)
    return dice_ref.dice_algebra(
        overlap, n_words, lengths, cc_fp,
        meta[:, N_WF], meta[:, N_FIELDSET], meta[:, FIELD_COUNT],
        meta[:, ALT_COUNT], meta[:, LENGTH], meta[:, CC_FLAG] == 1,
        meta[:, VALID] == 1,
    )


def best_match_fused_plain(meta, tpl_bits, file_bits, n_words, lengths,
                           cc_fp):
    """K1's fused first-max in plain PyTorch: the planes, then the exact
    int64 tournament."""
    return dice_ref.argmax_exact(*score_pairs_fused_plain(
        meta, tpl_bits, file_bits, n_words, lengths, cc_fp))


def _check_k1(name, meta, tpl_bits, file_bits, n_words, lengths, cc_fp):
    """The checks both K1 entry points make; returns (B, T, W, device)."""
    B, W = file_bits.shape
    T = tpl_bits.shape[0]
    dev = file_bits.device
    _check(meta, "meta", torch.int32, (T, META_COLS), dev)
    _check(tpl_bits, "tpl_bits", torch.int32, (T, W), dev)
    _check(file_bits, "file_bits", torch.int32, (B, W), dev)
    _check(n_words, "n_words", torch.int32, (B,), dev)
    _check(lengths, "lengths", torch.int32, (B,), dev)
    _check(cc_fp, "cc_fp", torch.bool, (B,), dev)
    if W % 4 or any(t.data_ptr() % 16 for t in (meta, tpl_bits, file_bits)):
        raise ValueError(
            f"{name} copies 16-byte pieces: W must be a multiple of 4 and "
            "meta and the bitsets 16-byte aligned"
        )
    return B, T, W, dev


def score_pairs_fused(meta, tpl_bits, file_bits, n_words, lengths, cc_fp):
    """Exact (num, den) int32[B, T] for every (blob, template) pair.

    ``meta`` int32[T, 8] (`pack_meta`), ``tpl_bits`` int32[T, W],
    ``file_bits`` int32[B, W] (uint32 bitsets viewed as int32; W a
    multiple of 4), ``n_words``/``lengths`` int32[B], ``cc_fp`` bool[B]."""
    if file_bits.device.type != "cuda":
        return score_pairs_fused_plain(
            meta, tpl_bits, file_bits, n_words, lengths, cc_fp
        )
    B, T, W, dev = _check_k1("score_pairs_fused", meta, tpl_bits, file_bits,
                             n_words, lengths, cc_fp)
    num = torch.empty((B, T), dtype=torch.int32, device=dev)
    den = torch.empty((B, T), dtype=torch.int32, device=dev)
    if B == 0 or T == 0:
        return num, den
    _, per_split, tc = fused_schedule(B, T, W, _sm_count(dev.index))
    err = _launch(
        dev, _lib().dice_score_fused,
        meta.data_ptr(), tpl_bits.data_ptr(), file_bits.data_ptr(),
        n_words.data_ptr(), lengths.data_ptr(), cc_fp.data_ptr(),
        num.data_ptr(), den.data_ptr(), B, T, W, per_split, tc,
    )
    _count("score_pairs_fused")
    _raise_on(err, "score_pairs_fused")
    return num, den


def best_match_fused(meta, tpl_bits, file_bits, n_words, lengths, cc_fp):
    """The exact top-1 (idx, num, den) int32[B] over T >= 1 templates: the
    first template of greatest num/den (compared in int64) per blob,
    (0, -1, 1) where every template is excluded.  Takes what
    `score_pairs_fused` takes; one launch, no [B, T] planes."""
    if file_bits.device.type != "cuda":
        return best_match_fused_plain(
            meta, tpl_bits, file_bits, n_words, lengths, cc_fp
        )
    B, T, W, dev = _check_k1("best_match_fused", meta, tpl_bits, file_bits,
                             n_words, lengths, cc_fp)
    if T == 0:
        raise ValueError("best_match_fused needs at least one template")
    if B == 0:
        return torch.empty((3, 0), dtype=torch.int32, device=dev).unbind(0)
    splits, per_split, tc = fused_schedule(B, T, W, _sm_count(dev.index))
    # one allocation: the (idx, num, den) rows, then, where the templates
    # are split over blocks, the blocks' partial bests
    buf = torch.empty(3 * B * (1 + (splits if splits > 1 else 0)),
                      dtype=torch.int32, device=dev)
    ptr = buf.data_ptr()
    scratch = tickets = held = None
    if splits > 1:
        scratch = ptr + 4 * 3 * B
        held = _tickets(dev, -(-B // K1_BM))
        tickets = held.data_ptr()
    err = _launch(
        dev, _lib().dice_best_fused,
        meta.data_ptr(), tpl_bits.data_ptr(), file_bits.data_ptr(),
        n_words.data_ptr(), lengths.data_ptr(), cc_fp.data_ptr(),
        ptr, ptr + 4 * B, ptr + 8 * B, scratch, tickets,
        B, T, W, per_split, tc,
    )
    del held  # enqueued: a regrow may free the tickets now
    _count("best_match_fused")
    _raise_on(err, "best_match_fused")
    return buf[: 3 * B].view(3, B).unbind(0)


# -- K2 ---------------------------------------------------------------------


def overlap_pairs_mma_plain(tpl_unpacked, file_bits, n_templates: int):
    """K2's function in plain PyTorch: unpack the blob bits in the same
    lane-major order and contract them against the unpacked templates."""
    W = file_bits.shape[1]
    return dice_ref.overlap_unpacked(
        file_bits, tpl_unpacked[:n_templates, : 32 * W]
    )


@functools.lru_cache(maxsize=256)
def mma_schedule(B: int, T: int, W: int, n_sms: int):
    """K2's launch shape: (bn, splits).

    ``bn`` is the narrowest compiled template tile (`MMA_TILE_N`) that
    covers T in the fewest tiles of at most 208, so T=47 runs one tile
    of 48 and T=608 three of 208.  Where the grid of (template tile,
    128-row blob tile) pairs has fewer blocks than the card has SMs,
    ``splits`` > 1 spreads the W/4 stages of the contraction over that
    many blocks per pair, none of them empty, and their partial sums are
    added into a zeroed output."""
    t16 = _round_up(max(T, 1), MMA_TILE_T)
    want = _round_up(-(-t16 // -(-t16 // MMA_TILE_N[-1])), MMA_TILE_T)
    bn = min(n for n in MMA_TILE_N if n >= want)
    grid = -(-T // bn) * -(-B // MMA_BLOCK_B)
    n_stages = max(1, W // MMA_STAGE_WORDS)
    splits = 1
    if grid < n_sms:
        splits = min(n_stages, max(1, n_sms // grid))
        per = -(-n_stages // splits)
        splits = -(-n_stages // per)
    return bn, splits


def overlap_pairs_mma(tpl_unpacked, file_bits, n_templates: int):
    """overlap int32[B, T] = unpack(file_bits) · unpack(templates)ᵀ.

    ``tpl_unpacked`` int8[T_pad, V_pad] (`pack_templates_mma`),
    ``file_bits`` int32[B, W] (uint32 bitsets viewed as int32; W a
    multiple of 4), ``n_templates`` the T of the output."""
    if file_bits.device.type != "cuda":
        return overlap_pairs_mma_plain(tpl_unpacked, file_bits, n_templates)
    B, W = file_bits.shape
    T = int(n_templates)
    t_pad, v_pad = tpl_unpacked.shape
    dev = file_bits.device
    if W % MMA_STAGE_WORDS:
        raise ValueError(
            f"overlap_pairs_mma loads 128-column stages with TMA: W={W} "
            "must be a multiple of 4 (compile the corpus with lane_align=4)"
        )
    if t_pad % MMA_TILE_T or T > t_pad or v_pad != 32 * W:
        raise ValueError(
            f"tpl_unpacked {tuple(tpl_unpacked.shape)} does not fit "
            f"T={T}, W={W} (see pack_templates_mma)"
        )
    _check(tpl_unpacked, "tpl_unpacked", torch.int8, (t_pad, v_pad), dev)
    _check(file_bits, "file_bits", torch.int32, (B, W), dev)
    if file_bits.data_ptr() % 16 or tpl_unpacked.data_ptr() % 16:
        raise ValueError("overlap_pairs_mma: TMA needs 16-byte aligned operands")
    if B == 0 or T == 0:
        return torch.empty((B, T), dtype=torch.int32, device=dev)
    bn, splits = mma_schedule(B, T, W, _sm_count(dev.index))
    # where the stages are split, the C entry point zeroes `out` on the
    # stream before the blocks add their partial sums into it
    out = torch.empty((B, T), dtype=torch.int32, device=dev)
    err = _launch(
        dev, _lib().dice_overlap_mma,
        tpl_unpacked.data_ptr(), file_bits.data_ptr(), out.data_ptr(),
        B, T, W, t_pad, bn, splits,
    )
    _count("overlap_pairs_mma")
    _raise_on(err, "overlap_pairs_mma")
    return out


# -- K4's top-k --------------------------------------------------------------


def topk_exact_plain(num, den, k: int):
    """K4's top-k in plain PyTorch (`dice_ref.topk_candidates`)."""
    return dice_ref.topk_candidates(num, den, k)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _pow2_at_most(n: int) -> int:
    return 1 << max(0, int(n).bit_length() - 1)


@functools.lru_cache(maxsize=1024)
def topk_schedule(B: int, T: int, k: int):
    """`topk_exact`'s design for B rows of T templates and k candidates:
    (lanes, P, R).  At k <= TOPK_LIST_MAX, ``lanes`` > 0 lanes per row: a
    power of two, as many as TOPK_THREADS threads over B rows ask for
    but no more than leave TOPK_LANE_ENTRIES entries a lane, at least 2
    (where T allows) and at most 32 (B=4096: 8 at T=47, 16 at T=608;
    B=262144: 2 at both), with P = R = 0.  Above it, ``lanes`` = 0 and a
    bitonic sort of rows padded to P entries (the power of two >= T, at
    least 8), R rows a block.  Raises where a row would need more than a
    block's 1024 threads."""
    if k <= TOPK_LIST_MAX:
        want = _pow2_at_least(-(-TOPK_THREADS // max(B, 1)))
        most = _pow2_at_most(max(T, 1) // TOPK_LANE_ENTRIES or 1)
        least = 2 if T >= 2 * TOPK_LANE_ENTRIES else 1
        return min(32, max(least, min(want, most))), 0, 0
    P = max(TOPK_SORT_LANE_ENTRIES, _pow2_at_least(T))
    if P > TOPK_SORT_MAX:
        raise ValueError(
            f"topk_exact sorts a row in one block at k > {TOPK_LIST_MAX}: "
            f"T={T} templates is too wide (at most {TOPK_SORT_MAX})"
        )
    return 0, P, max(1, TOPK_SORT_ENTRIES // P)


def topk_exact(num, den, k: int):
    """The exact top-k (idx, num, den) int32[B, k] of each row of the
    (num, den) int32[B, T] planes, as k rounds of the first-max give it,
    each winner masked to (-1, 1); column 0 is the exact top-1.  Takes
    what `score_pairs_fused` (or K2 and `dice_ref.finish_scores`) gives:
    real entries num >= 0, den >= 1, excluded ones exactly (-1, 1)."""
    if num.device.type != "cuda":
        return topk_exact_plain(num, den, k)
    B, T = num.shape
    dev = num.device
    _check(num, "num", torch.int32, (B, T), dev)
    _check(den, "den", torch.int32, (B, T), dev)
    k = int(k)
    if k < 0 or T < 1:
        raise ValueError(f"topk_exact needs k >= 0 and T >= 1 (k={k}, T={T})")
    buf = torch.empty((3, B, k), dtype=torch.int32, device=dev)
    if B == 0 or k == 0:
        return buf.unbind(0)
    lanes, P, R = topk_schedule(B, T, k)
    err = _launch(
        dev, _lib().dice_topk_exact,
        num.data_ptr(), den.data_ptr(), buf.data_ptr(), B, T, k, lanes, P, R,
    )
    _count("topk_exact")
    _raise_on(err, "topk_exact")
    return buf.unbind(0)


def topk_fused_schedule(B: int, T: int, W: int, n_sms: int):
    """`topk_fused`'s launch shape: K1's (`fused_schedule`), its template
    slices at least a whole chunk of `K1_TC`: each split costs a list
    merge across blocks, which a slice of 8 or 16 templates does not
    repay (B=4096 at T=47 runs 2 slices of 24, not 3 of 16)."""
    return fused_schedule(B, T, W, n_sms, min_split=K1_TC)


def topk_fused_plain(meta, tpl_bits, file_bits, n_words, lengths, cc_fp,
                     k: int):
    """K1's fused top-k in plain PyTorch: the planes, then the k rounds
    (`dice_ref.topk_candidates`)."""
    return dice_ref.topk_candidates(*score_pairs_fused_plain(
        meta, tpl_bits, file_bits, n_words, lengths, cc_fp), k)


def topk_fused(meta, tpl_bits, file_bits, n_words, lengths, cc_fp, k: int):
    """The exact top-k (idx, num, den) int32[B, k] over T >= 1 templates,
    1 <= k <= `K_FUSED_MAX`: what `topk_exact` gives on
    `score_pairs_fused`'s planes, in one launch of K1 with no [B, T]
    planes.  Takes what `score_pairs_fused` takes, and k."""
    if file_bits.device.type != "cuda":
        return topk_fused_plain(
            meta, tpl_bits, file_bits, n_words, lengths, cc_fp, k
        )
    B, T, W, dev = _check_k1("topk_fused", meta, tpl_bits, file_bits,
                             n_words, lengths, cc_fp)
    k = int(k)
    if T == 0 or not 1 <= k <= K_FUSED_MAX:
        raise ValueError(
            f"topk_fused needs T >= 1 and 1 <= k <= {K_FUSED_MAX} "
            f"(T={T}, k={k})"
        )
    if B == 0:
        return torch.empty((3, 0, k), dtype=torch.int32, device=dev).unbind(0)
    splits, per_split, tc = topk_fused_schedule(B, T, W,
                                                _sm_count(dev.index))
    # one allocation: the (idx, num, den) rows, then, where the templates
    # are split over blocks, the blocks' partial lists
    buf = torch.empty(3 * B * k * (1 + (splits if splits > 1 else 0)),
                      dtype=torch.int32, device=dev)
    ptr = buf.data_ptr()
    scratch = tickets = held = None
    if splits > 1:
        scratch = ptr + 4 * 3 * B * k
        held = _tickets(dev, -(-B // K1_BM))
        tickets = held.data_ptr()
    err = _launch(
        dev, _lib().dice_topk_fused,
        meta.data_ptr(), tpl_bits.data_ptr(), file_bits.data_ptr(),
        n_words.data_ptr(), lengths.data_ptr(), cc_fp.data_ptr(),
        ptr, ptr + 4 * B * k, ptr + 8 * B * k, scratch, tickets,
        B, T, W, per_split, tc, k,
    )
    del held  # enqueued: a regrow may free the tickets now
    _count("topk_fused")
    _raise_on(err, "topk_fused")
    return buf[: 3 * B * k].view(3, B, k).unbind(0)


# -- the scorer the batch path dispatches ------------------------------------

# --method names, kept from the JAX package's CLI; in this port each
# runs one of the two kernels on the card and its plain version on the CPU
K1_METHODS = ("popcount", "pallas")
K2_METHODS = ("matmul", "pallas-mxu")


def dispatch_stream(index: int, lane: int = 0) -> "torch.cuda.Stream":
    """The stream a device lane of the batch path dispatches on (one per
    device and lane): with several groups in flight, each chunk's copies
    to the card, its launches (and K1's tickets, `_tickets`) and its
    copy back queue in order behind the lane's chunks before it."""
    # one cache key however the lane is passed
    return _dispatch_stream(index, lane)


@functools.cache
def _dispatch_stream(index: int, lane: int) -> "torch.cuda.Stream":
    return torch.cuda.Stream(device=index)


class HostRows:
    """Host staging rows for one dispatch chunk of up to ``capacity``
    rows: the four feature columns the scorer reads and the candidates
    it writes back, as tensors and as numpy views of the same memory.
    The candidates are the top-1 (idx, num, den), or with ``k`` > 0 the
    top-k (idx, num, den) planes of k columns each.  Pinned (page-locked)
    for a scorer on a card, so the copies both ways run asynchronously
    on the dispatch stream; the memory must then not be refilled before
    the chunk's event completes."""

    __slots__ = ("capacity", "k", "lane", "tensors", "bits", "n_words",
                 "lengths", "cc_fp", "out")

    def __init__(self, capacity: int, n_lanes: int, pin: bool, k: int = 0,
                 lane: int = 0):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, pin_memory=pin)

        self.capacity = capacity
        self.k = k
        self.lane = lane  # the device lane whose staging ring owns it
        self.tensors = (
            zeros((capacity, n_lanes), torch.int32),
            zeros(capacity, torch.int32),
            zeros(capacity, torch.int32),
            zeros(capacity, torch.bool),
            # (idx, num, den), 3 x n (top-1) or 3 x n x k (top-k)
            zeros(3 * capacity * max(k, 1), torch.int32),
        )
        fb, nw, ln, cf, out = (t.numpy() for t in self.tensors)
        self.bits = fb.view(np.uint32)
        self.n_words, self.lengths, self.cc_fp, self.out = nw, ln, cf, out

    def fill(self, bits, n_words, lengths, cc_fp) -> int:
        """Copy ``n`` live rows into the first ``n`` rows; returns n."""
        n = len(n_words)
        if n > self.capacity:
            raise ValueError(f"{n} rows exceed the slot's {self.capacity}")
        self.bits[:n] = bits
        self.n_words[:n] = n_words
        self.lengths[:n] = lengths
        self.cc_fp[:n] = cc_fp
        return n

    def result(self, n: int) -> tuple:
        """The candidates of the first ``n`` rows, as the JAX package's
        scorers return them: (idx, num, den) int32[n], and with ``k`` > 0
        then the top-k (idx, num, den) int32[n, k], whose column 0 is
        the top-1.  Views: copy them before the slot is refilled."""
        if not self.k:
            return tuple(self.out[: 3 * n].reshape(3, n))
        cols = self.out[: 3 * n * self.k].reshape(3, n, self.k)
        return (*cols[:, :, 0], *cols)


class BestMatchScorer:
    """The scorer the batch path dispatches, closed over the corpus
    constants on ``ct``'s device: for each staged row the exact top-1
    (idx, num, den), or with ``k`` > 0 the exact top-k candidates
    (`HostRows.result`).

    Top-1: the K1 methods run the fused first-max (`best_match_fused`,
    one launch); the K2 methods run K2, then the score algebra and the
    argmax in PyTorch.  Top-k (``--closest``): the K1 methods run K1
    with the top-k fused (`topk_fused`, one launch, no planes) where k
    is at most `K_FUSED_MAX`, and above it K1's planes
    (`score_pairs_fused`) then `topk_exact`; the K2 methods run K2 and
    the score algebra, then `topk_exact`.  No argmax runs, since the
    top-k's column 0 is the top-1.  ``route`` names the chain chosen,
    which the batch path's dispatch stats carry.

    `submit` is the non-blocking half: on a card it enqueues, on the
    device's dispatch stream, the copies of the staged rows to the card,
    the scoring and the copy of the stacked candidates back into the
    slot, then records and returns a CUDA event; on the CPU the plain
    versions run at once and it returns None.  Calling the scorer on
    numpy rows is the synchronous form of the two."""

    def __init__(self, ct: CorpusTensors, method: str, k: int = 0,
                 lane: int = 0):
        self.device = ct.bits.device
        self.n_lanes = ct.bits.shape[1]
        self.k = int(k)
        fused_k = method in K1_METHODS and 0 < self.k <= K_FUSED_MAX
        if method in K1_METHODS:
            meta = pack_meta(ct)

            def planes(fb, nw, ln, cf):
                return score_pairs_fused(meta, ct.bits, fb, nw, ln, cf)

            def best(fb, nw, ln, cf):
                return best_match_fused(meta, ct.bits, fb, nw, ln, cf)

            def fused(fb, nw, ln, cf):
                return topk_fused(meta, ct.bits, fb, nw, ln, cf, self.k)
        elif method in K2_METHODS:
            tpl = pack_templates_mma(ct)

            def planes(fb, nw, ln, cf):
                overlap = overlap_pairs_mma(tpl, fb, ct.n_templates)
                return dice_ref.finish_scores(ct, overlap, nw, ln, cf)

            def best(fb, nw, ln, cf):
                return dice_ref.argmax_exact(*planes(fb, nw, ln, cf))
        else:
            raise ValueError(f"unknown scoring method: {method!r}")

        def top_k(fb, nw, ln, cf):
            return topk_exact(*planes(fb, nw, ln, cf), self.k)

        kernel = "K1" if method in K1_METHODS else "K2"
        if not self.k:
            self._best, self.route = best, f"{kernel} top-1"
        elif fused_k:
            self._best, self.route = fused, f"K1 + top-k fused (k={self.k})"
        else:
            self._best = top_k
            self.route = f"{kernel} planes + topk_exact (k={self.k})"
        self.stream = (
            dispatch_stream(self.device.index, lane)
            if self.device.type == "cuda" else None
        )
        if self.stream is not None:
            # the corpus constants above were made on the caller's current
            # stream (a serve reload makes them on its own thread): the
            # dispatch stream waits for them before its first launch
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def host_rows(self, capacity: int, lane: int = 0) -> HostRows:
        return HostRows(capacity, self.n_lanes,
                        pin=self.device.type == "cuda", k=self.k, lane=lane)

    def submit(self, rows: HostRows, n: int):
        """Score ``rows``' first ``n`` rows into ``rows.out``; returns the
        event that completes when they have landed (None on the CPU,
        where they already have)."""
        fb, nw, ln, cf = (t[:n] for t in rows.tensors[:4])
        out = rows.tensors[4][: 3 * n * max(self.k, 1)]
        if self.stream is None:
            out.copy_(torch.stack(self._best(fb, nw, ln, cf)).view(-1))
            return None
        with torch.cuda.stream(self.stream):
            dev = self.device
            best = torch.stack(self._best(
                *(t.to(dev, non_blocking=True) for t in (fb, nw, ln, cf))))
            out.copy_(best.view(-1), non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return done

    def __call__(self, file_bits, n_words, lengths, cc_fp):
        """``fn(file_bits, n_words, lengths, cc_fp)`` on numpy rows
        (uint32[B, W] bits, int32[B] columns, bool[B] flags) returns the
        candidates (`HostRows.result`) as numpy int32 arrays."""
        rows = self.host_rows(len(n_words))
        n = rows.fill(file_bits, n_words, lengths, cc_fp)
        done = self.submit(rows, n)
        if done is not None:
            done.synchronize()
        return rows.result(n)


def make_best_match_fn(ct: CorpusTensors, method: str,
                       k: int = 0) -> BestMatchScorer:
    """The scorer for ``method``, top-1 or (``k`` > 0) top-k (see
    `BestMatchScorer`)."""
    return BestMatchScorer(ct, method, k)
