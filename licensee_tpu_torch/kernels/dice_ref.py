"""Plain PyTorch Dice scorers: the counterpart of `licensee_tpu/kernels/dice_xla.py`.

These are the oracle every hand-written kernel (`kernels/dice_cuda.py`)
is held against, and what the kernels' wrappers run for a tensor on the
CPU.  Every function takes and returns torch tensors on one device and
keeps the JAX package's layouts, so a test can hand the same numpy
arrays to both packages and compare bit for bit:

    overlap[b, t] = popcount(file_bits[b] & template_bits[t])

then the exact int32 score algebra of the reference
(`content_helper.rb:128-133`, `337-347`), and an exact first-max argmax
over templates in int64.

Packed bitsets are uint32 in the JAX package.  torch's uint32 support is
partial, so the port carries them as int32 views of the same bits
(``np.ndarray.view(np.int32)``): AND and the popcount below are
bit-identical on the view.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# elements of a B×T×W (or B×V) intermediate materialised at once: the
# plain versions chunk over B so a full-width batch (B=262144, T=608,
# W=132 is ~2·10^10 pairs) never has to fit in memory
_CHUNK_ELEMS = 1 << 25


@dataclass(frozen=True)
class CorpusTensors:
    """Template constants on one device (see corpus/compiler.py); the
    counterpart of `dice_xla.CorpusArrays`."""

    bits: torch.Tensor         # int32[T, W] — uint32 bitsets viewed as int32
    n_wf: torch.Tensor         # int32[T]
    n_fieldset: torch.Tensor   # int32[T]
    field_count: torch.Tensor  # int32[T]
    alt_count: torch.Tensor    # int32[T]
    length: torch.Tensor       # int32[T]
    cc_flag: torch.Tensor      # bool[T]
    valid: torch.Tensor        # bool[T] — False for padding templates

    @staticmethod
    def from_compiled(corpus, device="cpu", pad_to: int | None = None):
        """The corpus constants as tensors on ``device``; ``pad_to`` adds
        padding templates (``valid=False``) as `CorpusArrays` does."""
        T = corpus.n_templates
        padded_t = pad_to or T

        def pad(a, dtype):
            out = np.zeros((padded_t, *a.shape[1:]), dtype=a.dtype)
            out[:T] = a
            return torch.from_numpy(out.view(dtype)).to(device)

        valid = np.zeros(padded_t, dtype=bool)
        valid[:T] = True
        return CorpusTensors(
            bits=pad(np.asarray(corpus.bits, dtype=np.uint32), np.int32),
            n_wf=pad(np.asarray(corpus.n_wf, dtype=np.int32), np.int32),
            n_fieldset=pad(np.asarray(corpus.n_fieldset, np.int32), np.int32),
            field_count=pad(np.asarray(corpus.field_count, np.int32), np.int32),
            alt_count=pad(np.asarray(corpus.alt_count, np.int32), np.int32),
            length=pad(np.asarray(corpus.length, np.int32), np.int32),
            cc_flag=pad(np.asarray(corpus.cc_flag, dtype=bool), bool),
            valid=torch.from_numpy(valid).to(device),
        )

    @property
    def n_templates(self) -> int:
        return self.bits.shape[0]


def _row_chunk(per_row: int) -> int:
    return max(1, _CHUNK_ELEMS // max(1, per_row))


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount (Hacker's Delight 5-2, as `dice_pallas._popcount_u32`)
    of int64 values in [0, 2^32): widened first, so the multiply cannot
    carry into a sign bit."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def overlap_popcount(file_bits: torch.Tensor, tpl_bits: torch.Tensor):
    """popcount(file & template) summed over lanes -> int32[B, T]."""
    B, W = file_bits.shape
    T = tpl_bits.shape[0]
    out = torch.empty((B, T), dtype=torch.int32, device=file_bits.device)
    step = _row_chunk(T * W)
    for s in range(0, B, step):
        inter = file_bits[s : s + step, None, :] & tpl_bits[None, :, :]
        counts = _popcount32(inter.to(torch.int64) & 0xFFFFFFFF)
        out[s : s + step] = counts.sum(dim=-1).to(torch.int32)
    return out


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """int32[N, W] bitsets -> int8[N, 32·W], bit i of lane w at column
    w·32 + i (the lane-major order of `dice_xla._unpack_bits`)."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    expanded = (packed[:, :, None] >> shifts) & 1
    return expanded.to(torch.int8).reshape(packed.shape[0], -1)


def contract_unpacked(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Exact int32[N, M] = lhs · rhsᵀ for 0/1 int8 operands [N, V], [M, V].

    torch has no integer matmul on CUDA (bar the library kernel
    ``torch._int_mm``, which the port does not call), so on the card the
    product runs in float32 with TF32 switched off for the call: exact,
    since every sum is an integer below V < 2^24.  On the CPU it runs in
    int64."""
    if lhs.device.type != "cuda":
        return (lhs.to(torch.int64) @ rhs.to(torch.int64).T).to(torch.int32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (lhs.to(torch.float32) @ rhs.to(torch.float32).T).to(
            torch.int32
        )
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def overlap_unpacked(file_bits: torch.Tensor, rhs: torch.Tensor):
    """int32[B, T] = unpack(file_bits) · rhsᵀ for the already unpacked
    templates ``rhs`` int8[T, 32·W], unpacking the blobs in row chunks."""
    B, W = file_bits.shape
    out = torch.empty(
        (B, rhs.shape[0]), dtype=torch.int32, device=file_bits.device
    )
    step = _row_chunk(32 * W)
    for s in range(0, B, step):
        out[s : s + step] = contract_unpacked(
            unpack_bits(file_bits[s : s + step]), rhs
        )
    return out


def overlap_matmul(file_bits: torch.Tensor, tpl_bits: torch.Tensor):
    """The bit intersection as a 0/1 contraction -> int32[B, T]."""
    return overlap_unpacked(file_bits, unpack_bits(tpl_bits))


def overlap_pairs(ct: CorpusTensors, file_bits, method: str = "popcount"):
    """int32[B, T] intersection sizes; raises on unknown method."""
    if method == "matmul":
        return overlap_matmul(file_bits, ct.bits)
    if method == "popcount":
        return overlap_popcount(file_bits, ct.bits)
    raise ValueError(f"unknown scoring method: {method!r}")


def dice_algebra(overlap, n_words, lengths, cc_fp, n_wf, n_fieldset,
                 field_count, alt_count, tpl_len, cc_flag, valid):
    """The exact int32 score algebra on per-template columns ([T]) and
    per-blob columns ([B]); the one definition `finish_scores` and the
    fused kernel's plain version share.

    denom = n_wf + n_words - n_fieldset + adj // 4, with
    adj = max(|len_t - len_b| - 5·max(field_count, alt_count), 0)
    (content_helper.rb:128-133, 337-347).  Excluded pairs (CC guard,
    padding templates) get (-1, 1) so they never win the ranking."""
    total = n_wf[None, :] + n_words[:, None] - n_fieldset[None, :]
    delta = (tpl_len[None, :] - lengths[:, None]).abs()
    adj = torch.clamp_min(
        delta - 5 * torch.maximum(field_count, alt_count)[None, :], 0
    )
    denom = total + torch.div(adj, 4, rounding_mode="floor")
    excluded = (cc_flag[None, :] & cc_fp[:, None]) | ~valid[None, :]
    minus_one = torch.full_like(overlap, -1)
    one = torch.ones_like(overlap)
    num = torch.where(excluded, minus_one, overlap)
    den = torch.where(excluded | (denom <= 0), one, denom.to(torch.int32))
    return num, den


def finish_scores(ct: CorpusTensors, overlap, n_words, lengths, cc_fp):
    """(numerator, denominator) int32[B, T] from overlaps (as
    `dice_xla.finish_scores`)."""
    return dice_algebra(
        overlap, n_words, lengths, cc_fp, ct.n_wf, ct.n_fieldset,
        ct.field_count, ct.alt_count, ct.length, ct.cc_flag, ct.valid,
    )


def score_pairs(ct: CorpusTensors, file_bits, n_words, lengths, cc_fp,
                method: str = "popcount"):
    """Exact (numerator, denominator) for every (blob, template) pair."""
    overlap = overlap_pairs(ct, file_bits, method)
    return finish_scores(ct, overlap, n_words, lengths, cc_fp)


def argmax_exact(num: torch.Tensor, den: torch.Tensor):
    """First-max over templates by exact int64 fraction comparison
    (a/b > c/d ⟺ a·d > c·b for positive denominators); ties go to the
    lower template index.  The pairwise tournament of
    `dice_xla._argmax_exact`: log2(T) vectorised halvings, whose winner
    is the sequential first-max scan's.

    Returns (idx int32[B], num int32[B], den int32[B])."""
    B, T = num.shape
    n = num.to(torch.int64)
    d = den.to(torch.int64)
    idx = torch.arange(T, dtype=torch.int32, device=num.device).expand(B, T)
    width = T
    while width > 1:
        half = (width + 1) // 2
        rest = width - half  # the right side is shorter on odd widths
        ln, ld, li = n[:, :rest], d[:, :rest], idx[:, :rest]
        rn, rd, ri = n[:, half:width], d[:, half:width], idx[:, half:width]
        lp = ln * rd
        rp = rn * ld
        better = (rp > lp) | ((rp == lp) & (ri < li))
        n = torch.cat([torch.where(better, rn, ln), n[:, rest:half]], dim=1)
        d = torch.cat([torch.where(better, rd, ld), d[:, rest:half]], dim=1)
        idx = torch.cat(
            [torch.where(better, ri, li), idx[:, rest:half]], dim=1
        )
        width = half
    return idx[:, 0], n[:, 0].to(torch.int32), d[:, 0].to(torch.int32)


def best_match(ct: CorpusTensors, file_bits, n_words, lengths, cc_fp,
               method: str = "popcount"):
    """Top-1 (index, overlap, denominator) per blob."""
    num, den = score_pairs(ct, file_bits, n_words, lengths, cc_fp, method)
    return argmax_exact(num, den)


def topk_candidates(num: torch.Tensor, den: torch.Tensor, k: int):
    """Top-k (index, num, den) int32[B, k] columns in exact score order,
    as `dice_xla.topk_candidates`: k rounds of `argmax_exact`, each
    round's winner masked to the excluded (-1, 1).  Once a row's
    remaining entries are all (-1, 1), a later round picks the lowest
    index among them, which may be a template an earlier round took;
    those repeats come back as they are (the host drops them by their
    score, which is below 0)."""
    B, T = num.shape
    col = torch.arange(T, dtype=torch.int32, device=num.device)[None, :]
    k_idx, k_num, k_den = [], [], []
    n, d = num, den
    for _ in range(k):
        idx, nn, dd = argmax_exact(n, d)
        k_idx.append(idx)
        k_num.append(nn)
        k_den.append(dd)
        won = col == idx[:, None]
        n = torch.where(won, -1, n)
        d = torch.where(won, 1, d)
    empty = torch.empty((B, 0), dtype=torch.int32, device=num.device)
    return tuple(
        torch.stack(c, dim=1).to(torch.int32) if c else empty
        for c in (k_idx, k_num, k_den)
    )
