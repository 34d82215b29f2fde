// K1: the fused overlap-and-score Dice kernel for Hopper (sm_90a), with
// the exact first-max fused into its epilogue.
//
// Replaces the Pallas TPU kernel `_make_kernel`, reached through
// `_score_pairs_padded` (licensee_tpu/kernels/dice_pallas.py), and the
// argmax after it (`_argmax_exact`, licensee_tpu/kernels/dice_xla.py).
// For every (blob b, template t):
//
//   overlap = sum_w popcount(file[b, w] & tpl[t, w])
//   denom   = n_wf + n_words - n_fieldset
//             + max(|len_t - len_b| - 5 * max(field_count, alt_count), 0) / 4
//   excluded = (cc_flag[t] && cc_fp[b]) || !valid[t]
//   num = excluded ? -1 : overlap;  den = (excluded || denom <= 0) ? 1 : denom
//
// One mainloop, three epilogues chosen at compile time:
//
// * planes (`dice_score_fused`): (num, den) int32[B, T];
// * best (`dice_best_fused`): per blob the first template of greatest
//   num/den, (idx, num, den) int32[B]; the [B, T] planes never reach
//   device memory;
// * top-k (`dice_topk_fused`): per blob the exact top k <= 8 candidates,
//   (idx, num, den) int32[B, k], as k rounds of the masked first-max
//   give them (`topk_candidates`, licensee_tpu/kernels/dice_xla.py);
//   again without the planes, in one launch.
//
// What bounds it on an H100 SXM (132 SMs at up to 1.98 GHz, 3.35 TB/s).
// Per SM and clock the CUDA cores issue 16 population counts and 64
// 32-bit logic or integer adds (the CUDA C++ Programming Guide's
// throughput table, compute capability 9.0): a loop of one POPC per
// pair-word tops out at 4.2e12 pair-words/s.  The single-bit tensor-core
// product mma.sync.m16n8k256.b1.and.popc computes the same sum straight
// from the packed words, exact in its s32 accumulator (a count is at most
// 32 W < 2^31), and ran at 597 pair-words per SM and clock on the card,
// 38x the POPC loop (PERF.md §6).  So the overlap goes to the tensor
// cores, and what is left bounds each regime:
//
// * small batches (the main path: 347 to 4096 Dice-bound rows a chunk):
//   latency and filling 132 SMs; the least time, the blob bytes, is
//   under a microsecond.  The grid splits the templates over blockIdx.x
//   as well as the blobs over blockIdx.y (`fused_schedule` in
//   kernels/dice_cuda.py picks the split for about two blocks per SM),
//   T is padded only to the mma's 8 columns, and one launch returns the
//   top-1, so no second kernel or argmax launches follow it;
// * large batches at T=608: the score algebra and exact compare on the
//   CUDA cores, some 14 integer operations per pair (0.13 ms at
//   B=262144 on the 64-wide pipe), more than the tensor-core overlap
//   (0.08 ms at 1024 pair-words per SM and clock) or the blob bytes
//   (0.04 ms).
//
// Design.  A block is four warps over 64 blob rows, one m16 tile each,
// and walks its slice of the templates in chunks of up to 32 (four n8
// tiles).  The block's blob rows sit in shared memory for the whole
// run; template chunks stream through a double-buffered shared-memory
// ring by cp.async, so the corpus (321 KB at T=608, over the 227 KB a
// block can have) stays in L2 and only a chunk is ever resident; at
// 71 KB a block, three blocks share an SM.  Rows are strided by Wp
// words, Wp = W rounded up to 8 and then to 8 mod 32, so each 8-byte
// fragment load of a warp hits 32 distinct banks; the blob rows' words
// past W are zeroed, so padding adds nothing to a sum.
//
// The m16n8k256 operands take the k-step's 8 words in the order
// (2t, 2t+1) per lane t of a quad for both A (blobs) and B (templates):
// the product pairs words of equal index, so the permutation leaves every
// sum as it is, and each lane's fragment is one 8-byte load.
//
// The first-max.  A lane scans its columns of each of its two rows in
// increasing template order and replaces its best only on a strictly
// greater num/den, compared exactly in int64 (a/b > c/d <=> a*d > c*b,
// every den >= 1).  Partial bests are then merged across the quad's lanes
// (shuffles) and, where the templates are split over blocks, across
// blocks, with
//
//   better(r, l) = r.num * l.den > l.num * r.den
//                  || (r.num * l.den == l.num * r.den && r.idx < l.idx)
//
// which is a total order on (value, -index): any merge tree gives the
// sequential first-max.  Excluded pairs arrive as (-1, 1), so a row whose
// every template is excluded returns (0, -1, 1).  Split blocks write
// their bests to scratch [3][splits][B]; the last block of a blob tile
// to finish (an atomic ticket per tile, after __threadfence) merges
// them and resets its ticket to 0 for the next launch: one launch, no
// memset, no second kernel.
//
// The top-k.  Its rounds reduce to a sort on the planes this kernel
// makes, whose domain is: a real entry has num >= 0 and den >= 1, an
// excluded one is exactly (-1, 1).  Then round r gives the r-th real
// entry in (value desc, index asc) order while there is one, and
// (0, -1, 1) after: by then every template is excluded or masked, all at
// (-1, 1), and the first-max of equals is template 0
// (tests/test_torch_topk.py holds this rule against the rounds).  So
// each lane keeps, for each of its two rows, a sorted list of the best
// KM real entries it scores (KM = 4 or 8 >= k, registers).  After each
// chunk's scores, its 8 candidates per row (two columns of each of the
// chunk's four n8 tiles; an excluded pair or a column past the chunk is
// an empty slot, (0, -1, 1), which loses to every real entry and so is
// the pad the rounds give) go through a sorting network (4 of 8:
// Batcher's 5-exchange sorts of both halves and one merge; 8 of 8: the
// 19-exchange sort) and their best KM merge into the list: branch-free,
// so no lane waits on another's inserts (with an insert per candidate,
// one lane's insert stalled its warp).  Merging two sorted lists keeps
// their top KM: the elementwise better of one and the other reversed is
// bitonic and holds them, and the half-cleaners sort it.  The quad's
// lanes merge their lists by shuffles.  Split blocks write their lists'
// first k entries to scratch [3][splits][B][k]; the last block of a tile
// (the ticket protocol above) merges the splits' lists the same way, each
// split's list loaded while the one before merges.  `topk_fused_schedule`
// keeps the template slices at 32 or more: every split costs a list
// merge.  KM = 8 takes 210 registers a thread (ptxas, no spills), so k
// stops at 8 (`K_FUSED_MAX`).  A plane outside that domain never comes
// from this kernel's algebra.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K1_WARPS = 4;
constexpr int K1_THREADS = K1_WARPS * 32;
constexpr int K1_BM = 16 * K1_WARPS;  // blob rows per block
constexpr int K1_TC = 32;             // most templates per chunk
constexpr int K1_NT = K1_TC / 8;      // n8 tiles per chunk
constexpr int META_COLS = 8;          // int32 meta row, as dice_pallas.pack_corpus
constexpr int SMEM_CAP = 227 * 1024;
constexpr int K_FUSED_MAX = 8;        // the top-k epilogue's largest k

enum Epilogue { kPlanes, kBest, kTopK };

enum { N_WF, N_FIELDSET, FIELD_COUNT, ALT_COUNT, LENGTH, CC_FLAG, VALID };

// the shared-memory row stride in words: W rounded up to whole 8-word
// k-steps, then to 8 mod 32 (conflict-free 8-byte fragment loads)
inline int row_stride(int W) {
  const int w8 = (W + 7) / 8 * 8;
  return w8 + (40 - w8 % 32) % 32;
}

inline size_t smem_bytes(int Wp, int tc) {
  return sizeof(uint32_t) * static_cast<size_t>(Wp) * (K1_BM + 2 * tc) +
         sizeof(int) * 2 * tc * META_COLS + sizeof(int4) * tc;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += popc(a & b) summed over 256 bits, a 16 x 8 tile of s32
__device__ __forceinline__ void mma_and_popc(int* c, uint2 lo, uint2 hi,
                                             uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(lo.x), "r"(hi.x), "r"(lo.y), "r"(hi.y), "r"(b.x), "r"(b.y));
}

// int32 arithmetic that wraps as the plain versions' does
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wabs(int a) {
  return a < 0 ? wsub(0, a) : a;
}

// a template's constants as the epilogue uses them
struct alignas(16) TplConst {
  int base;   // n_wf - n_fieldset
  int len;    // length
  int slack;  // 5 * max(field_count, alt_count)
  int flags;  // bit 0: not valid; bit 1: cc_flag
};

struct BlobConst {
  int n_words, len, mask;  // mask: 1, | 2 under the CC false-positive flag
};

__device__ __forceinline__ void score(int overlap, const TplConst& m,
                                      const BlobConst& b, int& num,
                                      int& den) {
  const int adj = max(wsub(wabs(wsub(m.len, b.len)), m.slack), 0);
  const int denom = wadd(wadd(m.base, b.n_words), adj >> 2);
  const bool excluded = (m.flags & b.mask) != 0;
  num = excluded ? -1 : overlap;
  den = (excluded || denom <= 0) ? 1 : denom;
}

struct Best {
  int idx, num, den;
};

// the merge comparator: a total order on (num / den, -idx)
__device__ __forceinline__ bool better(const Best& r, const Best& l) {
  const long long rp = static_cast<long long>(r.num) * l.den;
  const long long lp = static_cast<long long>(l.num) * r.den;
  return rp > lp || (rp == lp && r.idx < l.idx);
}

__device__ __forceinline__ Best shfl_best(const Best& v, int mask) {
  return {__shfl_xor_sync(0xffffffffu, v.idx, mask),
          __shfl_xor_sync(0xffffffffu, v.num, mask),
          __shfl_xor_sync(0xffffffffu, v.den, mask)};
}

// the top-k's empty slot: loses to every real entry, and is the pad
__device__ __forceinline__ Best empty_slot() { return {0, -1, 1}; }

// compare-exchange: a before b afterwards
__device__ __forceinline__ void order(Best& a, Best& b) {
  if (better(b, a)) {
    const Best o = a;
    a = b;
    b = o;
  }
}

// Batcher's odd-even merge sort networks, best first: 4 entries from O
// in 5 compare-exchanges, 8 in 19
template <int O, int N>
__device__ __forceinline__ void sort4(Best (&a)[N]) {
  order(a[O], a[O + 1]);
  order(a[O + 2], a[O + 3]);
  order(a[O], a[O + 2]);
  order(a[O + 1], a[O + 3]);
  order(a[O + 1], a[O + 2]);
}

template <int N>
__device__ __forceinline__ void sort8(Best (&a)[N]) {
  sort4<0>(a);
  sort4<4>(a);
#pragma unroll
  for (int i = 0; i < 4; ++i) order(a[i], a[i + 4]);
  order(a[2], a[4]);
  order(a[3], a[5]);
  order(a[1], a[2]);
  order(a[3], a[4]);
  order(a[5], a[6]);
}

// l = the top KM of l and o, both sorted best first, given o reversed
// (rev[i] = o[KM - 1 - i]): their elementwise better is bitonic and
// holds the top KM; the half-cleaners sort it
template <int KM>
__device__ __forceinline__ void merge_reversed(Best (&l)[KM],
                                               const Best (&rev)[KM]) {
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    if (better(rev[i], l[i])) l[i] = rev[i];
  }
#pragma unroll
  for (int j = KM / 2; j > 0; j >>= 1) {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      if ((i & j) == 0) order(l[i], l[i + j]);
    }
  }
}

// l = the top KM of l and a chunk's N candidates (empty slots where a
// pair is excluded or past the chunk): the chunk's best KM by a
// network, reversed, merged in.  KM = 4 of 8: both halves sorted, their
// top 4 by one merge; KM = 8 of 8: the 19-exchange sort
template <int KM, int N>
__device__ __forceinline__ void merge_chunk(Best (&l)[KM], Best (&c)[N]) {
  static_assert(N == 8 && (KM == 4 || KM == 8), "chunks of 8 candidates");
  Best rev[KM];
  if constexpr (KM == 4) {
    sort4<0>(c);
    sort4<4>(c);
    Best h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = c[i];
    Best hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) hi[i] = c[7 - i];
    merge_reversed<4>(h, hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) rev[i] = h[3 - i];
  } else {
    sort8(c);
#pragma unroll
    for (int i = 0; i < KM; ++i) rev[i] = c[KM - 1 - i];
  }
  merge_reversed<KM>(l, rev);
}

struct Params {
  const int* meta;
  const uint32_t* tpl;
  const uint32_t* file;
  const int* n_words;
  const int* lengths;
  const unsigned char* cc_fp;
  int* out0;     // planes: num; best: idx [B]; top-k: idx [B][k]
  int* out1;     // planes: den; best: num; top-k: num
  int* out2;     // best: den; top-k: den
  int* partial;  // splits > 1: best [3][splits][B], top-k [3][splits][B][k]
  int* tickets;  // splits > 1: one per blob tile, zero between launches
  int B, T, W, Wp, per_split, tc;
  int k;         // top-k: the candidates per blob, 1 <= k <= KM
};

// writes the first k entries of a list sorted best first to [..][k] rows
template <int KM>
__device__ __forceinline__ void store_list(const Best (&l)[KM], int* idx,
                                           int* num, int* den, size_t at,
                                           int k) {
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    if (i < k) {
      idx[at + i] = l[i].idx;
      num[at + i] = l[i].num;
      den[at + i] = l[i].den;
    }
  }
}

// the top-k epilogue, after the mainloop: the quad's lanes hold lists of
// disjoint columns of the same two rows
template <int KM>
__device__ __forceinline__ void topk_epilogue(const Params& p,
                                              Best (&top)[2][KM], int b0,
                                              int rows, int warp, int g,
                                              int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int mask = 1; mask <= 2; mask <<= 1) {
      Best rev[KM];
#pragma unroll
      for (int i = 0; i < KM; ++i) rev[i] = shfl_best(top[r][KM - 1 - i], mask);
      merge_reversed<KM>(top[r], rev);
    }
  }
  const int splits = gridDim.x;
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = b0 + warp * 16 + g + 8 * r;
      if (row >= p.B) continue;
      if (splits == 1) {
        store_list<KM>(top[r], p.out0, p.out1, p.out2,
                       static_cast<size_t>(row) * p.k, p.k);
      } else {
        const size_t plane = static_cast<size_t>(splits) * p.B * p.k;
        store_list<KM>(top[r], p.partial, p.partial + plane,
                       p.partial + 2 * plane,
                       (static_cast<size_t>(blockIdx.x) * p.B + row) * p.k,
                       p.k);
      }
    }
  }
  if (splits == 1) return;

  __threadfence();  // this block's lists are visible before its ticket
  __syncthreads();
  __shared__ bool s_last_topk;
  if (threadIdx.x == 0) {
    s_last_topk = atomicAdd(p.tickets + blockIdx.y, 1) == splits - 1;
  }
  __syncthreads();
  if (!s_last_topk) return;
  __threadfence();  // every other block's lists are visible to this one
  const size_t plane = static_cast<size_t>(splits) * p.B * p.k;
  for (int i = threadIdx.x; i < rows; i += K1_THREADS) {
    const int row = b0 + i;
    Best acc[KM];
#pragma unroll
    for (int j = 0; j < KM; ++j) acc[j] = empty_slot();
    auto load = [&](int s, Best (&rev)[KM]) {
      const size_t at = (static_cast<size_t>(s) * p.B + row) * p.k;
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        const int e = KM - 1 - j;
        rev[j] = e < p.k ? Best{__ldcg(p.partial + at + e),
                                __ldcg(p.partial + plane + at + e),
                                __ldcg(p.partial + 2 * plane + at + e)}
                         : empty_slot();
      }
    };
    Best nxt[KM];
    load(0, nxt);
    for (int s = 0; s < splits; ++s) {
      Best rev[KM];
#pragma unroll
      for (int j = 0; j < KM; ++j) rev[j] = nxt[j];
      if (s + 1 < splits) load(s + 1, nxt);
      merge_reversed<KM>(acc, rev);
    }
    store_list<KM>(acc, p.out0, p.out1, p.out2,
                   static_cast<size_t>(row) * p.k, p.k);
  }
  if (threadIdx.x == 0) p.tickets[blockIdx.y] = 0;
}

// KM: the top-k's list length (1 for the other epilogues)
template <int kEpi, int KM>
__global__ void __launch_bounds__(K1_THREADS)
    dice_k1_kernel(const Params p) {
  extern __shared__ uint4 smem[];  // uint4 keeps the 16-byte alignment
  uint32_t* s_blob = reinterpret_cast<uint32_t*>(smem);  // [K1_BM][Wp]
  uint32_t* s_tpl = s_blob + K1_BM * p.Wp;               // [2][tc][Wp]
  int* s_meta = reinterpret_cast<int*>(s_tpl + 2 * p.tc * p.Wp);  // [2][tc][8]
  TplConst* s_const = reinterpret_cast<TplConst*>(s_meta + 2 * p.tc * META_COLS);

  const int split = blockIdx.x;
  const int b0 = blockIdx.y * K1_BM;
  const int t_lo = split * p.per_split;
  const int t_hi = min(p.T, t_lo + p.per_split);
  const int n_chunks = (t_hi - t_lo + p.tc - 1) / p.tc;
  const int w4 = p.W / 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  // rows of W words to rows strided by Wp: a warp per row, 16 bytes a lane
  auto copy_rows = [&](uint32_t* dst, const uint32_t* src, int n_rows) {
    for (int r = warp; r < n_rows; r += K1_WARPS) {
      for (int q = lane; q < w4; q += 32) {
        cp_async16(dst + r * p.Wp + 4 * q,
                   src + static_cast<size_t>(r) * p.W + 4 * q);
      }
    }
  };

  // the block's blob rows, once; their words past W zeroed
  const int rows = min(K1_BM, p.B - b0);
  copy_rows(s_blob, p.file + static_cast<size_t>(b0) * p.W, rows);
  const int w8 = (p.W + 7) / 8 * 8;
  for (int i = threadIdx.x; i < K1_BM * (w8 - p.W); i += K1_THREADS) {
    const int r = i / (w8 - p.W);
    s_blob[r * p.Wp + p.W + i % (w8 - p.W)] = 0u;
  }

  auto load_chunk = [&](int c) {
    const int buf = c & 1;
    const int t0 = t_lo + c * p.tc;
    const int nt = min(p.tc, t_hi - t0);
    copy_rows(s_tpl + buf * p.tc * p.Wp,
              p.tpl + static_cast<size_t>(t0) * p.W, nt);
    int* mdst = s_meta + buf * p.tc * META_COLS;
    for (int i = threadIdx.x; i < nt * 2; i += K1_THREADS) {
      cp_async16(mdst + 4 * i, p.meta + static_cast<size_t>(t0) * META_COLS + 4 * i);
    }
  };
  load_chunk(0);
  cp_async_commit();

  // this lane's two rows, g and g + 8 of its warp's m16 tile
  auto row_of = [&](int r) { return b0 + warp * 16 + g + 8 * r; };
  BlobConst bc[2];
  Best best[2];
  Best top[2][KM];
  // the top-k's candidates of one chunk, per row: this lane's two columns
  // of each of the chunk's n8 tiles
  Best cand[2][2 * K1_NT];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(row_of(r), p.B - 1);
    bc[r] = {p.n_words[row], p.lengths[row], p.cc_fp[row] ? 3 : 1};
    best[r] = {INT_MAX, -2, 1};  // below any pair
#pragma unroll
    for (int i = 0; i < KM; ++i) top[r][i] = empty_slot();
  }

  const uint32_t* a_lo = s_blob + (warp * 16 + g) * p.Wp + 2 * t;
  const uint32_t* a_hi = a_lo + 8 * p.Wp;
  const int n_ksteps = w8 / 8;

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load_chunk(c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = c & 1;
    const int t0 = t_lo + c * p.tc;
    const int nt = min(p.tc, t_hi - t0);
    if (threadIdx.x < nt) {
      const int* m = s_meta + (buf * p.tc + threadIdx.x) * META_COLS;
      s_const[threadIdx.x] = {wsub(m[N_WF], m[N_FIELDSET]), m[LENGTH],
                              static_cast<int>(5u * static_cast<uint32_t>(
                                  max(m[FIELD_COUNT], m[ALT_COUNT]))),
                              (m[VALID] != 1 ? 1 : 0) | (m[CC_FLAG] == 1 ? 2 : 0)};
    }

    int acc[K1_NT][4] = {};
    const uint32_t* b_row = s_tpl + (buf * p.tc + g) * p.Wp + 2 * t;
    for (int k = 0; k < n_ksteps; ++k) {
      const uint2 lo = *reinterpret_cast<const uint2*>(a_lo + 8 * k);
      const uint2 hi = *reinterpret_cast<const uint2*>(a_hi + 8 * k);
#pragma unroll
      for (int j = 0; j < K1_NT; ++j) {
        if (8 * j < nt) {
          const uint2 b =
              *reinterpret_cast<const uint2*>(b_row + 8 * j * p.Wp + 8 * k);
          mma_and_popc(acc[j], lo, hi, b);
        }
      }
    }
    __syncthreads();  // s_const is written; the ring slot may be refilled

    if constexpr (kEpi == kTopK) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int i = 0; i < 2 * K1_NT; ++i) cand[r][i] = empty_slot();
      }
    }
#pragma unroll
    for (int j = 0; j < K1_NT; ++j) {
      if (8 * j >= nt) continue;
      const int col = 8 * j + 2 * t;  // this lane's column pair in the chunk
      const bool two = col + 1 < nt;
      if (col >= nt) continue;
      const TplConst m0 = s_const[col];
      const TplConst m1 = s_const[two ? col + 1 : col];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int num0, den0, num1, den1;
        score(acc[j][2 * r], m0, bc[r], num0, den0);
        score(acc[j][2 * r + 1], m1, bc[r], num1, den1);
        if constexpr (kEpi == kBest) {
          // columns arrive in increasing template order: only a strictly
          // greater score replaces the first-max so far
          if (static_cast<long long>(num0) * best[r].den >
              static_cast<long long>(best[r].num) * den0) {
            best[r] = {t0 + col, num0, den0};
          }
          if (two && static_cast<long long>(num1) * best[r].den >
                         static_cast<long long>(best[r].num) * den1) {
            best[r] = {t0 + col + 1, num1, den1};
          }
        } else if constexpr (kEpi == kTopK) {
          // real entries only: an excluded pair is (-1, 1), the pad
          if (num0 >= 0) cand[r][2 * j] = {t0 + col, num0, den0};
          if (two && num1 >= 0) cand[r][2 * j + 1] = {t0 + col + 1, num1, den1};
        } else {
          const int row = row_of(r);
          if (row >= p.B) continue;
          const size_t at = static_cast<size_t>(row) * p.T + t0 + col;
          if (two && (p.T & 1) == 0) {  // `at` is even: 8-byte aligned
            *reinterpret_cast<int2*>(p.out0 + at) = make_int2(num0, num1);
            *reinterpret_cast<int2*>(p.out1 + at) = make_int2(den0, den1);
          } else {
            p.out0[at] = num0;
            p.out1[at] = den0;
            if (two) {
              p.out0[at + 1] = num1;
              p.out1[at + 1] = den1;
            }
          }
        }
      }
    }
    if constexpr (kEpi == kTopK) {
      // branch-free: no lane waits on another's insertions
#pragma unroll
      for (int r = 0; r < 2; ++r) merge_chunk<KM, 2 * K1_NT>(top[r], cand[r]);
    }
  }
  if constexpr (kEpi == kPlanes) return;
  if constexpr (kEpi == kTopK) {
    topk_epilogue<KM>(p, top, b0, rows, warp, g, t);
    return;
  }

  // the quad's four lanes hold disjoint columns of the same rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int mask = 1; mask <= 2; mask <<= 1) {
      const Best o = shfl_best(best[r], mask);
      if (better(o, best[r])) best[r] = o;
    }
  }
  const int splits = gridDim.x;
  if (splits == 1) {
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_of(r);
        if (row < p.B) {
          p.out0[row] = best[r].idx;
          p.out1[row] = best[r].num;
          p.out2[row] = best[r].den;
        }
      }
    }
    return;
  }

  const size_t plane = static_cast<size_t>(splits) * p.B;
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_of(r);
      if (row < p.B) {
        const size_t at = static_cast<size_t>(split) * p.B + row;
        p.partial[at] = best[r].idx;
        p.partial[plane + at] = best[r].num;
        p.partial[2 * plane + at] = best[r].den;
      }
    }
  }
  __threadfence();  // this block's bests are visible before its ticket
  __syncthreads();
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    s_last = atomicAdd(p.tickets + blockIdx.y, 1) == splits - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();  // every other block's bests are visible to this one
  for (int i = threadIdx.x; i < rows; i += K1_THREADS) {
    const int row = b0 + i;
    Best acc = {INT_MAX, -2, 1};
    for (int s = 0; s < splits; ++s) {
      const size_t at = static_cast<size_t>(s) * p.B + row;
      const Best o = {__ldcg(p.partial + at), __ldcg(p.partial + plane + at),
                      __ldcg(p.partial + 2 * plane + at)};
      if (better(o, acc)) acc = o;
    }
    p.out0[row] = acc.idx;
    p.out1[row] = acc.num;
    p.out2[row] = acc.den;
  }
  if (threadIdx.x == 0) p.tickets[blockIdx.y] = 0;
}

template <int kEpi, int KM>
int launch(const Params& p, cudaStream_t stream) {
  if (p.B <= 0 || p.T <= 0 || p.W <= 0 || p.W % 4 || p.per_split < 8 ||
      p.per_split % 8 || p.tc < 8 || p.tc > K1_TC || p.tc % 8 ||
      (kEpi == kTopK && (p.k < 1 || p.k > KM)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (p.B + K1_BM - 1) / K1_BM;
  const int splits = (p.T + p.per_split - 1) / p.per_split;
  if (n_tiles > 65535 || splits > 65535 ||
      (kEpi != kPlanes && splits > 1 &&
       (p.partial == nullptr || p.tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(p.Wp, p.tc);
  if (smem > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
  // on every launch: the limit belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      dice_k1_kernel<kEpi, KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // template slices fastest: the blocks that run together share one blob
  // tile, read once from device memory, and the merging block comes soon
  const dim3 grid(splits, n_tiles);
  dice_k1_kernel<kEpi, KM><<<grid, K1_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* meta, const void* tpl, const void* file,
                   const void* n_words, const void* lengths,
                   const void* cc_fp, int B, int T, int W, int per_split,
                   int tc) {
  Params p{};
  p.meta = static_cast<const int*>(meta);
  p.tpl = static_cast<const uint32_t*>(tpl);
  p.file = static_cast<const uint32_t*>(file);
  p.n_words = static_cast<const int*>(n_words);
  p.lengths = static_cast<const int*>(lengths);
  p.cc_fp = static_cast<const unsigned char*>(cc_fp);
  p.B = B;
  p.T = T;
  p.W = W;
  p.Wp = row_stride(W);
  p.per_split = per_split;
  p.tc = tc;
  return p;
}

}  // namespace

// Both entry points score B blobs against T templates on `stream`, with
// the templates split in slices of `per_split` (a multiple of 8) over
// ceil(T / per_split) blocks per 64-row blob tile and streamed in chunks
// of `tc` templates (a multiple of 8, at most 32); `fused_schedule` in
// kernels/dice_cuda.py picks both.  Pointers are device pointers;
// `meta`, `tpl` and `file` are 16-byte aligned, their rows W (a multiple
// of 4) uint32 words.  Each returns the launch's cudaError_t.

// (num, den) int32[B, T]
extern "C" int dice_score_fused(const void* meta, const void* tpl,
                                const void* file, const void* n_words,
                                const void* lengths, const void* cc_fp,
                                void* num, void* den, int B, int T, int W,
                                int per_split, int tc, void* stream) {
  Params p = make_params(meta, tpl, file, n_words, lengths, cc_fp, B, T, W,
                         per_split, tc);
  p.out0 = static_cast<int*>(num);
  p.out1 = static_cast<int*>(den);
  return launch<kPlanes, 1>(p, static_cast<cudaStream_t>(stream));
}

// (idx, num, den) int32[B], the exact first-max over templates.  With
// more than one split, `partial` is int32 scratch of 3 * splits * B and
// `tickets` int32[ceil(B / 64)] zeros, which the launch leaves zero.
extern "C" int dice_best_fused(const void* meta, const void* tpl,
                               const void* file, const void* n_words,
                               const void* lengths, const void* cc_fp,
                               void* idx, void* num, void* den,
                               void* partial, void* tickets, int B, int T,
                               int W, int per_split, int tc, void* stream) {
  Params p = make_params(meta, tpl, file, n_words, lengths, cc_fp, B, T, W,
                         per_split, tc);
  p.out0 = static_cast<int*>(idx);
  p.out1 = static_cast<int*>(num);
  p.out2 = static_cast<int*>(den);
  p.partial = static_cast<int*>(partial);
  p.tickets = static_cast<int*>(tickets);
  return launch<kBest, 1>(p, static_cast<cudaStream_t>(stream));
}

// (idx, num, den) int32[B][k] each, the exact top k (1 <= k <=
// K_FUSED_MAX) candidates per blob, as k rounds of the masked first-max
// give them.  With more than one split, `partial` is int32 scratch of
// 3 * splits * B * k and `tickets` as for dice_best_fused.
extern "C" int dice_topk_fused(const void* meta, const void* tpl,
                               const void* file, const void* n_words,
                               const void* lengths, const void* cc_fp,
                               void* idx, void* num, void* den,
                               void* partial, void* tickets, int B, int T,
                               int W, int per_split, int tc, int k,
                               void* stream) {
  Params p = make_params(meta, tpl, file, n_words, lengths, cc_fp, B, T, W,
                         per_split, tc);
  p.out0 = static_cast<int*>(idx);
  p.out1 = static_cast<int*>(num);
  p.out2 = static_cast<int*>(den);
  p.partial = static_cast<int*>(partial);
  p.tickets = static_cast<int*>(tickets);
  p.k = k;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k >= 1 && k <= 4) return launch<kTopK, 4>(p, st);
  if (k > 4 && k <= K_FUSED_MAX) return launch<kTopK, K_FUSED_MAX>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
