// K4's top-k: the exact top-k candidates of each blob over the (num, den)
// score planes, for Hopper (sm_90a).
//
// Replaces `topk_candidates` (licensee_tpu/kernels/dice_xla.py), an XLA
// graph on the TPU rather than a Pallas kernel: k rounds of the exact
// first-max (`_argmax_exact`), each round's winner masked to the
// excluded (-1, 1).  For every blob b and round r < k:
//
//   (idx, num, den)[b, r] = the first template t of greatest num/den
//                           among the row after rounds 0..r-1's masks,
//   compared exactly: a/b > c/d <=> a*d > c*b in int64 (every den >= 1),
//   ties to the lower template index.
//
// The domain.  The planes this kernel is given come from the score
// algebra (K1's planes, or K2 and `dice_ref.finish_scores`): a real
// entry has num >= 0 and den >= 1, an excluded one is exactly (-1, 1).
// On that domain the k rounds reduce to a sort: round r gives the r-th
// real entry in (value desc, index asc) order while there is one, and
// (0, -1, 1) after, since by then every template is excluded or masked,
// all at (-1, 1), and the first-max of equals is template 0 (the repeats
// are part of the result; the host drops them by their score, below 0).
// tests/test_torch_topk.py holds this rule against the rounds.  Column 0
// is the exact top-1, so a `--closest` chunk needs no argmax.  A plane
// outside the domain never comes from the port's scorers.
//
// What bounds it on an H100 SXM: reading the planes, 8 bytes a (blob,
// template) pair at 3.35 TB/s, against the exact compares (two int64
// products, a compare, the update) on the CUDA cores: at the `--closest`
// path's k of a few, the bytes; at k = T a sort's T log2 T compares.
//
// Two designs, one pass over each row either way (the k rounds of the
// first design this file had rescanned the row k times).  Neither
// branches on the data: a warp's lanes never wait on each other's
// inserts, which is what an insert per entry into a sorted list cost
// (one lane's insert stalls its warp):
//
// * small k (<= 16, `topk_group_kernel`): G lanes a row (a power of two
//   `topk_schedule` picks: enough threads for the card at small B, at
//   least 4 entries a lane: 8 at B=4096, T=47; 16 at B=4096, T=608; 2 at
//   B=262144), 32 / G rows a warp.  A lane takes its entries 8 at a time
//   (their loads issued together) and keeps a sorted list of the KM >= k
//   best real ones in registers (KM = 4, 8 or 16): a block's best KM by
//   a sorting network (4 of 8: Batcher's 5-exchange sorts of both
//   halves, then one merge; 8 of 8: the 19-exchange sort), merged into
//   the list.  Merging two sorted lists keeps their top KM: the
//   elementwise better of one and the other reversed is bitonic and
//   holds them, and the half-cleaners sort it.  The empty slot
//   (0, -1, 1) loses to every real entry and is the rounds' pad.  The
//   group merges its lists in log2(G) shuffle steps.
// * large k (`topk_sort_kernel`): each row padded to P = the power of two
//   >= T (at least 8) with empty slots (excluded entries become empty
//   slots too) and sorted by a bitonic network under the exact order:
//   8 consecutive entries a thread in registers, the network's strides
//   below 8 within a thread, up to 31 threads apart by shuffles, farther
//   (rows of 512 entries or more) through shared memory.  Then the first
//   k of each row, empty slots past the row's reals.  T log2^2 T / 4
//   compares in parallel, against k T in series for the rounds.  A row
//   takes P / 8 threads of a block, so T is at most 8192 here.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Best {
  int idx, num, den;
};

// a total order on (num / den, -idx): a before b
__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  const long long l = static_cast<long long>(a.num) * b.den;
  const long long r = static_cast<long long>(b.num) * a.den;
  return l > r || (l == r && a.idx < b.idx);
}

__device__ __forceinline__ Best empty_slot() { return {0, -1, 1}; }

// compare-exchange: a before b afterwards
__device__ __forceinline__ void order(Best& a, Best& b) {
  if (better(b, a)) {
    const Best o = a;
    a = b;
    b = o;
  }
}

// a bitonic sorting network, best first, on N (a power of two) entries
template <int N>
__device__ __forceinline__ void bitonic_sort(Best (&a)[N]) {
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          if ((i & size) == 0) {
            order(a[i], a[j]);
          } else {
            order(a[j], a[i]);
          }
        }
      }
    }
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

// l = the top KM of two lists sorted best first, the other one given
// reversed (rev[i] = other[KM - 1 - i]): their elementwise better is
// bitonic and holds the top KM, and the half-cleaners sort it
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

// l = the top KM of l and N candidates: the candidates' best KM by a
// network (KM = 4 of 8: both halves sorted, their top 4 by one merge;
// 8 of 8: the 19-exchange sort; 16: the bitonic sort), reversed,
// merged in
template <int KM, int N>
__device__ __forceinline__ void merge_block(Best (&l)[KM], Best (&c)[N]) {
  Best rev[KM];
  if constexpr (KM == 4 && N == 8) {
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
    if constexpr (N == 8) {
      sort8(c);
    } else {
      bitonic_sort<N>(c);
    }
#pragma unroll
    for (int i = 0; i < KM; ++i) rev[i] = c[KM - 1 - i];
  }
  merge_reversed<KM>(l, rev);
}

// a lane's entries are taken kBlock at a time: all their loads issued
// together, then one branch-free network
constexpr int kBlock = 8;

template <int G, int KM>
__global__ void __launch_bounds__(kThreads)
    topk_group_kernel(const int* __restrict__ num, const int* __restrict__ den,
                      int* __restrict__ out_idx, int* __restrict__ out_num,
                      int* __restrict__ out_den, int B, int T, int k) {
  const int sub = threadIdx.x % G;  // the lane in its row's group
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  Best l[KM];
#pragma unroll
  for (int i = 0; i < KM; ++i) l[i] = empty_slot();
  if (row < B) {
    const int* nrow = num + row * T;
    const int* drow = den + row * T;
    constexpr int N = KM > kBlock ? KM : kBlock;
    for (int j0 = sub; j0 < T; j0 += N * G) {
      Best c[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int j = j0 + i * G;
        c[i] = empty_slot();
        if (j < T) {
          const int n = __ldg(nrow + j);
          const int d = __ldg(drow + j);
          if (n >= 0) c[i] = {j, n, d};
        }
      }
      merge_block<KM, N>(l, c);
    }
  }
  // every lane of the warp takes part in the shuffles: a lane past the
  // last row holds empty slots
#pragma unroll
  for (int mask = 1; mask < G; mask <<= 1) {
    Best rev[KM];
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      const Best& v = l[KM - 1 - i];
      rev[i] = {__shfl_xor_sync(0xffffffffu, v.idx, mask),
                __shfl_xor_sync(0xffffffffu, v.num, mask),
                __shfl_xor_sync(0xffffffffu, v.den, mask)};
    }
    merge_reversed<KM>(l, rev);
  }
  if (row >= B) return;
  // the group's lanes hold the same list: lane s writes entries s, s + G,
  // ... side by side
  const long long o = row * k;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    if (i < k && i % G == sub) {
      out_idx[o + i] = l[i].idx;
      out_num[o + i] = l[i].num;
      out_den[o + i] = l[i].den;
    }
  }
}

// the sort: kE consecutive entries of a row per thread, in registers
constexpr int kE = 8;
constexpr int kSortThreads = 1024;  // a row of at most 8192 entries

// one compare-exchange stage of stride S < kE among a thread's own
// entries (t: the thread's place in its row)
template <int S>
__device__ __forceinline__ void stage_in_thread(Best (&e)[kE], int t, int size) {
  if (S >= size) return;
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const int j = i ^ S;
    if (j > i) {
      if (((t * kE + i) & size) == 0) {
        order(e[i], e[j]);
      } else {
        order(e[j], e[i]);
      }
    }
  }
}

// a stage of stride >= kE: each entry meets its partner in another
// thread (`y`) and keeps the better of the two where it is the pair's
// first place in a run sorted best first (or the second place of one
// sorted best last), else the worse.  Two places never hold different
// entries that compare equal: only empty slots do, and they are alike
__device__ __forceinline__ Best keep(const Best& x, const Best& y, int idx,
                                     int stride, int size) {
  const bool first = (idx & stride) == 0;
  const bool best_first = (idx & size) == 0;
  const bool y_better = better(y, x);
  return (first == best_first) == y_better ? y : x;
}

// kBound: the block's most threads, 256 for rows of up to 2048 entries
// (registers to spare), kSortThreads above
template <int kBound>
__global__ void __launch_bounds__(kBound)
    topk_sort_kernel(const int* __restrict__ num, const int* __restrict__ den,
                     int* __restrict__ out_idx, int* __restrict__ out_num,
                     int* __restrict__ out_den, int B, int T, int k, int P) {
  extern __shared__ int smem[];  // rows of P: num, den, idx (P >= 512 only)
  const int tp = P / kE;  // threads per row: a power of two
  const int in_block = threadIdx.x / tp;
  const int t = threadIdx.x % tp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / tp) + in_block;
  const bool live = row < B;
  Best e[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const int j = t * kE + i;
    e[i] = empty_slot();
    if (live && j < T) {
      const int n = __ldg(num + row * T + j);
      const int d = __ldg(den + row * T + j);
      if (n >= 0) e[i] = {j, n, d};
    }
  }
  int* s_num = smem + in_block * 3 * P;
  int* s_den = s_num + P;
  int* s_idx = s_den + P;
  // the bitonic network on the row's P entries: sorted runs of `size`,
  // alternately best first and best last, merged in pairs; the last
  // stage (size = P) sorts the row best first.  Strides below kE run in
  // registers, up to 31 threads apart by shuffles, farther through
  // shared memory
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride >= kE; stride >>= 1) {
      const int lanes = stride / kE;  // the partner thread: t ^ lanes
      Best y[kE];
      if (lanes < 32) {
#pragma unroll
        for (int i = 0; i < kE; ++i) {
          y[i] = {__shfl_xor_sync(0xffffffffu, e[i].idx, lanes),
                  __shfl_xor_sync(0xffffffffu, e[i].num, lanes),
                  __shfl_xor_sync(0xffffffffu, e[i].den, lanes)};
        }
      } else {
#pragma unroll
        for (int i = 0; i < kE; ++i) {
          s_num[t * kE + i] = e[i].num;
          s_den[t * kE + i] = e[i].den;
          s_idx[t * kE + i] = e[i].idx;
        }
        __syncthreads();
        const int u = (t ^ lanes) * kE;
#pragma unroll
        for (int i = 0; i < kE; ++i) {
          y[i] = {s_idx[u + i], s_num[u + i], s_den[u + i]};
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kE; ++i) {
        e[i] = keep(e[i], y[i], t * kE + i, stride, size);
      }
    }
    stage_in_thread<4>(e, t, size);
    stage_in_thread<2>(e, t, size);
    stage_in_thread<1>(e, t, size);
  }
  if (!live) return;
  const long long o = row * k;
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const int j = t * kE + i;
    if (j < k) {
      out_idx[o + j] = e[i].idx;
      out_num[o + j] = e[i].num;
      out_den[o + j] = e[i].den;
    }
  }
  if (t == 0) {
    for (int j = P; j < k; ++j) {  // k past the padded row: empty slots
      out_idx[o + j] = 0;
      out_num[o + j] = -1;
      out_den[o + j] = 1;
    }
  }
}

template <int G>
cudaError_t launch_group(const int* num, const int* den, int* o, size_t plane,
                         int B, int T, int k, cudaStream_t stream) {
  const int rows = kThreads / G;
  const int blocks = (B + rows - 1) / rows;
  if (k <= 4) {
    topk_group_kernel<G, 4><<<blocks, kThreads, 0, stream>>>(
        num, den, o, o + plane, o + 2 * plane, B, T, k);
  } else if (k <= 8) {
    topk_group_kernel<G, 8><<<blocks, kThreads, 0, stream>>>(
        num, den, o, o + plane, o + 2 * plane, B, T, k);
  } else {
    topk_group_kernel<G, 16><<<blocks, kThreads, 0, stream>>>(
        num, den, o, o + plane, o + 2 * plane, B, T, k);
  }
  return cudaGetLastError();
}

}  // namespace

// (idx, num, den) int32[3][B][k] into `out`, from the (num, den)
// int32[B, T] planes (T >= 1, the domain above).  `lanes` > 0 picks the
// small-k design with that many lanes a row (a power of two <= 32; k <=
// 16); `lanes` == 0 the sort, with rows of P entries (a power of two, T
// <= P, 8 <= P <= 8192), R rows a block of R * P / 8 threads (at most
// 1024) and, where P >= 512, 12 * R * P bytes of shared memory.
// `topk_schedule` in kernels/dice_cuda.py picks them.
extern "C" int dice_topk_exact(const void* num_, const void* den_, void* out,
                               int B, int T, int k, int lanes, int P, int R,
                               void* stream_) {
  if (B <= 0 || T <= 0 || k <= 0) return cudaErrorInvalidValue;
  const int* num = static_cast<const int*>(num_);
  const int* den = static_cast<const int*>(den_);
  int* o = static_cast<int*>(out);
  const size_t plane = static_cast<size_t>(B) * k;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (lanes > 0) {
    if (k > 16) return cudaErrorInvalidValue;
    switch (lanes) {
      case 1: return launch_group<1>(num, den, o, plane, B, T, k, stream);
      case 2: return launch_group<2>(num, den, o, plane, B, T, k, stream);
      case 4: return launch_group<4>(num, den, o, plane, B, T, k, stream);
      case 8: return launch_group<8>(num, den, o, plane, B, T, k, stream);
      case 16: return launch_group<16>(num, den, o, plane, B, T, k, stream);
      case 32: return launch_group<32>(num, den, o, plane, B, T, k, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (P < T || P < kE || P > kE * kSortThreads || (P & (P - 1)) != 0 ||
      R < 1 || R * (P / kE) > kSortThreads)
    return cudaErrorInvalidValue;
  // shared memory only where a stride reaches past a warp's 32 x kE
  const size_t smem =
      P >= 64 * kE ? 3 * sizeof(int) * static_cast<size_t>(R) * P : 0;
  const int blocks = (B + R - 1) / R;
  const int threads = R * (P / kE);
  auto kernel = threads <= 256 ? topk_sort_kernel<256>
                               : topk_sort_kernel<kSortThreads>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  kernel<<<blocks, threads, smem, stream>>>(num, den, o, o + plane,
                                            o + 2 * plane, B, T, k, P);
  return cudaGetLastError();
}
