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
// Once a row's remaining entries are all (-1, 1), a later round picks
// the lowest index among them, which may be a template an earlier round
// already took: those repeats are part of the result, as in the
// reference (the host drops them by their score, which is below 0).
// Column 0 is the exact top-1, so a `--closest` chunk needs no argmax.
//
// What bounds it on an H100 SXM: reading the planes, 8 bytes a (blob,
// template) pair at 3.35 TB/s, against k rounds of exact compares over
// the row (two int64 products, a compare and a select per pair and
// round) on the CUDA cores; at the `--closest` path's k = closest + 1 of
// a few, the bytes bound it.
//
// Design: one warp per blob row.  The warp copies its row's (num, den)
// into shared memory once (coalesced, one 8-byte entry a template), then
// runs k rounds: each lane scans the templates j = lane, lane + 32, ...
// in increasing order, replacing its best only on a strictly better
// entry, and the 32 partial bests merge in five shuffle steps under
//
//   better(a, b) = a.num * b.den > b.num * a.den
//                  || (a.num * b.den == b.num * a.den && a.idx < b.idx)
//
// a total order on (value, -index), so the merge gives the sequential
// first-max whatever its shape.  Lane 0 writes the round's triple and
// masks the winner's entry in shared memory.  A block holds
// `warps` rows (the wrapper picks how many fit); nothing crosses
// blocks, so one launch does the whole [B, T] -> [B, k].

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kDefaultSmem = 48 * 1024;

struct Best {
  int num, den, idx;  // idx < 0: no entry yet (loses to every entry)
};

__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  if (a.idx < 0) return false;
  if (b.idx < 0) return true;
  const long long l = static_cast<long long>(a.num) * b.den;
  const long long r = static_cast<long long>(b.num) * a.den;
  return l > r || (l == r && a.idx < b.idx);
}

__global__ void topk_exact_kernel(const int* __restrict__ num,
                                  const int* __restrict__ den,
                                  int* __restrict__ out_idx,
                                  int* __restrict__ out_num,
                                  int* __restrict__ out_den, int B, int T,
                                  int k) {
  extern __shared__ int2 rows[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (b >= B) return;  // warp-uniform: the whole warp leaves together
  int2* row = rows + static_cast<size_t>(warp) * T;
  const int* nrow = num + b * T;
  const int* drow = den + b * T;
  for (int j = lane; j < T; j += kWarp) row[j] = make_int2(nrow[j], drow[j]);
  __syncwarp();
  for (int r = 0; r < k; ++r) {
    Best best{0, 1, -1};
    for (int j = lane; j < T; j += kWarp) {
      const int2 v = row[j];
      const Best cand{v.x, v.y, j};
      if (better(cand, best)) best = cand;
    }
#pragma unroll
    for (int off = kWarp / 2; off; off >>= 1) {
      const Best other{__shfl_xor_sync(0xffffffffu, best.num, off),
                       __shfl_xor_sync(0xffffffffu, best.den, off),
                       __shfl_xor_sync(0xffffffffu, best.idx, off)};
      if (better(other, best)) best = other;
    }
    if (lane == 0) {
      const long long o = b * k + r;
      out_idx[o] = best.idx;
      out_num[o] = best.num;
      out_den[o] = best.den;
      row[best.idx] = make_int2(-1, 1);
    }
    __syncwarp();
  }
}

}  // namespace

// (idx, num, den) int32[3][B][k] into `out`, from the (num, den)
// int32[B, T] planes (T >= 1, every den >= 1), `warps` rows a block;
// `warps * T * 8` bytes of shared memory a block.
extern "C" int dice_topk_exact(const void* num, const void* den, void* out,
                               int B, int T, int k, int warps, void* stream) {
  const size_t smem = static_cast<size_t>(warps) * T * sizeof(int2);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int* o = static_cast<int*>(out);
  const size_t plane = static_cast<size_t>(B) * k;
  const int blocks = (B + warps - 1) / warps;
  topk_exact_kernel<<<blocks, warps * kWarp, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(num), static_cast<const int*>(den), o,
      o + plane, o + 2 * plane, B, T, k);
  return cudaGetLastError();
}
