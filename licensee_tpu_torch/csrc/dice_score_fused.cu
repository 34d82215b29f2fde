// K1: the fused popcount-and-score Dice kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_kernel`, reached through
// `_score_pairs_padded` (licensee_tpu/kernels/dice_pallas.py).  For every
// (blob b, template t):
//
//   overlap = sum_w popcount(file[b, w] & tpl[t, w])
//   denom   = n_wf + n_words - n_fieldset
//             + max(|len_t - len_b| - 5 * max(field_count, alt_count), 0) / 4
//   excluded = (cc_flag[t] && cc_fp[b]) || !valid[t]
//   num = excluded ? -1 : overlap;  den = (excluded || denom <= 0) ? 1 : denom
//
// written straight into the public [B, T] int32 layout (the TPU kernel's
// (n_tiles, T, TILE_B) planes are a Mosaic layout choice).
//
// Design.  The TPU kernel keeps every template in VMEM; a Hopper block has
// at most 227 KB of shared memory, and the synthetic-SPDX corpus alone is
// 608 x 132 x 4 B = 321 KB.  So the grid tiles templates as well as blobs:
// block (x, y) stages template tile y (K1_TILE_T rows plus their meta
// columns) in shared memory and each of its threads scores one blob of
// blob tile x against it.  A thread streams its blob row from device
// memory in 16-byte loads (each byte read once per template tile), and
// reads each template word as a warp-wide shared-memory broadcast.
//
// Bound.  At the vendored width (T=47, W=112) the bytes the function must
// move (the file bitsets in, num/den out) and its integer operations
// (AND + POPC + ADD per pair-word) give about the same least time; at
// T=608 the operations bind.  POPC issues at a quarter of the FP32 lane
// rate, so this simple kernel is expected to sit well above that least
// time: making it fast (more blobs per thread, wider template reuse) is
// later work, with its times kept in PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K1_THREADS = 128;  // blobs per block, one per thread
constexpr int K1_TILE_T = 32;    // templates per block
constexpr int META_COLS = 8;     // int32 meta row, as dice_pallas.pack_corpus

enum { N_WF, N_FIELDSET, FIELD_COUNT, ALT_COUNT, LENGTH, CC_FLAG, VALID };

__global__ void __launch_bounds__(K1_THREADS)
dice_score_fused_kernel(const int* __restrict__ meta,
                        const uint32_t* __restrict__ tpl,
                        const uint32_t* __restrict__ file,
                        const int* __restrict__ n_words,
                        const int* __restrict__ lengths,
                        const unsigned char* __restrict__ cc_fp,
                        int* __restrict__ num,
                        int* __restrict__ den,
                        int B, int T, int W) {
  extern __shared__ uint4 smem[];  // uint4 keeps the 16-byte alignment
  uint32_t* s_tpl = reinterpret_cast<uint32_t*>(smem);     // [K1_TILE_T][W]
  int* s_meta = reinterpret_cast<int*>(s_tpl + K1_TILE_T * W);

  const int t0 = blockIdx.y * K1_TILE_T;
  const int nt = min(K1_TILE_T, T - t0);
  const uint32_t* tpl_tile = tpl + static_cast<size_t>(t0) * W;
  for (int i = threadIdx.x; i < K1_TILE_T * W; i += K1_THREADS) {
    s_tpl[i] = (i / W) < nt ? tpl_tile[i] : 0u;
  }
  const int* meta_tile = meta + static_cast<size_t>(t0) * META_COLS;
  for (int i = threadIdx.x; i < K1_TILE_T * META_COLS; i += K1_THREADS) {
    s_meta[i] = (i / META_COLS) < nt ? meta_tile[i] : 0;
  }
  __syncthreads();

  const int b = blockIdx.x * K1_THREADS + threadIdx.x;
  if (b >= B) return;

  int acc[K1_TILE_T];
#pragma unroll
  for (int t = 0; t < K1_TILE_T; ++t) acc[t] = 0;

  const uint4* frow =
      reinterpret_cast<const uint4*>(file + static_cast<size_t>(b) * W);
  const int w4 = W / 4;
  for (int q = 0; q < w4; ++q) {
    const uint4 f = __ldg(frow + q);
#pragma unroll
    for (int t = 0; t < K1_TILE_T; ++t) {
      const uint4 v = reinterpret_cast<const uint4*>(s_tpl + t * W)[q];
      acc[t] += __popc(f.x & v.x) + __popc(f.y & v.y) +
                __popc(f.z & v.z) + __popc(f.w & v.w);
    }
  }

  const int nw = n_words[b];
  const int len = lengths[b];
  const bool cc = cc_fp[b] != 0;
  int* num_row = num + static_cast<size_t>(b) * T + t0;
  int* den_row = den + static_cast<size_t>(b) * T + t0;
#pragma unroll
  for (int t = 0; t < K1_TILE_T; ++t) {
    if (t < nt) {
      const int* m = s_meta + t * META_COLS;
      const int total = m[N_WF] + nw - m[N_FIELDSET];
      const int delta = abs(m[LENGTH] - len);
      const int adj = max(delta - 5 * max(m[FIELD_COUNT], m[ALT_COUNT]), 0);
      const int denom = total + adj / 4;  // adj >= 0: floor division
      const bool excluded = (m[CC_FLAG] == 1 && cc) || m[VALID] == 0;
      num_row[t] = excluded ? -1 : acc[t];
      den_row[t] = (excluded || denom <= 0) ? 1 : denom;
    }
  }
}

}  // namespace

// Scores B blobs against T templates on `stream`.  Pointers are device
// pointers; `tpl`/`file` rows hold W (a multiple of 4) uint32 words and
// start 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int dice_score_fused(const void* meta, const void* tpl,
                                const void* file, const void* n_words,
                                const void* lengths, const void* cc_fp,
                                void* num, void* den, int B, int T, int W,
                                void* stream) {
  const size_t smem = static_cast<size_t>(K1_TILE_T) * W * sizeof(uint32_t) +
                      K1_TILE_T * META_COLS * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dice_score_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + K1_THREADS - 1) / K1_THREADS,
                  (T + K1_TILE_T - 1) / K1_TILE_T);
  dice_score_fused_kernel<<<grid, K1_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<const uint32_t*>(tpl),
      static_cast<const uint32_t*>(file), static_cast<const int*>(n_words),
      static_cast<const int*>(lengths),
      static_cast<const unsigned char*>(cc_fp), static_cast<int*>(num),
      static_cast<int*>(den), B, T, W);
  return static_cast<int>(cudaGetLastError());
}
