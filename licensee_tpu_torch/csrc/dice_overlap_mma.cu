// K2: fused bit-unpack + int8 tensor-core overlap kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_mxu_kernel`, reached through
// `_overlap_mxu_padded` (licensee_tpu/kernels/dice_pallas.py):
//
//   overlap[b, t] = unpack(file[b]) . unpack(tpl[t])   over V = 32 * W
//
// with 0/1 int8 operands and int32 accumulation, exact because every
// product is 0 or 1 and V < 2^31.  The score algebra and the argmax run
// after it (kernels/dice_ref.py), as they do after the TPU kernel.
//
// Design.  The templates are unpacked once on the host into an int8
// [T_pad, V_pad] matrix (`dice_cuda.pack_templates_mma`; T_pad a multiple of
// K2_BN, V_pad = 32 * W rounded up to a whole stage).  The blob side
// stays packed in device memory, 32x smaller than its unpacked form: a
// block takes K2_BM blobs, and for each stage of K2_KW packed words it
// unpacks them into int8 in shared memory (byte i of word w at column
// 32 w + i, the lane-major order the host uses for the templates) and
// contracts them against the template tile with
// mma.sync.m16n8k32.s32.s8.s8.s32.  Each warp owns 16 blob rows and all
// K2_BN template columns (eight 16x8 accumulator fragments).  The
// template fragments are read from device memory through the read-only
// cache; the warps of a block read the same fragments.
//
// Bound.  Operations (2 * B * T * V int8) over the tensor cores' int8 rate
// at T=608; at T=47 the packed blob bits in and the int32 overlaps out.
// mma.sync reaches only part of the int8 peak that wgmma would, and the
// template tile is re-read per blob tile: moving to TMA + wgmma with the
// template tile resident in shared memory is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K2_WARPS = 8;
constexpr int K2_THREADS = K2_WARPS * 32;
constexpr int K2_BM = K2_WARPS * 16;  // blobs per block
constexpr int K2_BN = 64;             // templates per block: 8 fragments of 8
constexpr int K2_KW = 8;              // packed words per stage (256 columns)
// row stride of the unpacked tile in bytes: 16 bytes of padding make the
// fragment loads (8 rows x 4 words per instruction) conflict-free
constexpr int A_STRIDE = K2_KW * 32 + 16;

// 4 bits -> 4 bytes of 0/1: bit j of the nibble lands in byte j
__device__ __forceinline__ uint32_t spread_nibble(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(K2_THREADS)
dice_overlap_mma_kernel(const int8_t* __restrict__ tpl,
                        const uint32_t* __restrict__ file,
                        int* __restrict__ out, int B, int T, int W,
                        int v_pad) {
  __shared__ __align__(16) int8_t s_a[K2_BM * A_STRIDE];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row / column group
  const int tig = lane & 3;  // thread in group
  const int b0 = blockIdx.x * K2_BM;
  const int n0 = blockIdx.y * K2_BN;

  int acc[8][4];
#pragma unroll
  for (int f = 0; f < 8; ++f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0;
  }

  const int n_stages = v_pad / (K2_KW * 32);
  const int8_t* a_warp = s_a + warp * 16 * A_STRIDE;
  for (int s = 0; s < n_stages; ++s) {
    __syncthreads();  // the previous stage's fragment reads are done
    for (int i = threadIdx.x; i < K2_BM * K2_KW; i += K2_THREADS) {
      const int r = i / K2_KW;
      const int j = i % K2_KW;
      const int w = s * K2_KW + j;
      const uint32_t x =
          (b0 + r < B && w < W)
              ? __ldg(file + static_cast<size_t>(b0 + r) * W + w)
              : 0u;
      uint4 lo, hi;
      lo.x = spread_nibble(x);
      lo.y = spread_nibble(x >> 4);
      lo.z = spread_nibble(x >> 8);
      lo.w = spread_nibble(x >> 12);
      hi.x = spread_nibble(x >> 16);
      hi.y = spread_nibble(x >> 20);
      hi.z = spread_nibble(x >> 24);
      hi.w = spread_nibble(x >> 28);
      uint4* dst = reinterpret_cast<uint4*>(s_a + r * A_STRIDE + j * 32);
      dst[0] = lo;
      dst[1] = hi;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < K2_KW; ++kk) {
      const int kc = kk * 32 + 4 * tig;
      const uint32_t a0 =
          *reinterpret_cast<const uint32_t*>(a_warp + g * A_STRIDE + kc);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(
          a_warp + (g + 8) * A_STRIDE + kc);
      const uint32_t a2 =
          *reinterpret_cast<const uint32_t*>(a_warp + g * A_STRIDE + kc + 16);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(
          a_warp + (g + 8) * A_STRIDE + kc + 16);
      const size_t k_glob = static_cast<size_t>(s) * K2_KW * 32 + kc;
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int8_t* bp =
            tpl + static_cast<size_t>(n0 + f * 8 + g) * v_pad + k_glob;
        const uint32_t bf0 = __ldg(reinterpret_cast<const unsigned int*>(bp));
        const uint32_t bf1 =
            __ldg(reinterpret_cast<const unsigned int*>(bp + 16));
        mma_s8(acc[f], a0, a1, a2, a3, bf0, bf1);
      }
    }
  }

  const int r_lo = b0 + warp * 16 + g;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int col = n0 + f * 8 + 2 * tig;
    if (r_lo < B) {
      int* row = out + static_cast<size_t>(r_lo) * T;
      if (col < T) row[col] = acc[f][0];
      if (col + 1 < T) row[col + 1] = acc[f][1];
    }
    if (r_hi < B) {
      int* row = out + static_cast<size_t>(r_hi) * T;
      if (col < T) row[col] = acc[f][2];
      if (col + 1 < T) row[col + 1] = acc[f][3];
    }
  }
}

}  // namespace

// overlap int32[B, T] of packed blob bits (B rows of W uint32 words)
// against the unpacked templates (int8 [t_pad, v_pad], t_pad a multiple of
// 64, v_pad = 32 * W rounded up to a multiple of 256) on `stream`.
// Returns the launch's cudaError_t.
extern "C" int dice_overlap_mma(const void* tpl, const void* file, void* out,
                                int B, int T, int W, int t_pad, int v_pad,
                                void* stream) {
  const dim3 grid((B + K2_BM - 1) / K2_BM, t_pad / K2_BN);
  dice_overlap_mma_kernel<<<grid, K2_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tpl), static_cast<const uint32_t*>(file),
      static_cast<int*>(out), B, T, W, v_pad);
  return static_cast<int>(cudaGetLastError());
}
