// K2: fused bit-unpack + int8 tensor-core overlap kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_mxu_kernel`, reached through
// `_overlap_mxu_padded` (licensee_tpu/kernels/dice_pallas.py:355):
//
//   overlap[b, t] = unpack(file[b]) . unpack(tpl[t])   over V = 32 * W
//
// with 0/1 int8 operands and int32 accumulation, exact because every
// product is 0 or 1 and V < 2^31.  The score algebra and the argmax run
// after it (kernels/dice_ref.py), as they do after the TPU kernel.
//
// Bound on an H100 SXM (3.35 TB/s, 1979 int8 TOP/s dense): at the
// vendored width (T=47, W=112) the packed blob bits in and the int32
// overlaps out, 0.00083 ms for a 4096-row batch and 0.050 ms at
// B=262144; at the synthetic-SPDX width (T=608, W=132) the 2*B*T*V
// tensor-core operations, 0.0106 ms at B=4096 and 0.68 ms at B=262144,
// of which the 637 MB of output alone would take 0.19 ms.
//
// Design.  One block computes a [128 blobs x BN templates] tile of the
// output; BN is one of the compiled wgmma widths (16, 48, 64, 128, 208;
// the wrapper picks it: T=47 runs one 48-wide tile, T=608 three 208-wide
// ones), so each blob tile is unpacked once per up to 208 templates.
// (A 256-wide tile needs more than the 168 registers a thread can have
// when nine warps share an SM's four register files: ptxas spills it.)
//
// * Templates: the host-unpacked int8 [T_pad, V_pad] matrix is K-major,
//   the only layout wgmma takes for 8-bit B.  One producer warp streams
//   [BN x 128-byte] slices of it with TMA (128-byte swizzle) into a ring
//   of K2_STAGES shared-memory stages, each completed on an mbarrier;
//   rows past T_pad arrive as TMA's zero fill.
// * Blobs: kept packed all the way into shared memory, 32x fewer bytes
//   than unpacked: the same TMA transaction brings the [128 x 4] uint32
//   words of the stage's 128 columns.  No unpacked A tile exists.  For
//   wgmma's register-A fragment of m64nNk32 a thread holds, per 32-column
//   k-step, bytes 4*tig..+3 and 16+4*tig..+3 of rows g and g+8 of its
//   warp's 16 rows: nibble tig and nibble 4+tig of one packed word each,
//   which `spread_nibble` turns into four 0/1 bytes with one multiply.
// * Contraction: two consumer warpgroups (64 blob rows each) issue
//   wgmma.mma_async.m64nBNk32.s32.s8.s8 with A from registers and B from
//   the stage's swizzled tile, four k-steps per stage, accumulators in
//   registers; each warp releases the stage to the producer once its
//   group has completed, so the TMA loads of the next stages overlap the
//   products of this one.
// * Small batches: where the grid of (template tile, blob tile) pairs
//   has fewer blocks than the card has SMs (the main path's B=4096 gives
//   32), the wrapper splits the V stages over gridDim.z; the output is
//   zeroed on the stream first and the blocks add their int32 partials
//   into it with atomicAdd.
//   The sum is exact and independent of the order the blocks run in,
//   because integer addition is associative.
// * Epilogue: accumulators go straight to [B, T] (8-byte stores where T
//   is even, 4-byte ones where an odd T leaves rows unaligned).
//
// The tensor maps are encoded on the host through the runtime's driver
// entry point, so the library links against the CUDA runtime only.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from
                   // cudaGetDriverEntryPoint*, not from libcuda at link
#include <cuda_runtime.h>

namespace {

constexpr int K2_CONSUMER_WARPS = 8;  // two warpgroups
constexpr int K2_THREADS = (K2_CONSUMER_WARPS + 1) * 32;  // + producer warp
constexpr int K2_BM = 128;           // blob rows per block, 64 per warpgroup
constexpr int K2_STAGE_K = 128;      // columns (template bytes) per stage
constexpr int K2_STAGE_WORDS = K2_STAGE_K / 32;
constexpr int K2_STAGES = 4;
constexpr int K2_BLOB_TILE = K2_BM * K2_STAGE_WORDS * 4;  // 2048 bytes

template <int BN>
struct K2Layout {
  static constexpr int kTplBytes = BN * K2_STAGE_K;  // a multiple of 1024
  static constexpr int kStageBytes = kTplBytes + K2_BLOB_TILE;
  // + 1024 so the ring can start on the 1024-byte boundary the 128-byte
  // swizzle pattern repeats on
  static constexpr int kDynamicSmem = K2_STAGES * kStageBytes + 1024;
};

// 4 bits -> 4 bytes of 0/1: bit j of the nibble lands in byte j
__device__ __forceinline__ uint32_t spread_nibble(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile under the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused by swizzled K-major layouts (1 by convention).
// A k-step of 32 bytes inside the swizzle atom advances the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma boundary
template <int N>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk32, s32 += s8 (A: 4 registers) x s8 (B: shared
// descriptor), one specialization per compiled tile width
template <int N>
__device__ void wgmma_s8(int* d, const uint32_t* a, uint64_t desc);

#define K2_D8(i)                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_s8<16>(int* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : K2_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<48>(int* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p;\n}\n"
      : K2_D8(0), K2_D8(8), K2_D8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : K2_D8(0), K2_D8(8), K2_D8(16), K2_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : K2_D8(0), K2_D8(8), K2_D8(16), K2_D8(24),
        K2_D8(32), K2_D8(40), K2_D8(48), K2_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<208>(int* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, {%104, %105, %106, %107}, %108, p;\n}\n"
      : K2_D8(0), K2_D8(8), K2_D8(16), K2_D8(24),
        K2_D8(32), K2_D8(40), K2_D8(48), K2_D8(56),
        K2_D8(64), K2_D8(72), K2_D8(80), K2_D8(88),
        K2_D8(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#undef K2_D8

__device__ __forceinline__ void store_pair(int* __restrict__ out, int B,
                                           int T, int row, int col, int v0,
                                           int v1, bool accumulate) {
  if (row >= B || col >= T) return;
  int* p = out + static_cast<size_t>(row) * T + col;
  if (accumulate) {
    atomicAdd(p, v0);
    if (col + 1 < T) atomicAdd(p + 1, v1);
  } else if ((T & 1) == 0) {  // col is even: the pair is 8-byte aligned
    *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
  } else {
    p[0] = v0;
    if (col + 1 < T) p[1] = v1;
  }
}

template <int BN>
__global__ void __launch_bounds__(K2_THREADS, 1)
    dice_overlap_wgmma_kernel(const __grid_constant__ CUtensorMap tpl_map,
                              const __grid_constant__ CUtensorMap file_map,
                              int* __restrict__ out, int B, int T,
                              int n_stages, int stages_per_split) {
  using L = K2Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[K2_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[K2_STAGES];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint8_t* ring_ptr = smem_raw + (ring - raw);
  const int n0 = blockIdx.x * BN;
  const int b0 = blockIdx.y * K2_BM;
  const int s_begin = blockIdx.z * stages_per_split;
  const int s_end = min(n_stages, s_begin + stages_per_split);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < K2_STAGES; ++i) {
      mbar_init(smem_u32(&full_bar[i]), 1);
      mbar_init(smem_u32(&empty_bar[i]), K2_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == K2_CONSUMER_WARPS) {
    // producer: one thread keeps up to K2_STAGES stages in flight
    if (lane == 0) {
      for (int s = s_begin, i = 0; s < s_end; ++s, ++i) {
        const int slot = i % K2_STAGES;
        // the first pass over the ring finds every slot free
        mbar_wait(smem_u32(&empty_bar[slot]), ((i / K2_STAGES) & 1) ^ 1);
        const uint32_t full = smem_u32(&full_bar[slot]);
        const uint32_t tile = ring + slot * L::kStageBytes;
        mbar_expect_tx(full, L::kStageBytes);
        tma_load_2d(tile, &tpl_map, full, s * K2_STAGE_K, n0);
        tma_load_2d(tile + L::kTplBytes, &file_map, full,
                    s * K2_STAGE_WORDS, b0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64); a thread
  // owns rows r and r + 8 of its warp's 16
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int r = (warp / 4) * 64 + (warp % 4) * 16 + g;

  int d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;

  for (int s = s_begin, i = 0; s < s_end; ++s, ++i) {
    const int slot = i % K2_STAGES;
    mbar_wait(smem_u32(&full_bar[slot]), (i / K2_STAGES) & 1);
    const uint32_t tile = ring + slot * L::kStageBytes;
    const uint4* blob = reinterpret_cast<const uint4*>(
        ring_ptr + slot * L::kStageBytes + L::kTplBytes);
    const uint4 lo = blob[r];      // row r: the stage's 4 packed words
    const uint4 hi = blob[r + 8];  // row r + 8
    const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w};
    const uint32_t wh[4] = {hi.x, hi.y, hi.z, hi.w};
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = spread_nibble(wl[kk] >> (4 * tig));
      a[kk][1] = spread_nibble(wh[kk] >> (4 * tig));
      a[kk][2] = spread_nibble(wl[kk] >> (16 + 4 * tig));
      a[kk][3] = spread_nibble(wh[kk] >> (16 + 4 * tig));
    }
    fence_regs<BN / 2>(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_s8<BN>(d, a[kk], sw128_desc(tile + kk * 32));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<BN / 2>(d);
    if (lane == 0) mbar_arrive(smem_u32(&empty_bar[slot]));
  }

  const bool accumulate = gridDim.z > 1;
  const int row = b0 + r;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * tig;
    store_pair(out, B, T, row, col, d[4 * j], d[4 * j + 1], accumulate);
    store_pair(out, B, T, row + 8, col, d[4 * j + 2], d[4 * j + 3],
               accumulate);
  }
}

// -- host ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 2-D row-major map: `cols` elements of `elem_bytes` per row, `rows` rows
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               int elem_bytes, uint64_t cols, uint64_t rows, uint32_t box_cols,
               uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const CUtensorMap& tpl_map, const CUtensorMap& file_map, int* out,
           int B, int T, int n_stages, int splits, cudaStream_t stream) {
  using L = K2Layout<BN>;
  // on every launch: the limit belongs to the current device's context,
  // and the call is cheap next to the tensor maps' encoding
  const cudaError_t attr = cudaFuncSetAttribute(
      dice_overlap_wgmma_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDynamicSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int per_split = (n_stages + splits - 1) / splits;
  // template tiles fastest: the blocks that run together share one blob
  // tile, read once from device memory, while all template tiles stay in L2
  const dim3 grid((T + BN - 1) / BN, (B + K2_BM - 1) / K2_BM, splits);
  dice_overlap_wgmma_kernel<BN><<<grid, K2_THREADS, L::kDynamicSmem, stream>>>(
      tpl_map, file_map, out, B, T, n_stages, per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// overlap int32[B, T] of packed blob bits (B rows of W uint32 words, W a
// multiple of 4, 16-byte aligned) against the unpacked templates (int8
// [t_pad, 32 W], t_pad a multiple of 16) on `stream`, in [128 x bn] tiles
// (bn one of 16, 48, 64, 128, 208) with the V stages split over
// `splits` blocks, which add into `out` after it is zeroed here on the
// stream.  Returns the first failing call's cudaError_t, or -1 when a
// tensor map cannot be encoded.
extern "C" int dice_overlap_mma(const void* tpl, const void* file, void* out,
                                int B, int T, int W, int t_pad, int bn,
                                int splits, void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || W % K2_STAGE_WORDS || splits < 1 ||
      T > t_pad || (B + K2_BM - 1) / K2_BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tpl_map, file_map;
  if (!encode_2d(&tpl_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, tpl, 1,
                 static_cast<uint64_t>(32) * W, t_pad, K2_STAGE_K, bn,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&file_map, CU_TENSOR_MAP_DATA_TYPE_UINT32, file, 4, W, B,
                 K2_STAGE_WORDS, K2_BM, CU_TENSOR_MAP_SWIZZLE_NONE))
    return -1;
  const int n_stages = W / K2_STAGE_WORDS;
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    const cudaError_t err = cudaMemsetAsync(
        o, 0, static_cast<size_t>(B) * T * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (bn) {
    case 16: return launch<16>(tpl_map, file_map, o, B, T, n_stages, splits, s);
    case 48: return launch<48>(tpl_map, file_map, o, B, T, n_stages, splits, s);
    case 64: return launch<64>(tpl_map, file_map, o, B, T, n_stages, splits, s);
    case 128: return launch<128>(tpl_map, file_map, o, B, T, n_stages, splits, s);
    case 208: return launch<208>(tpl_map, file_map, o, B, T, n_stages, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
