// Building blocks of Hopper (sm_90a) tensor-core kernels, free of any
// kernel's own logic:
//   * shared-memory matrix descriptors for wgmma over tiles that TMA wrote
//     with the 128-byte swizzle, K-major and MN-major (transposed);
//   * the bf16 wgmma.mma_async products m64nNk16 with float32 accumulators,
//     N = 64 or 128, A from shared memory (SS) or from registers (RS), and
//     their fence, commit and wait;
//   * mbarriers (init, arrive, arrive with an expected transaction count,
//     wait on a phase's parity), setmaxnreg, named barriers;
//   * 4-byte cp.async copies with zero fill that arrive on an mbarrier;
//   * TMA: 3-D and 4-D tensor loads into shared memory and 4-D stores out of
//     it, and the host-side encoding of a tensor map.
//
// Layout the descriptors assume (the one TMA writes for a box whose inner
// extent is 64 bf16 = 128 bytes under CU_TENSOR_MAP_SWIZZLE_128B): rows of
// 128 bytes, 8 rows to a 1024-byte atom, atoms back to back, the 16-byte
// chunks of row r at chunk ^ (r % 8). Every tile starts 1024-byte aligned.
// A tile wider than 64 columns is several such 64-column boxes one after
// the other ("chunks").
#pragma once

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- wgmma descriptors -------------------------------------------------------

// Bits 0-13 start address >> 4, 16-29 leading byte offset >> 4, 32-45
// stride byte offset >> 4, 62-63 layout (1 = 128-byte swizzle).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// K-major operand (rows of the M or N dimension, K contiguous): `p` points
// at the row-0 address of the 16-column K slice, i.e. the chunk's base plus
// 32 bytes per k16 step inside the 128-byte row (the swizzle is applied to
// the address bits, so the step needs no base offset). Consecutive 8-row
// atoms are 1024 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t desc_k_major(const void* p) {
  return make_desc(p, 16, 1024);
}

// MN-major operand (rows of the K dimension, M or N contiguous): `p` points
// at the first of the k16 step's 16 K rows (2 atoms, 1024 bytes apart);
// `chunk_bytes` is the distance between consecutive 64-column chunks of the
// N dimension (used when N = 128).
__device__ __forceinline__ uint64_t desc_mn_major(const void* p,
                                                  uint32_t chunk_bytes) {
  return make_desc(p, chunk_bytes, 1024);
}

// -- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers across
// the fence, commit and wait above (they carry no data dependence).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_F8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31}"
#define HOPPER_D64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, float32 accumulate. The
// accumulator of thread t (warp w = t / 32 of the warpgroup, lane l) holds
// d[4 j + 2 i + e] = D[16 w + l / 4 + 8 i][8 j + 2 (l % 4) + e].
// `accumulate` 0 overwrites D. kTransA / kTransB: 0 for a K-major operand,
// 1 for an MN-major one.
template <int N, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16),
          HOPPER_F8(d, 24)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16),
          HOPPER_F8(d, 24), HOPPER_F8(d, 32), HOPPER_F8(d, 40),
          HOPPER_F8(d, 48), HOPPER_F8(d, 56)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
  }
}

// The same with A in registers: a[0..3] hold bf16 pairs of A[16 w + l / 4 +
// 8 (q % 2)][2 (l % 4) + 8 (q / 2) + {0, 1}] for q = 0..3, low half first;
// which is the accumulator layout above, so an m64 accumulator over 16
// columns converts in place (to_a_frag).
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16),
          HOPPER_F8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16),
          HOPPER_F8(d, 24), HOPPER_F8(d, 32), HOPPER_F8(d, 40),
          HOPPER_F8(d, 48), HOPPER_F8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(kTransB));
  }
}

#undef HOPPER_F8
#undef HOPPER_D32
#undef HOPPER_D64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The RS A operand for k16 step kk from an m64 accumulator `d` whose
// columns are that product's K dimension (rounded to bf16).
template <int N>
__device__ __forceinline__ void to_a_frag(const float (&d)[N], int kk,
                                          uint32_t (&a)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    a[q] = pack_bf16(d[8 * kk + 2 * q], d[8 * kk + 2 * q + 1]);
}

// -- warpgroups and barriers -------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// After the inits, before any other thread uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// One arrival, and `bytes` more expected from TMA in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts its preceding phase, parity 1, as completed).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// -- cp.async ----------------------------------------------------------------

// 4 bytes from global to shared memory, or 4 zero bytes when `valid` is
// false (src must still be a valid address; it is not read).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// An arrival on `bar` once this thread's cp.async copies so far have
// landed; it is one of the barrier's expected arrivals (noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// -- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// Elements of the box outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// Each writing thread, after its shared-memory stores and before the
// barrier that precedes a TMA store of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The issuing thread: commit its stores and wait until their shared-memory
// sources have been read.
__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Byte offset of element (row, col) of a 64-column bf16 box in the 128-byte
// swizzle, relative to the box's 1024-byte aligned base.
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// -- host --------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links against nothing but the runtime. Null if it is missing.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tiled tensor map of `rank` dims (innermost first: sizes, byte strides
// of dims 1.., box), unit element strides, zero fill outside the tensor.
// Returns false if the driver refuses it.
inline bool encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                         int rank, const void* base, const uint64_t* dims,
                         const uint64_t* strides, const uint32_t* box,
                         CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, type, static_cast<cuuint32_t>(rank),
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
