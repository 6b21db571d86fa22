// Tile helpers shared by the flash-attention forward and backward kernels
// and the block-sparse forward: 64-row tiles staged in float32 shared memory
// by 256 threads laid out as 16 x 16, each thread owning 4 rows (ty * 4 + i)
// and 4 columns (tx + 16 j) of a 64 x 64 score tile, and a 4 x d/16 patch
// (columns 64 cc + 4 tx + e) of a 64 x d output tile; the additive mask's
// readers; the dispatch over input type, head dim and mask type.
#pragma once

#include <type_traits>

#include "common.cuh"

// The additive attention mask's type code, passed by the wrappers (and a
// template argument of the kernels): none, float32, or bfloat16.
enum MaskCode { kNoMask = 0, kMaskF32 = 1, kMaskBF16 = 2 };

namespace {

constexpr int kBlockM = 64;   // Q rows per tile
constexpr int kBlockN = 64;   // K/V rows per tile
constexpr int kThreads = 256; // 16 x 16 threads
constexpr float kNegInf = -1e30f;
constexpr int kLdS = kBlockN + 4;  // score-tile row stride (floats)

// Copy kBlockN x D elements of a [*, row_stride] tensor into float32 shared
// memory (leading dimension ld, a multiple of 4), scaled, zero-filling rows
// past `valid` and columns past `cols` (a multiple of 16 bytes of T).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          size_t row_stride, int valid,
                                          float scale, int cols = D) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kChunks = kBlockN * D / kVec;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / kVec);
    const int col = (c % (D / kVec)) * kVec;
    float vals[kVec];
    if (r < valid && col < cols) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + r * row_stride + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = to_f32(e[i]) * scale;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      *reinterpret_cast<float4*>(dst + r * ld + col + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float a, float b, float c,
                                       float d);
template <>
__device__ __forceinline__ void store4<float>(float* dst, float a, float b,
                                              float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float a, float b,
                                                      float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// out[i][j] = sum_k A[ty*4 + i][k] * B[tx + 16 j][k] over D columns of two
// shared-memory tiles with leading dimension ld (float4 reads).
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ld, float out[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * ld + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * ld + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = out[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        out[i][j] = s;
      }
  }
}

// acc[i][4 cc + e] += sum_j P[ty*4 + i][j] * X[j][64 cc + 4 tx + e]: a
// 64 x 64 tile P (leading dimension kLdS) times a 64 x D tile X (leading
// dimension ld), into the thread's 4 x D/16 register patch.
template <int D>
__device__ __forceinline__ void tile_accumulate(const float* p,
                                                const float* x, int ld,
                                                float acc[4][D / 16]) {
  constexpr int kChunks = D / 64;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 2
  for (int j = 0; j < kBlockN; j += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty * 4 + i) * kLdS + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc) {
        const float4 xv = *reinterpret_cast<const float4*>(
            x + (j + jj) * ld + 64 * cc + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = jj == 0 ? pv[i].x
                        : jj == 1 ? pv[i].y
                        : jj == 2 ? pv[i].z
                                  : pv[i].w;
          acc[i][cc * 4 + 0] = fmaf(w, xv.x, acc[i][cc * 4 + 0]);
          acc[i][cc * 4 + 1] = fmaf(w, xv.y, acc[i][cc * 4 + 1]);
          acc[i][cc * 4 + 2] = fmaf(w, xv.z, acc[i][cc * 4 + 2]);
          acc[i][cc * 4 + 3] = fmaf(w, xv.w, acc[i][cc * 4 + 3]);
        }
      }
    }
  }
}

// The (batch, head) plane of an additive mask [batch, mask_heads, s, s]:
// one plane serves every head when mask_heads is 1.
template <int kMask>
__device__ __forceinline__ const void* mask_plane(const void* mask, int b,
                                                  int h, int mask_heads,
                                                  int s) {
  constexpr size_t kBytes = kMask == kMaskF32 ? 4 : 2;
  const size_t plane = static_cast<size_t>(b) * mask_heads +
                       (mask_heads == 1 ? 0 : h);
  return static_cast<const char*>(mask) + plane * s * s * kBytes;
}

// Element (row, col) of a mask plane, as float32.
template <int kMask>
__device__ __forceinline__ float mask_at(const void* plane, int s, int row,
                                         int col) {
  const size_t at = static_cast<size_t>(row) * s + col;
  if constexpr (kMask == kMaskF32) {
    return __ldg(static_cast<const float*>(plane) + at);
  } else {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(plane)[at]);
  }
}

template <typename T>
struct Tag {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// Calls f(Tag<T>, Int<D>, Int<kMask>) for the runtime input type, head dim
// (64 or 128) and mask code; the mask is float32 or of the inputs' type.
// Returns what f returns, or cudaErrorInvalidValue for another combination.
template <typename F>
int dispatch(int dtype, int d, int mask, F&& f) {
  auto by_dim = [&](auto t, auto m) -> int {
    if (d == 64) return f(t, Int<64>{}, m);
    if (d == 128) return f(t, Int<128>{}, m);
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (dtype == kFloat32) {
    if (mask == kNoMask) return by_dim(Tag<float>{}, Int<kNoMask>{});
    if (mask == kMaskF32) return by_dim(Tag<float>{}, Int<kMaskF32>{});
  } else if (dtype == kBFloat16) {
    using B = __nv_bfloat16;
    if (mask == kNoMask) return by_dim(Tag<B>{}, Int<kNoMask>{});
    if (mask == kMaskF32) return by_dim(Tag<B>{}, Int<kMaskF32>{});
    if (mask == kMaskBF16) return by_dim(Tag<B>{}, Int<kMaskBF16>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
