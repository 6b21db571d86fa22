// Pieces shared by the flash-attention forward and backward kernels and the
// block-sparse forward:
//   * the float32 FMA kernels' tiles: 64-row tiles staged in float32 shared
//     memory by 256 threads laid out as 16 x 16, each thread owning 4 rows
//     (ty * 4 + i) and 4 columns (tx + 16 j) of a 64 x 64 score tile, and a
//     4 x d/16 patch (columns 64 cc + 4 tx + e) of a 64 x d output tile;
//   * the additive mask's readers; the dispatch over input type, head dim,
//     mask type and dropout;
//   * dropout's keep mask (Dropout, keep_bits): the hash of the TPU
//     kernels' interpret path, so the plain versions and the kernels draw
//     the same mask;
//   * the bf16 tensor-core kernels' pieces (namespace wg): block shape and
//     shared-memory layout, wgmma descriptors of swizzled tiles, mask
//     windows, tensor maps, and the forward's online-softmax consumer loop
//     (fwd_consume), which flash_fwd_wgmma and block_sparse_fwd_wgmma share.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper_mma.cuh"

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

// Dropout on the attention probabilities: an entry (row, col) of the
// (batch, q-head) plane bh is kept where
//   x = row C1 ^ col C2 ^ bh C3 ^ seed C4 (uint32), then murmur3's finalizer
// (x ^= x >> 16, x *= 0x85EBCA6B, x ^= x >> 13, x *= 0xC2B2AE35,
// x ^= x >> 16) is at least `threshold` = min(p 2^32, 2^32 - 1), and kept
// entries are scaled by `scale` = 1 / (1 - p) in float32: the keep mask of
// paddle_tpu/ops/pallas/flash_attention.py::_keep_mask on its interpret
// path, bit for bit (the TPU path's hardware generator does not port). row
// is always the query position and col the key position, also in the
// dK/dV kernels, whose tiles are transposed. The row and column products
// are hoisted: per element the mask costs three shift-xors, two multiplies
// and a compare.
constexpr uint32_t kDropRowMul = 0x9E3779B9u;
constexpr uint32_t kDropColMul = 0x85EBCA6Bu;
constexpr uint32_t kDropBhMul = 0xC2B2AE35u;
constexpr uint32_t kDropSeedMul = 0x27D4EB2Fu;

struct Dropout {
  uint32_t threshold;
  float scale;
  uint32_t seed;
  // the hash's part that is fixed per (batch, q-head) plane
  __device__ __forceinline__ uint32_t base(int bh) const {
    return static_cast<uint32_t>(bh) * kDropBhMul ^ seed * kDropSeedMul;
  }
};

// row_mix = row C1 ^ base(bh), col_mix = col C2: whether the entry is kept.
__device__ __forceinline__ bool keep_bits(uint32_t row_mix, uint32_t col_mix,
                                          uint32_t threshold) {
  uint32_t x = row_mix ^ col_mix;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= threshold;
}

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

// The same, calling f(Tag<T>, Int<D>, Int<kMask>, Bool<kDrop>): the flash
// kernels' dropout builds beside the ones without.
template <bool B>
using Bool = std::bool_constant<B>;
template <typename F>
int dispatch(int dtype, int d, int mask, bool drop, F&& f) {
  return dispatch(dtype, d, mask, [&](auto t, auto dim, auto m) {
    if (drop) return f(t, dim, m, Bool<true>{});
    return f(t, dim, m, Bool<false>{});
  });
}


// -- bf16 tensor-core (wgmma) kernels ----------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 384;        // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;    // arrivals that free a ring stage
constexpr int kRows = 64;            // rows of a box and of a warpgroup
constexpr int kChunkBytes = kRows * 128;  // one 64-row, 64-column box
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// The mask window of a block of 128 q rows and a 64-row K tile (dQ and the
// forward): 128 rows x 72 elements (64 k columns + 8 spare). TMA wants rows
// of a multiple of 16 bytes; this pitch also keeps each warp's reads on
// distinct banks.
constexpr int kMaskPitch = 72;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int round1k(int bytes) { return (bytes + 1023) / 1024 * 1024; }
// Three ring stages where a block's 232,448 bytes of shared memory hold
// them (beside `fixed` bytes, the barriers and the alignment slack), else 2.
constexpr int ring_stages(int fixed, int stage) {
  return fixed + 3 * stage + 1024 + 64 <= 232448 ? 3 : 2;
}
template <int kMask>
constexpr int kMaskElemBytes =
    kMask == kNoMask ? 0 : kMask == kMaskF32 ? 4 : 2;

// The forward's shared memory (byte offsets from a 1024-byte aligned base):
// the Q tiles of kWGs consumer warpgroups, then the ring of K, V and mask
// window stages, then the barriers. A Q tile is 64 rows by D bf16: D / 64
// boxes of kChunkBytes; a K or V tile is kN rows, each of its 64-column
// chunks kN / 64 boxes one after the other (kN * 128 bytes). The mask
// window is [64 kWGs q rows x kN + 8] (kPitch: 8 spare columns keep each
// warp's reads on distinct banks).
template <int D, int kMask, bool kWindow, int kWGs, int kN>
struct FwdLayout {
  static constexpr int kTile = D / 64 * kChunkBytes;
  static constexpr int kKVTile = D / 64 * kN * 128;
  static constexpr int kPitch = kN + 8;
  static constexpr int kMaskBox =
      kWindow ? kWGs * kRows * kPitch * kMaskElemBytes<kMask> : 0;
  static constexpr int kQ = 0;                   // [kWGs][tile]
  static constexpr int kStage0 = kWGs * kTile;   // K, V, mask window
  static constexpr int kStageBytes = 2 * kKVTile + round1k(kMaskBox);
  static constexpr int kStages = ring_stages(kStage0, kStageBytes);
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// k16 step kk of a K-major tile: its chunk (`chunk` bytes apart), then 32
// bytes a step in the row.
__device__ __forceinline__ uint64_t k_major(const uint8_t* tile, int kk,
                                           int chunk = kChunkBytes) {
  return hopper::desc_k_major(tile + (kk / 4) * chunk + (kk % 4) * 32);
}
// k16 step kk of an MN-major tile: 16 rows (2048 bytes) a step.
__device__ __forceinline__ uint64_t mn_major(const uint8_t* tile, int kk,
                                            int chunk = kChunkBytes) {
  return hopper::desc_mn_major(tile + kk * 2048, chunk);
}

// TMA loads of a tile of kN rows from `row` of one head into dst: per
// 64-column chunk, kN / 64 boxes of 64 rows one after the other.
template <int D, int kN>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int head, int row,
                                          int batch) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int r = 0; r < kN / 64; ++r)
      hopper::tma_load_4d(dst + c * kN * 128 + r * kChunkBytes, map, bar,
                          64 * c, head, row + kRows * r, batch);
}

// Two adjacent mask elements (c even) of a window in shared memory.
template <int kMask>
__device__ __forceinline__ float2 window_pair(const uint8_t* win, int pitch,
                                              int r, int c) {
  if constexpr (kMask == kMaskF32) {
    return *reinterpret_cast<const float2*>(
        reinterpret_cast<const float*>(win) + r * pitch + c);
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        reinterpret_cast<const bf16*>(win) + r * pitch + c));
  }
}

// Mask elements (row, col) and (row, col + 1) of a plane in global memory,
// 0 past s.
template <int kMask>
__device__ __forceinline__ float2 global_pair(const void* plane, int s,
                                              int row, int col) {
  float2 m = make_float2(0.f, 0.f);
  if (row < s) {
    if (col < s) m.x = mask_at<kMask>(plane, s, row, col);
    if (col + 1 < s) m.y = mask_at<kMask>(plane, s, row, col + 1);
  }
  return m;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Round a warpgroup's float32 [64 x D] accumulator (times `mul`, per row
// half i: mul[i]) to bf16 into a tile of D / 64 swizzled boxes, for a TMA
// store.
template <int D>
__device__ __forceinline__ void acc_to_tile(const float (&acc)[D / 2],
                                            const float (&mul)[2],
                                            uint8_t* tile, int warp,
                                            int lane) {
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i, c = 8 * j + 2 * tq;
      *reinterpret_cast<uint32_t*>(tile + (c / 64) * kChunkBytes +
                                   hopper::sw128_offset(r, c % 64)) =
          hopper::pack_bf16(acc[4 * j + 2 * i] * mul[i],
                            acc[4 * j + 2 * i + 1] * mul[i]);
    }
}
template <int D>
__device__ __forceinline__ void acc_to_tile(const float (&acc)[D / 2],
                                            float mul, uint8_t* tile,
                                            int warp, int lane) {
  const float both[2] = {mul, mul};
  acc_to_tile<D>(acc, both, tile, warp, lane);
}

// The forward's consumer loop: one warpgroup's 64 Q rows (its tile sQ,
// absolute rows row0 ..) against K/V tiles of kN rows streamed through the
// ring (stage st at ring + st * stage_bytes: K, then V kv_tile_bytes on,
// then the mask window), with the online softmax in the accumulators. Of
// the n_tiles tiles the warpgroup multiplies the first n_active (a causal
// block's last tiles lie past its first warpgroup's rows) and only frees
// the others; in the first n_interior every score counts (no causal
// diagonal, no ragged edge), so no position is checked there. k0_of(t) is
// tile t's first row; mask_pair(stage, r, c, row, col) the additive mask at
// (row, col) and (row, col + 1), r being the row within this warpgroup and
// c the column within the tile. On return acc holds O unnormalised, m the
// row max of the score variable y and l the row sum of P over the row's
// four lanes (reduced).
//
// Unmasked, y is the raw score S = Q K^T and P = ex2(S c - m c) with c =
// scale log2(e): one FMA and ex2. With a mask, y = S scale + mask, formed
// first as the plain version forms it, so that -1e9 absorbs the score in
// the same rounding, and P = ex2((y - m) log2(e)). A score dropped by the
// causal mask or the ragged edge gets P = 0 (TMA's zero fill makes a row
// or column past s a score of 0, not -inf) and no part in the max. P is
// rounded to bf16 in place as the A operand of O += P V (V read MN-major);
// l sums the unrounded P. Row maxima and sums run over four partial values
// a lane, not one chain.
//
// With kOverlap the products overlap the softmax within the warpgroup, as
// in FlashAttention-3: tile t's S and tile t - 1's P V are issued
// together, the softmax of S runs while P V is in flight, and only then is
// O rescaled and tile t - 1's stage freed. A warpgroup then holds two
// stages at once, so this needs a ring of three; with two (a float32 mask
// window at d = 128) each tile's P V is issued and retired after its
// softmax. ptxas serialises wgmma when a product is in flight across a
// branch it cannot prove uniform, so each step issues and retires its own
// products, and the branches (first tile, interior or checked tiles) are
// hoisted out of the loops into separate instantiations of the step.
//
// With kDrop the P that feeds P V keeps the entries of the dropout mask
// (keep_bits; `drop_base` is Dropout::base of the block's plane), scaled by
// drop.scale, after l has summed the undropped P, as _fwd_kernel does.
//
// With kPingPong the block's two consumer warpgroups (cw 0 and 1) take
// turns to issue their products, on named barriers kTurnBarrier + cw, as
// FlashAttention-3 does: warpgroup 1 issues tile t's after warpgroup 0 has
// issued its, and warpgroup 0 tile t + 1's after warpgroup 1 has issued
// tile t's, so that one warpgroup's softmax runs while the other's products
// keep the tensor cores busy. Both take a turn for every tile, active or
// not, so the barriers balance.
constexpr int kTurnBarrier = 3;  // and 4; 1 and 2 are store_o's

template <int D, int kN, int kMask, bool kOverlap, bool kPingPong,
          bool kDrop = false, typename K0, typename MaskPair>
__device__ __forceinline__ void fwd_consume(
    const uint8_t* sQ, const uint8_t* ring, int stage_bytes, int stages,
    int kv_tile_bytes, uint64_t* full, uint64_t* empty, int n_tiles,
    int n_active, int n_interior, int row0, int s, bool causal, float scale,
    int cw, K0 k0_of, MaskPair mask_pair, float (&acc)[D / 2],
    float (&m)[2], float (&l)[2], Dropout drop = {}, uint32_t drop_base = 0) {
  constexpr bool kLean = kMask == kNoMask;
  constexpr int kKVChunk = kN * 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r_l = 16 * warp + g;  // and r_l + 8
  const float c = kLean ? scale * kLog2e : kLog2e;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float sc[kN / 2];
  uint32_t a[kN / 16][4];
  auto stage = [&](int t) { return ring + (t % stages) * stage_bytes; };
  auto wait_full = [&](int t) {
    hopper::mbar_wait(&full[t % stages], (t / stages) & 1);
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[t % stages]);
  };
  auto turn_begin = [&] {
    if (kPingPong) hopper::named_barrier(kTurnBarrier + cw, 256);
  };
  auto turn_end = [&] {
    if (kPingPong) hopper::named_barrier_arrive(kTurnBarrier + 1 - cw, 256);
  };
  auto issue_pv = [&](int t) {
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      hopper::wgmma_rs<D, 1>(acc, a[kk],
                             mn_major(stage(t) + kv_tile_bytes, kk, kKVChunk),
                             1);
    hopper::wgmma_commit();
  };
  auto fence_pv = [&] {
    hopper::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) hopper::fence_regs(a[kk]);
  };
  // S of tile t (in sc) to P in place; alpha rescales O to the new row max
  auto softmax = [&](auto checks, int t, float (&alpha)[2]) {
    constexpr bool kCheck = decltype(checks)::value;
    const int k0 = k0_of(t);
    auto keep = [&](int i, int col) {
      const int row = row0 + r_l + 8 * i;
      return row < s && col < s && (!causal || col <= row);
    };
    float mx[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) mx[i][u] = kNegInf;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int cc = 8 * j + 2 * tq;
        float2 mk = make_float2(0.f, 0.f);
        if constexpr (!kLean)
          mk = mask_pair(stage(t), r_l + 8 * i, cc, row0 + r_l + 8 * i,
                         k0 + cc);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * i + e];
          if constexpr (!kLean) x = fmaf(x, scale, e ? mk.y : mk.x);
          if constexpr (kCheck)
            if (!keep(i, k0 + cc + e)) x = kNegInf;
          mx[i][j % 4] = fmaxf(mx[i][j % 4], x);
        }
      }
    float mc[2], rs[2][4] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mxi = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
      mxi = fmaxf(mxi, __shfl_xor_sync(0xffffffffu, mxi, 1));
      mxi = fmaxf(mxi, __shfl_xor_sync(0xffffffffu, mxi, 2));
      const float m_new = fmaxf(m[i], mxi);
      alpha[i] = ex2((m[i] - m_new) * c);
      m[i] = m_new;
      mc[i] = m_new * c;
    }
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * i + e];
          float p = kLean ? ex2(fmaf(x, c, -mc[i])) : ex2((x - m[i]) * c);
          if constexpr (kCheck)
            if (!keep(i, k0 + 8 * j + 2 * tq + e)) p = 0.f;
          rs[i][j % 4] += p;
          x = p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = l[i] * alpha[i] + ((rs[i][0] + rs[i][1]) + (rs[i][2] + rs[i][3]));
  };
  // dropout of P(t) in place, after l has summed it and P(t - 1) V(t - 1)
  // has retired, so the hash's registers are not live beside that
  // product's operands
  auto drop_p = [&](int t) {
    const uint32_t col0 =
        static_cast<uint32_t>(k0_of(t) + 2 * tq) * kDropColMul;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t row =
            static_cast<uint32_t>(row0 + r_l + 8 * i) * kDropRowMul ^
            drop_base;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * i + e];
          x = keep_bits(row, col0 + static_cast<uint32_t>(8 * j + e) *
                                        kDropColMul,
                        drop.threshold)
                  ? x * drop.scale
                  : 0.f;
        }
      }
  };
  // one tile: S(t) and P(t - 1) V(t - 1) issued, the softmax of S(t), then
  // O rescaled and P(t) ready for the next step's product
  auto step = [&](int t, auto checks, auto first) {
    constexpr bool kFirst = !kOverlap || decltype(first)::value;
    wait_full(t);
    fence_pv();
    hopper::wgmma_fence();
    turn_begin();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<kN, 0, 0>(sc, k_major(sQ, kk),
                                 k_major(stage(t), kk, kKVChunk), kk);
    hopper::wgmma_commit();
    if constexpr (!kFirst) issue_pv(t - 1);
    turn_end();
    if constexpr (kFirst)
      hopper::wgmma_wait<0>();
    else
      hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
    float alpha[2];
    softmax(checks, t, alpha);
    if constexpr (!kFirst) {
      hopper::wgmma_wait<0>();
      fence_pv();
      release(t - 1);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= alpha[i];
        acc[4 * j + 2 * i + 1] *= alpha[i];
      }
    if constexpr (kDrop) drop_p(t);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) hopper::to_a_frag(sc, kk, a[kk]);
    if constexpr (!kOverlap) {
      fence_pv();
      hopper::wgmma_fence();
      issue_pv(t);
      hopper::wgmma_wait<0>();
      fence_pv();
      release(t);
    }
  };

  // warpgroup 0 takes the first turn
  if (kPingPong && cw == 1) hopper::named_barrier_arrive(kTurnBarrier, 256);
  int t = 0;
  if (n_active > 0) {
    if (n_interior > 0)
      step(0, std::false_type{}, std::true_type{});
    else
      step(0, std::true_type{}, std::true_type{});
    t = 1;
  }
  for (; t < n_interior; ++t) step(t, std::false_type{}, std::false_type{});
  for (; t < n_active; ++t) step(t, std::true_type{}, std::false_type{});
  if (kOverlap && n_active > 0) {
    fence_pv();
    hopper::wgmma_fence();
    issue_pv(n_active - 1);
    hopper::wgmma_wait<0>();
    fence_pv();
    release(n_active - 1);
  }
  for (; t < n_tiles; ++t) {
    wait_full(t);
    turn_begin();
    turn_end();
    release(t);
  }
  // the turn warpgroup 1 passed after its last tile
  if (kPingPong && cw == 0) hopper::named_barrier(kTurnBarrier, 256);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
}

// The epilogue's O = acc / max(l, 1e-20), rounded to bf16 into the
// warpgroup's own Q tile sQ (its last reader was its own S product), then
// stored by TMA at (column 0, head, row, batch) of `map`: rows and columns
// outside the tensor are not written. The warpgroup's 128 threads call it
// together; named barrier 1 + cw is theirs.
template <int D>
__device__ __forceinline__ void store_o(const float (&acc)[D / 2],
                                        const float (&l)[2], uint8_t* sQ,
                                        const CUtensorMap* map, int cw,
                                        int head, int row, int batch,
                                        bool any_row) {
  const int ct = threadIdx.x % 128;
  const float inv[2] = {1.f / fmaxf(l[0], 1e-20f), 1.f / fmaxf(l[1], 1e-20f)};
  acc_to_tile<D>(acc, inv, sQ, ct / 32, ct % 32);
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + cw, 128);
  if (ct == 0 && any_row) {
    for (int c = 0; c < D / 64; ++c)
      hopper::tma_store_4d(map, sQ + c * kChunkBytes, 64 * c, head, row,
                           batch);
    hopper::tma_store_commit_and_wait();
  }
}

}  // namespace wg

// -- host: tensor maps and launches of the wgmma kernels ---------------------

// A bf16 [batch, s, heads, d] tensor with element strides (batch, row,
// head) and a contiguous last dimension as the 4-D map (d, heads, s, batch)
// with 64 x 1 x 64 x 1 boxes in the 128-byte swizzle: one box is 64 rows of
// one head's 64-column chunk; rows past s and columns past d come back as
// zeros, and a store skips them.
inline bool rows_map(CUtensorMap* map, const void* base, int batch, int s,
                     int heads, int d, long long stride_b, long long stride_s,
                     long long stride_h) {
  const uint64_t dims[4] = {static_cast<uint64_t>(d),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(s),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {2ull * stride_h, 2ull * stride_s,
                               2ull * stride_b};
  const uint32_t box[4] = {64, 1, wg::kRows, 1};
  return hopper::encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                              dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_128B);
}
// The same for a contiguous [batch, s, heads, d] tensor.
inline bool rows_map(CUtensorMap* map, const void* base, int batch, int s,
                     int heads, int d) {
  const long long row = static_cast<long long>(heads) * d;
  return rows_map(map, base, batch, s, heads, d, row * s, row, d);
}

// The mask [batch, mask_heads, s, s] as the 3-D map (s, s, planes) with
// `cols` x `rows` x 1 boxes, unswizzled. Returns 1 if mapped, 0 if its rows
// are not a multiple of 16 bytes (the kernel then reads global memory), or
// -1 if the driver refuses it.
template <int kMask>
int mask_map(CUtensorMap* map, const void* mask, int batch, int mask_heads,
             int s_, int cols, int rows) {
  constexpr uint64_t kElem = wg::kMaskElemBytes<kMask>;
  const uint64_t s = static_cast<uint64_t>(s_);
  if ((s * kElem) % 16 != 0) return 0;
  const uint64_t dims[3] = {s, s, static_cast<uint64_t>(batch) * mask_heads};
  const uint64_t strides[2] = {s * kElem, s * s * kElem};
  const uint32_t box[3] = {static_cast<uint32_t>(cols),
                           static_cast<uint32_t>(rows), 1};
  const CUtensorMapDataType type = kMask == kMaskF32
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return hopper::encode_tiled(map, type, 3, mask, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_NONE)
             ? 1
             : -1;
}

// Opt in to `bytes` of dynamic shared memory (a cheap host call, made per
// launch so that it holds on whichever card is current) and launch.
template <typename Kernel, typename... KernelArgs>
int launch_wgmma(Kernel kernel, int bytes, dim3 grid, int threads,
                 cudaStream_t stream, KernelArgs... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, bytes, stream>>>(args...);
  RETURN_LAUNCH_ERROR();
}

}  // namespace
