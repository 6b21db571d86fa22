// Flash attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel, each in two builds chosen by the inputs' type.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (both launched by _bwd_call). With S = (Q / sqrt(d)) K^T
// and P = exp(S - LSE) recomputed from the forward's LSE, and
// delta = rowsum(dO * O) computed by the caller:
//   dQ = scale * sum_k dS K,   dS = P * (dO V^T - delta)
//   dV = P^T dO,               dK = dS^T (Q * scale)
// Causal or not, native GQA, an optional additive mask added to S before the
// causal mask, and dropout. The TPU kernels' kv_seqlens is not ported yet.
//
// Dropout (a template argument, kDrop, so the builds without it are
// unchanged) redraws the forward's keep mask from the same seed
// (keep_bits in flash_common.cuh): dP is dropped and scaled by 1 / (1 - p)
// before dS = P (dP - delta), and dV takes the dropped, scaled P, as
// _bwd_dq_kernel and _bwd_dkv_kernel do; delta is rowsum(dO * O) of the
// dropped O. The dK/dV kernels hold S^T (K rows by Q columns), so their
// hash takes the Q column as its row and the K row as its column: the mask
// is indexed by (query, key) in every kernel.
//
// Bound on this card: at the training shape (s = 2048, d = 128, causal) the
// three (dQ) and four (dK/dV) products do about s / 2 flops per byte moved,
// above the H100's ~295, so the least time is set by the bf16 tensor cores.
//
// bfloat16 inputs (the training path) take flash_bwd_dq_wgmma and
// flash_bwd_dkv_wgmma: bf16 wgmma products with float32 accumulators, fed
// by TMA (hopper_mma.cuh and flash_common.cuh hold the building blocks).
//   * Blocks of 384 threads: one producer warpgroup (its first warp issues
//     the TMA loads; setmaxnreg moves its registers to the others: 24 and
//     240 a thread) and two consumer warpgroups of 64 rows each. Tiles are
//     64-row boxes of 64 bf16 columns (two at d = 128) in the 128-byte
//     swizzle that the wgmma descriptors read; a ring of full/empty
//     mbarriers, 3 stages where shared memory holds them and 2 with a
//     float32 mask window at d = 128, streams the other operand.
//   * dQ: a block owns 128 Q rows (batch * q-head the fastest grid
//     dimension, the heaviest causal tiles first). Q and dO stay in shared
//     memory; K, V and the mask window stream. S = Q K^T and dP = dO V^T are
//     SS products; P and dS = P (dP - delta) are formed in the accumulator
//     registers, rounded to bf16 in place as the A operand of dQ += dS K
//     (RS, K read MN-major). A causal block stops at the diagonal.
//   * dK/dV: a block owns 128 K rows and walks every Q head of its GQA group
//     and, when causal, only the Q tiles at or past the diagonal. K and V
//     stay; Q, dO, the mask window, and LSE and delta (4-byte cp.async
//     copies by the producer's lanes, zeros past s) stream. The scores are
//     formed transposed, S^T = K Q^T and dP^T = V dO^T (SS), so P^T and dS^T
//     feed dV += P^T dO and dK += dS^T Q from registers with no score tile
//     in shared memory; both are formed before either product is issued,
//     which keeps the d = 128 builds inside their 240 registers. dK and dV
//     are summed over the group in float32 and rounded once.
//   * Between the products the time goes to forming P and dS (measured: the
//     kernels ran at 35-48% of the tensor-core rate until this was cut), so
//     P is one FMA and ex2 with scale and LSE pre-multiplied by log2(e)
//     (with a mask: the score is formed first, as the plain version forms
//     it), and only the tiles on the causal diagonal or the ragged edge
//     check positions.
//   * Q is not pre-scaled (1/sqrt(128) is not a power of two, so a bf16
//     Q * scale would round): S is scaled in float32, and dQ and dK at the
//     end. P and dS are rounded to bf16 before the second products, as
//     FlashAttention-2/3 do; the sums stay float32.
//   * The epilogue writes the rounded tile into the warpgroup's own Q (dQ)
//     or K and V (dK/dV) buffers, whose last reader was its own product, and
//     TMA stores it: rows past s fall outside the tensor and are not
//     written.
//   * The mask window ([128 q x 64 k] for dQ, [64 q x 128 k] for dK/dV)
//     arrives by TMA with its tile, with row pitches of 72 elements (dQ)
//     and 132 (float32) or 136 (bf16) elements (dK/dV): the boxes read a
//     few spare columns so that neither kernel's reads, dK/dV's transposed
//     ones included, meet bank conflicts. A mask whose rows are not a
//     multiple of 16 bytes (s * its element size) cannot be mapped; it takes
//     a separate build (template argument kWindow false) that reads the
//     mask from global memory, so the window build carries none of that
//     code (with it, ptxas ran out of registers at d = 128 and serialised
//     the products).
//
// float32 inputs take flash_bwd_dq_kernel and flash_bwd_dkv_kernel, which
// multiply with plain float32 FMAs (TF32 tensor cores would hold about 1e-3
// relative, outside the float32 tolerance of 1e-4):
//   * dQ: one block of 256 threads per (64-row Q tile, batch * q-head), the
//     TPU kernel's sequential K/V grid dimension a loop inside the block, as
//     in the forward. Q (pre-scaled) and dO stay in shared memory; V and
//     then K take turns in one buffer, so dP = dO V^T is formed before K
//     arrives and dS = P (dP - delta) is staged once for dS K. 116 KB of
//     shared memory at d = 128. Causal blocks stop at the diagonal tile and
//     the heaviest Q tiles are scheduled first.
//   * dK/dV: one block per (64-row K tile, batch * kv-head). K and V stay in
//     shared memory; the block walks every Q head of its GQA group and,
//     when causal, only the Q tiles at or past the diagonal. The scores are
//     formed transposed (K rows by Q columns), so P^T and dS^T are staged
//     for the two products without a transpose. dK and dV are summed over
//     the group in float32 registers and rounded once (the JAX package
//     writes per-Q-head results in k's type and sums them outside). 167 KB
//     of shared memory at d = 128: one block per SM.
//   * The additive mask (float32) is read per score straight from global
//     memory (L2) into registers.
//
// Both routes:
//   * Masks come from absolute positions (col <= row; both < s for the
//     ragged tail), so s is never padded. A dropped score's probability is
//     forced to 0 rather than computed: TMA's zero fill makes an
//     out-of-range row's score 0, not -inf, and a fully masked tile cannot
//     produce NaN.
//   * The mask type is a template argument (float32, or the inputs' type):
//     the unmasked builds carry none of it.
//   * No atomics: every output element is written by one block after a
//     fixed-order sum, so two launches give identical bits.
#include "flash_common.cuh"

namespace {

// -- float32: FMA kernels ----------------------------------------------------

template <int D>
struct BwdSmem {
  static constexpr int kLd = D + 4;  // 16-byte aligned rows
  static constexpr int kTile = kBlockN * kLd;
  static constexpr int kScore = kBlockM * kLdS;
  // dQ: Q, dO, K-or-V, dS
  static constexpr int kDqBytes =
      (3 * kTile + kScore) * static_cast<int>(sizeof(float));
  // dK/dV: K, V, Q, dO, P^T, dS^T, LSE and delta of the Q tile
  static constexpr int kDkvBytes =
      (4 * kTile + 2 * kScore + 2 * kBlockM) *
      static_cast<int>(sizeof(float));
};

template <typename T, int D, int kMask, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const void* __restrict__ mask, T* __restrict__ dq, int s,
                    int hq, int hkv, int mask_heads, bool causal,
                    float scale, Dropout drop) {
  using L = BwdSmem<D>;
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + L::kTile;
  float* sKV = sdO + L::kTile;
  float* sdS = sKV + L::kTile;

  const int bh = blockIdx.x;                   // batch * hq + head
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBlockM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const size_t q_stride = static_cast<size_t>(hq) * D;
  const size_t kv_stride = static_cast<size_t>(hkv) * D;
  const size_t q_off = (static_cast<size_t>(b) * s + q0) * q_stride +
                       static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * s * kv_stride +
                        static_cast<size_t>(hk) * D;

  load_tile<T, D>(sQ, L::kLd, q + q_off, q_stride, s - q0, scale);
  load_tile<T, D>(sdO, L::kLd, dout + q_off, q_stride, s - q0, 1.f);

  float row_lse[4], row_delta[4];
  uint32_t drop_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const size_t at = static_cast<size_t>(bh) * s + row;
    row_lse[i] = row < s ? lse[at] : 0.f;
    row_delta[i] = row < s ? delta[at] : 0.f;
    drop_row[i] = kDrop ? static_cast<uint32_t>(row) * kDropRowMul ^
                              drop.base(bh)
                        : 0u;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int n_tiles_all = (s + kBlockN - 1) / kBlockN;
  const int n_tiles = causal ? min(qt + 1, n_tiles_all) : n_tiles_all;
  const void* plane = nullptr;
  if constexpr (kMask != kNoMask)
    plane = mask_plane<kMask>(mask, b, h, mask_heads, s);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();  // the previous tile's dS K reads are done
    load_tile<T, D>(sKV, L::kLd, v + kv_off + k0 * kv_stride, kv_stride,
                    s - k0, 1.f);
    __syncthreads();
    float dp[4][4];
    tile_dot<D>(sdO, sKV, L::kLd, dp);
    __syncthreads();  // everyone is done reading V
    load_tile<T, D>(sKV, L::kLd, k + kv_off + k0 * kv_stride, kv_stride,
                    s - k0, 1.f);
    __syncthreads();
    float sc[4][4];
    tile_dot<D>(sQ, sKV, L::kLd, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = row < s && col < s && (!causal || col <= row);
        if constexpr (kMask != kNoMask) {
          if (row < s && col < s)
            sc[i][j] += mask_at<kMask>(plane, s, row, col);
        }
        const float p = keep ? expf(sc[i][j] - row_lse[i]) : 0.f;
        float dpv = dp[i][j];
        if constexpr (kDrop)
          dpv = keep_bits(drop_row[i],
                          static_cast<uint32_t>(col) * kDropColMul,
                          drop.threshold)
                    ? dpv * drop.scale
                    : 0.f;
        sdS[(ty * 4 + i) * kLdS + tx + 16 * j] = p * (dpv - row_delta[i]);
      }
    }
    __syncthreads();
    tile_accumulate<D>(sdS, sKV, L::kLd, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    T* out = dq + (static_cast<size_t>(b) * s + row) * q_stride +
             static_cast<size_t>(h) * D;
#pragma unroll
    for (int cc = 0; cc < D / 64; ++cc) {
      store4<T>(out + 64 * cc + 4 * tx, acc[i][cc * 4 + 0] * scale,
                acc[i][cc * 4 + 1] * scale, acc[i][cc * 4 + 2] * scale,
                acc[i][cc * 4 + 3] * scale);
    }
  }
}

template <typename T, int D, int kMask, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const void* __restrict__ mask, T* __restrict__ dk,
                     T* __restrict__ dv, int s, int hq, int hkv,
                     int mask_heads, bool causal, float scale,
                     Dropout drop) {
  using L = BwdSmem<D>;
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + L::kTile;
  float* sQ = sV + L::kTile;
  float* sdO = sQ + L::kTile;
  float* sP = sdO + L::kTile;
  float* sdS = sP + L::kScore;
  float* sLse = sdS + L::kScore;
  float* sDelta = sLse + kBlockM;

  const int bhk = blockIdx.x;                  // batch * hkv + kv-head
  const int kt = blockIdx.y;                   // causal: heaviest first
  const int b = bhk / hkv, hk = bhk % hkv;
  const int group = hq / hkv;
  const int k0 = kt * kBlockN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const size_t q_stride = static_cast<size_t>(hq) * D;
  const size_t kv_stride = static_cast<size_t>(hkv) * D;
  const size_t kv_off = (static_cast<size_t>(b) * s + k0) * kv_stride +
                        static_cast<size_t>(hk) * D;

  load_tile<T, D>(sK, L::kLd, k + kv_off, kv_stride, s - k0, 1.f);
  load_tile<T, D>(sV, L::kLd, v + kv_off, kv_stride, s - k0, 1.f);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc_k[i][c] = 0.f;
      acc_v[i][c] = 0.f;
    }

  const int nq = (s + kBlockM - 1) / kBlockM;
  const int qt_first = causal ? k0 / kBlockM : 0;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const size_t bh = static_cast<size_t>(b) * hq + h;
    const void* plane = nullptr;
    if constexpr (kMask != kNoMask)
      plane = mask_plane<kMask>(mask, b, h, mask_heads, s);
    const uint32_t drop_base = kDrop ? drop.base(static_cast<int>(bh)) : 0u;
    for (int qt = qt_first; qt < nq; ++qt) {
      const int q0 = qt * kBlockM;
      const size_t q_off = (static_cast<size_t>(b) * s + q0) * q_stride +
                           static_cast<size_t>(h) * D;
      __syncthreads();  // the previous tile's reads are done
      load_tile<T, D>(sQ, L::kLd, q + q_off, q_stride, s - q0, scale);
      load_tile<T, D>(sdO, L::kLd, dout + q_off, q_stride, s - q0, 1.f);
      if (threadIdx.x < kBlockM) {
        const int row = q0 + threadIdx.x;
        sLse[threadIdx.x] = row < s ? lse[bh * s + row] : 0.f;
        sDelta[threadIdx.x] = row < s ? delta[bh * s + row] : 0.f;
      }
      __syncthreads();
      float st[4][4], dpt[4][4];  // S^T and dP^T: K rows by Q columns
      tile_dot<D>(sK, sQ, L::kLd, st);
      tile_dot<D>(sV, sdO, L::kLd, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int krow = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const int qrow = q0 + qc;
          const bool keep =
              krow < s && qrow < s && (!causal || krow <= qrow);
          if constexpr (kMask != kNoMask) {
            if (krow < s && qrow < s)
              st[i][j] += mask_at<kMask>(plane, s, qrow, krow);
          }
          const float p = keep ? expf(st[i][j] - sLse[qc]) : 0.f;
          float pv = p, dpv = dpt[i][j];
          // the mask's row is the query position, its column the key's
          if constexpr (kDrop) {
            const bool kept = keep_bits(
                static_cast<uint32_t>(qrow) * kDropRowMul ^ drop_base,
                static_cast<uint32_t>(krow) * kDropColMul, drop.threshold);
            pv = kept ? p * drop.scale : 0.f;
            dpv = kept ? dpv * drop.scale : 0.f;
          }
          sP[(ty * 4 + i) * kLdS + qc] = pv;
          sdS[(ty * 4 + i) * kLdS + qc] = p * (dpv - sDelta[qc]);
        }
      }
      __syncthreads();
      tile_accumulate<D>(sP, sdO, L::kLd, acc_v);
      tile_accumulate<D>(sdS, sQ, L::kLd, acc_k);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int krow = k0 + ty * 4 + i;
    if (krow >= s) continue;
    const size_t at = (static_cast<size_t>(b) * s + krow) * kv_stride +
                      static_cast<size_t>(hk) * D;
#pragma unroll
    for (int cc = 0; cc < D / 64; ++cc) {
      const int c = 64 * cc + 4 * tx;
      store4<T>(dk + at + c, acc_k[i][cc * 4 + 0], acc_k[i][cc * 4 + 1],
                acc_k[i][cc * 4 + 2], acc_k[i][cc * 4 + 3]);
      store4<T>(dv + at + c, acc_v[i][cc * 4 + 0], acc_v[i][cc * 4 + 1],
                acc_v[i][cc * 4 + 2], acc_v[i][cc * 4 + 3]);
    }
  }
}

// -- bfloat16: wgmma kernels -------------------------------------------------

namespace wg {

// dK/dV's mask window: 64 q rows x 132 float32 or 136 bf16 elements (128 k
// columns + 4 or 8 spare), read transposed; the pitch keeps each warp's
// reads on distinct banks.
template <int kMask>
constexpr int kDkvMaskPitch = kMask == kMaskF32 ? 132 : 136;

// Shared memory (byte offsets from a 1024-byte aligned base). A "tile" is
// 64 rows by D bf16: D / 64 boxes of kChunkBytes.
template <int D, int kMask, bool kWindow>
struct DqLayout {
  static constexpr int kTile = D / 64 * kChunkBytes;
  static constexpr int kMaskBox =
      kWindow ? 2 * kRows * kMaskPitch * kMaskElemBytes<kMask> : 0;
  static constexpr int kQ = 0;                 // [2 warpgroups][tile]
  static constexpr int kDo = 2 * kTile;        // [2][tile]
  static constexpr int kStage0 = 4 * kTile;    // K, V, mask window
  static constexpr int kStageBytes = 2 * kTile + round1k(kMaskBox);
  static constexpr int kStages = ring_stages(kStage0, kStageBytes);
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
};

template <int D, int kMask, bool kWindow>
struct DkvLayout {
  static constexpr int kTile = D / 64 * kChunkBytes;
  static constexpr int kMaskBox =
      kWindow ? kRows * kDkvMaskPitch<kMask> * kMaskElemBytes<kMask> : 0;
  static constexpr int kK = 0;                 // [2 warpgroups][tile]
  static constexpr int kV = 2 * kTile;         // [2][tile]
  static constexpr int kStage0 = 4 * kTile;    // Q, dO, LSE, delta, mask
  static constexpr int kLse = 2 * kTile;       // within a stage
  static constexpr int kMaskOff = kLse + 2 * kRows * 4;
  static constexpr int kStageBytes = round1k(kMaskOff + kMaskBox);
  static constexpr int kStages = ring_stages(kStage0, kStageBytes);
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
};

template <int kMask>
__device__ __forceinline__ float window_at(const uint8_t* win, int pitch,
                                           int r, int c) {
  if constexpr (kMask == kMaskF32) {
    return reinterpret_cast<const float*>(win)[r * pitch + c];
  } else {
    return __bfloat162float(reinterpret_cast<const bf16*>(win)[r * pitch + c]);
  }
}

// P = exp(S scale + mask - LSE) from a raw score. `lse2` is LSE log2(e) and
// `scale2` scale log2(e): unmasked, one FMA and ex2. With a mask the score
// is formed first, as the plain version forms it, so that a mask of -1e9
// absorbs the score in the same rounding.
template <int kMask>
__device__ __forceinline__ float prob(float s, float mask, float scale,
                                      float scale2, float lse, float lse2) {
  if constexpr (kMask == kNoMask) return ex2(fmaf(s, scale2, -lse2));
  return ex2((fmaf(s, scale, mask) - lse) * kLog2e);
}

// The address of element `at` of a mask plane, and the element `idx` past
// such an address, as float32.
template <int kMask>
__device__ __forceinline__ const void* mask_elem(const void* plane,
                                                 size_t at) {
  return static_cast<const char*>(plane) + at * kMaskElemBytes<kMask>;
}
template <int kMask>
__device__ __forceinline__ float mask_load(const void* p, int idx) {
  if constexpr (kMask == kMaskF32)
    return __ldg(static_cast<const float*>(p) + idx);
  else
    return __bfloat162float(static_cast<const bf16*>(p)[idx]);
}

}  // namespace wg

template <int D, int kMask, bool kWindow, bool kDrop>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_mask,
                   const __grid_constant__ CUtensorMap tm_dq,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const void* __restrict__ mask, int s, int hq, int hkv,
                   int mask_heads, int causal, float scale, Dropout drop) {
  using namespace wg;
  using L = DqLayout<D, kMask, kWindow>;
  constexpr int kChunks = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* qbar = empty + L::kStages;

  const int bh = blockIdx.x;                   // batch * hq + head
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * 2 * kRows;
  const int nk = (s + kRows - 1) / kRows;
  const int n_tiles =
      causal ? min(nk, (min(q0 + 2 * kRows, s) - 1) / kRows + 1) : nk;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], kConsumerWarps);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    hopper::mbar_arrive_expect_tx(qbar, 4 * L::kTile);
    for (int half = 0; half < 2; ++half)
      for (int c = 0; c < kChunks; ++c) {
        const int off = half * L::kTile + c * kChunkBytes;
        hopper::tma_load_4d(smem + L::kQ + off, &tm_q, qbar, 64 * c, h,
                            q0 + kRows * half, b);
        hopper::tma_load_4d(smem + L::kDo + off, &tm_do, qbar, 64 * c, h,
                            q0 + kRows * half, b);
      }
    const int plane = b * mask_heads + (mask_heads == 1 ? 0 : h);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % L::kStages;
      uint8_t* stage = smem + L::kStage0 + st * L::kStageBytes;
      hopper::mbar_wait(&empty[st], ((t / L::kStages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(
          &full[st], 2 * L::kTile + L::kMaskBox);
      for (int c = 0; c < kChunks; ++c) {
        hopper::tma_load_4d(stage + c * kChunkBytes, &tm_k, &full[st],
                            64 * c, hk, kRows * t, b);
        hopper::tma_load_4d(stage + L::kTile + c * kChunkBytes, &tm_v,
                            &full[st], 64 * c, hk, kRows * t, b);
      }
      if constexpr (kWindow)
        hopper::tma_load_3d(stage + 2 * L::kTile, &tm_mask, &full[st],
                            kRows * t, q0, plane);
    }
    return;
  }

  // consumers: warpgroup cw owns Q rows q0 + 64 cw ..
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int ct = threadIdx.x - 128;
  const int cw = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
  const int g = lane / 4, tq = lane % 4;
  const int row_l = kRows * cw + 16 * warp + g;  // and row_l + 8
  const float scale2 = scale * kLog2e;
  float row_lse[2], row_lse2[2], row_delta[2];
  uint32_t drop_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_l + 8 * i;
    const size_t at = static_cast<size_t>(bh) * s + row;
    row_lse[i] = row < s ? lse[at] : 0.f;
    row_lse2[i] = row_lse[i] * kLog2e;
    row_delta[i] = row < s ? delta[at] : 0.f;
    drop_row[i] = kDrop ? static_cast<uint32_t>(row) * kDropRowMul ^
                              drop.base(bh)
                        : 0u;
  }
  const void* plane = nullptr;
  if constexpr (kMask != kNoMask && !kWindow)
    plane = mask_plane<kMask>(mask, b, h, mask_heads, s);
  uint8_t* sQ = smem + L::kQ + cw * L::kTile;
  const uint8_t* sDo = smem + L::kDo + cw * L::kTile;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  hopper::mbar_wait(qbar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % L::kStages;
    const uint8_t* sK = smem + L::kStage0 + st * L::kStageBytes;
    const uint8_t* sV = sK + L::kTile;
    const uint8_t* win = sK + 2 * L::kTile;
    const int k0 = kRows * t;
    hopper::mbar_wait(&full[st], (t / L::kStages) & 1);
    // a causal block's last tile lies past the first warpgroup's rows
    if (!causal || k0 <= q0 + kRows * cw + kRows - 1) {
      float sc[32], dp[32];
      uint32_t a[4][4];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<64, 0, 0>(sc, k_major(sQ, kk), k_major(sK, kk), kk);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<64, 0, 0>(dp, k_major(sDo, kk), k_major(sV, kk),
                                   kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      // P in place; only a tile on the diagonal or the ragged edge checks
      // positions
      const int first_row = q0 + kRows * cw;
      const bool interior = first_row + kRows <= s && k0 + kRows <= s &&
                            (!causal || k0 + kRows - 1 <= first_row);
      auto probs = [&](auto checks) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = q0 + row_l + 8 * i, c = 8 * j + 2 * tq;
            float2 m = make_float2(0.f, 0.f);
            if constexpr (kWindow) {
              m = window_pair<kMask>(win, kMaskPitch, row_l + 8 * i, c);
            } else if constexpr (kMask != kNoMask) {
              m = global_pair<kMask>(plane, s, row, k0 + c);
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sc[4 * j + 2 * i + e];
              const float p = prob<kMask>(x, e ? m.y : m.x, scale, scale2,
                                          row_lse[i], row_lse2[i]);
              if constexpr (decltype(checks)::value) {
                const int col = k0 + c + e;
                x = row < s && col < s && (!causal || col <= row) ? p : 0.f;
              } else {
                x = p;
              }
            }
          }
      };
      // (the build that reads the mask from memory checks for its loads)
      if (interior && (kWindow || kMask == kNoMask))
        probs(std::false_type{});
      else
        probs(std::true_type{});
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      const uint32_t drop_col =
          static_cast<uint32_t>(k0 + 2 * tq) * kDropColMul;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * j + 2 * i + e;
            float dpv = dp[r];
            if constexpr (kDrop)
              dpv = keep_bits(drop_row[i],
                              drop_col + static_cast<uint32_t>(8 * j + e) *
                                             kDropColMul,
                              drop.threshold)
                        ? dpv * drop.scale
                        : 0.f;
            dp[r] = sc[r] * (dpv - row_delta[i]);
          }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::to_a_frag(dp, kk, a[kk]);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs<D, 1>(acc, a[kk], mn_major(sK, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(a[kk]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // dQ * scale, rounded once, into this warpgroup's Q tile (its last reader
  // was its own S product), then out by TMA
  acc_to_tile<D>(acc, scale, sQ, warp, lane);
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + cw, 128);
  if (ct % 128 == 0) {
    for (int c = 0; c < kChunks; ++c)
      hopper::tma_store_4d(&tm_dq, sQ + c * kChunkBytes, 64 * c, h,
                           q0 + kRows * cw, b);
    hopper::tma_store_commit_and_wait();
  }
}

template <int D, int kMask, bool kWindow, bool kDrop>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_mask,
                    const __grid_constant__ CUtensorMap tm_dk,
                    const __grid_constant__ CUtensorMap tm_dv,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const void* __restrict__ mask, int s, int hq, int hkv,
                    int mask_heads, int causal, float scale, Dropout drop) {
  using namespace wg;
  using L = DkvLayout<D, kMask, kWindow>;
  constexpr int kChunks = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* kvbar = empty + L::kStages;

  const int bhk = blockIdx.x;                  // batch * hkv + kv-head
  const int kt = blockIdx.y;                   // causal: heaviest first
  const int b = bhk / hkv, hk = bhk % hkv;
  const int group = hq / hkv;
  const int k0 = kt * 2 * kRows;
  const int nq = (s + kRows - 1) / kRows;
  const int qt_first = causal ? k0 / kRows : 0;
  const int per_head = nq - qt_first;
  const int n_iter = group * per_head;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      // the TMA issue's arrival and each producer lane's cp.async arrival
      hopper::mbar_init(&full[i], 33);
      hopper::mbar_init(&empty[i], kConsumerWarps);
    }
    hopper::mbar_init(kvbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer: its first warp
    hopper::setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane >= 32) return;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kvbar, 4 * L::kTile);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < kChunks; ++c) {
          const int off = half * L::kTile + c * kChunkBytes;
          hopper::tma_load_4d(smem + L::kK + off, &tm_k, kvbar, 64 * c, hk,
                              k0 + kRows * half, b);
          hopper::tma_load_4d(smem + L::kV + off, &tm_v, kvbar, 64 * c, hk,
                              k0 + kRows * half, b);
        }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int h = hk * group + it / per_head;
      const int q0 = kRows * (qt_first + it % per_head);
      const int st = it % L::kStages;
      uint8_t* stage = smem + L::kStage0 + st * L::kStageBytes;
      hopper::mbar_wait(&empty[st], ((it / L::kStages) & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(
            &full[st], 2 * L::kTile + L::kMaskBox);
        for (int c = 0; c < kChunks; ++c) {
          hopper::tma_load_4d(stage + c * kChunkBytes, &tm_q, &full[st],
                              64 * c, h, q0, b);
          hopper::tma_load_4d(stage + L::kTile + c * kChunkBytes, &tm_do,
                              &full[st], 64 * c, h, q0, b);
        }
        if constexpr (kWindow)
          hopper::tma_load_3d(stage + L::kMaskOff, &tm_mask, &full[st], k0,
                              q0, b * mask_heads + (mask_heads == 1 ? 0 : h));
      }
      float* s_lse = reinterpret_cast<float*>(stage + L::kLse);
      const size_t at = (static_cast<size_t>(b) * hq + h) * s;
      for (int r = lane; r < kRows; r += 32) {  // zeros past s
        const int row = min(q0 + r, s - 1);
        hopper::cp_async_4(s_lse + r, lse + at + row, q0 + r < s);
        hopper::cp_async_4(s_lse + kRows + r, delta + at + row, q0 + r < s);
      }
      hopper::cp_async_mbar_arrive(&full[st]);
    }
    return;
  }

  // consumers: warpgroup cw owns K rows k0 + 64 cw ..
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int ct = threadIdx.x - 128;
  const int cw = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
  const int g = lane / 4, tq = lane % 4;
  const int kr_l = kRows * cw + 16 * warp + g;  // and kr_l + 8
  const float scale2 = scale * kLog2e;
  uint8_t* sK = smem + L::kK + cw * L::kTile;
  uint8_t* sV = smem + L::kV + cw * L::kTile;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  hopper::mbar_wait(kvbar, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int h = hk * group + it / per_head;
    const int q0 = kRows * (qt_first + it % per_head);
    const int st = it % L::kStages;
    const uint8_t* sQ = smem + L::kStage0 + st * L::kStageBytes;
    const uint8_t* sDo = sQ + L::kTile;
    const float* s_lse = reinterpret_cast<const float*>(sQ + L::kLse);
    const uint8_t* win = sQ + L::kMaskOff;
    // the build without windows: element (q0, k0 + kr_l) of the mask plane,
    // whose other elements are 32-bit offsets away
    const void* mk = nullptr;
    if constexpr (kMask != kNoMask && !kWindow)
      mk = mask_elem<kMask>(mask_plane<kMask>(mask, b, h, mask_heads, s),
                            static_cast<size_t>(q0) * s + k0 + kr_l);
    hopper::mbar_wait(&full[st], (it / L::kStages) & 1);
    // on a causal block's first Q tile the second warpgroup's rows all lie
    // past the tile's
    if (!causal || k0 + kRows * cw <= q0 + kRows - 1) {
      float sc[32], dp[32];  // S^T and dP^T: K rows by Q columns
      uint32_t pa[4][4], da[4][4];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<64, 0, 0>(sc, k_major(sK, kk), k_major(sQ, kk), kk);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<64, 0, 0>(dp, k_major(sV, kk), k_major(sDo, kk),
                                   kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      // P^T in place; only a tile on the diagonal or the ragged edge checks
      // positions
      const int first_kr = k0 + kRows * cw;
      const bool interior = first_kr + kRows <= s && q0 + kRows <= s &&
                            (!causal || first_kr + kRows - 1 <= q0);
      auto probs = [&](auto checks) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * tq;  // Q column (local)
          const float2 l = *reinterpret_cast<const float2*>(s_lse + c);
          const float2 l2 = make_float2(l.x * kLog2e, l.y * kLog2e);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int kr = k0 + kr_l + 8 * i;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int qr = q0 + c + e;
              float m = 0.f;
              if constexpr (kWindow) {
                m = window_at<kMask>(win, kDkvMaskPitch<kMask>, c + e,
                                     kr_l + 8 * i);
              } else if constexpr (kMask != kNoMask) {
                if (kr < s && qr < s)
                  m = mask_load<kMask>(mk, (c + e) * s + 8 * i);
              }
              float& x = sc[4 * j + 2 * i + e];
              const float p = prob<kMask>(x, m, scale, scale2,
                                          e ? l.y : l.x, e ? l2.y : l2.x);
              if constexpr (decltype(checks)::value)
                x = kr < s && qr < s && (!causal || kr <= qr) ? p : 0.f;
              else
                x = p;
            }
          }
        }
      };
      // (the build that reads the mask from memory checks for its loads)
      if (interior && (kWindow || kMask == kNoMask))
        probs(std::false_type{});
      else
        probs(std::true_type{});
      hopper::wgmma_wait<0>();  // dP^T
      hopper::fence_regs(dp);
      // dropout: the mask's row is the Q column (query position), its column
      // the K row (key position); P^T turns into the dropped, scaled P^T of
      // dV once dS^T has taken the undropped one
      uint32_t drop_q = 0u, drop_k[2] = {0u, 0u};
      if constexpr (kDrop) {
        const uint32_t base = drop.base(b * hq + h);
        drop_q = static_cast<uint32_t>(q0 + 2 * tq) * kDropRowMul;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          drop_k[i] =
              static_cast<uint32_t>(k0 + kr_l + 8 * i) * kDropColMul ^ base;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(s_lse + kRows + 8 * j + 2 * tq);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * j + 2 * i + e;
            float dpv = dp[r];
            if constexpr (kDrop) {
              const bool kept = keep_bits(
                  drop_q + static_cast<uint32_t>(8 * j + e) * kDropRowMul,
                  drop_k[i], drop.threshold);
              dpv = kept ? dpv * drop.scale : 0.f;
              dp[r] = sc[r] * (dpv - (e ? d2.y : d2.x));
              sc[r] = kept ? sc[r] * drop.scale : 0.f;
            } else {
              dp[r] = sc[r] * (dpv - (e ? d2.y : d2.x));
            }
          }
      }
      // P^T and dS^T are formed before either product is issued, so their
      // bf16 fragments are never live beside both float32 tiles
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::to_a_frag(sc, kk, pa[kk]);
        hopper::to_a_frag(dp, kk, da[kk]);
      }
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs<D, 1>(dv, pa[kk], mn_major(sDo, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs<D, 1>(dk, da[kk], mn_major(sQ, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::fence_regs(pa[kk]);
        hopper::fence_regs(da[kk]);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // dK * scale and dV, rounded once, into this warpgroup's K and V tiles
  // (their last reader was its own S^T and dP^T products), then out by TMA
  acc_to_tile<D>(dk, scale, sK, warp, lane);
  acc_to_tile<D>(dv, 1.f, sV, warp, lane);
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + cw, 128);
  if (ct % 128 == 0) {
    for (int c = 0; c < kChunks; ++c) {
      hopper::tma_store_4d(&tm_dk, sK + c * kChunkBytes, 64 * c, hk,
                           k0 + kRows * cw, b);
      hopper::tma_store_4d(&tm_dv, sV + c * kChunkBytes, 64 * c, hk,
                           k0 + kRows * cw, b);
    }
    hopper::tma_store_commit_and_wait();
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const void* mask;
  int batch, s, hq, hkv, mask_heads;
  bool causal;
  float scale;
  Dropout drop;
};

template <int D, int kMask, bool kDrop>
int launch_dq_fma(const Args& a, void* dq, cudaStream_t stream) {
  const int bytes = BwdSmem<D>::kDqBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<float, D, kMask, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.batch * a.hq, (a.s + kBlockM - 1) / kBlockM);
  flash_bwd_dq_kernel<float, D, kMask, kDrop>
      <<<grid, kThreads, bytes, stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          a.lse, a.delta, a.mask, static_cast<float*>(dq), a.s, a.hq, a.hkv,
          a.mask_heads, a.causal, a.scale, a.drop);
  RETURN_LAUNCH_ERROR();
}

template <int D, int kMask, bool kDrop>
int launch_dkv_fma(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  const int bytes = BwdSmem<D>::kDkvBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<float, D, kMask, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.batch * a.hkv, (a.s + kBlockN - 1) / kBlockN);
  flash_bwd_dkv_kernel<float, D, kMask, kDrop>
      <<<grid, kThreads, bytes, stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          a.lse, a.delta, a.mask, static_cast<float*>(dk),
          static_cast<float*>(dv), a.s, a.hq, a.hkv, a.mask_heads, a.causal,
          a.scale, a.drop);
  RETURN_LAUNCH_ERROR();
}

// The build that takes the mask as TMA windows when its rows can be
// mapped, else the one that reads it from global memory.
template <int D, int kMask, bool kDrop>
int launch_dq_wgmma(const Args& a, void* dq, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tmask = {}, tdq;
  if (!rows_map(&tq, a.q, a.batch, a.s, a.hq, D) ||
      !rows_map(&tk, a.k, a.batch, a.s, a.hkv, D) ||
      !rows_map(&tv, a.v, a.batch, a.s, a.hkv, D) ||
      !rows_map(&tdo, a.dout, a.batch, a.s, a.hq, D) ||
      !rows_map(&tdq, dq, a.batch, a.s, a.hq, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.batch * a.hq,
                  (a.s + 2 * wg::kRows - 1) / (2 * wg::kRows));
  if constexpr (kMask != kNoMask) {
    const int window =
        mask_map<kMask>(&tmask, a.mask, a.batch, a.mask_heads, a.s,
                        wg::kMaskPitch, 2 * wg::kRows);
    if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (window)
      return launch_wgmma(flash_bwd_dq_wgmma<D, kMask, true, kDrop>,
                          wg::DqLayout<D, kMask, true>::kBytes, grid,
                          wg::kThreads, stream, tq, tk, tv, tdo, tmask, tdq,
                          a.lse, a.delta, a.mask, a.s, a.hq, a.hkv,
                          a.mask_heads, static_cast<int>(a.causal), a.scale,
                          a.drop);
  }
  return launch_wgmma(flash_bwd_dq_wgmma<D, kMask, false, kDrop>,
                      wg::DqLayout<D, kMask, false>::kBytes, grid,
                      wg::kThreads, stream, tq, tk, tv, tdo, tmask, tdq,
                      a.lse, a.delta, a.mask, a.s, a.hq, a.hkv, a.mask_heads,
                      static_cast<int>(a.causal), a.scale, a.drop);
}

template <int D, int kMask, bool kDrop>
int launch_dkv_wgmma(const Args& a, void* dk, void* dv,
                     cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tmask = {}, tdk, tdv;
  if (!rows_map(&tq, a.q, a.batch, a.s, a.hq, D) ||
      !rows_map(&tk, a.k, a.batch, a.s, a.hkv, D) ||
      !rows_map(&tv, a.v, a.batch, a.s, a.hkv, D) ||
      !rows_map(&tdo, a.dout, a.batch, a.s, a.hq, D) ||
      !rows_map(&tdk, dk, a.batch, a.s, a.hkv, D) ||
      !rows_map(&tdv, dv, a.batch, a.s, a.hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.batch * a.hkv,
                  (a.s + 2 * wg::kRows - 1) / (2 * wg::kRows));
  if constexpr (kMask != kNoMask) {
    const int window =
        mask_map<kMask>(&tmask, a.mask, a.batch, a.mask_heads, a.s,
                        wg::kDkvMaskPitch<kMask>, wg::kRows);
    if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (window)
      return launch_wgmma(flash_bwd_dkv_wgmma<D, kMask, true, kDrop>,
                          wg::DkvLayout<D, kMask, true>::kBytes, grid,
                          wg::kThreads, stream, tq, tk, tv, tdo, tmask, tdk,
                          tdv, a.lse, a.delta, a.mask, a.s, a.hq, a.hkv,
                          a.mask_heads, static_cast<int>(a.causal), a.scale,
                          a.drop);
  }
  return launch_wgmma(flash_bwd_dkv_wgmma<D, kMask, false, kDrop>,
                      wg::DkvLayout<D, kMask, false>::kBytes, grid,
                      wg::kThreads, stream, tq, tk, tv, tdo, tmask, tdk, tdv,
                      a.lse, a.delta, a.mask, a.s, a.hq, a.hkv, a.mask_heads,
                      static_cast<int>(a.causal), a.scale, a.drop);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* mask,
               int batch, int s, int hq, int hkv, int mask_heads, int causal,
               float scale, unsigned drop_threshold, float drop_scale,
               unsigned drop_seed) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), mask, batch, s, hq, hkv,
              mask_heads, causal != 0, scale,
              Dropout{drop_threshold, drop_scale, drop_seed}};
}

}  // namespace

DEFINE_ERROR_STRING()

// q, dout, dq: [batch, s, hq, d]; k, v, dk, dv: [batch, s, hkv, d], all
// contiguous of `dtype` with 16-byte aligned bases; lse, delta: [batch, hq,
// s] float32; mask: null (mask_code kNoMask) or the forward's contiguous
// additive [batch, mask_heads, s, s] of float32 or `dtype` (mask_code).
// With `dropout` the dropout build runs with the forward's keep-mask
// threshold, scale and seed (Dropout). bfloat16 takes the wgmma kernels,
// float32 the FMA kernels. Each entry launches one kernel on `stream`,
// allocates nothing and does not synchronise.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* mask, void* dq, int batch,
                                      int s, int hq, int hkv, int mask_heads,
                                      int d, int causal, float scale,
                                      int dtype, int mask_code, int dropout,
                                      unsigned drop_threshold,
                                      float drop_scale, unsigned drop_seed,
                                      void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, mask, batch, s, hq,
                           hkv, mask_heads, causal, scale, drop_threshold,
                           drop_scale, drop_seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, d, mask_code, dropout != 0,
                  [&](auto t, auto dim, auto m, auto dr) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dim)::value, kMask = decltype(m)::value;
    constexpr bool kDrop = decltype(dr)::value;
    if constexpr (std::is_same_v<T, float>)
      return launch_dq_fma<D, kMask, kDrop>(a, dq, st);
    else
      return launch_dq_wgmma<D, kMask, kDrop>(a, dq, st);
  });
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* mask, void* dk, void* dv,
                                       int batch, int s, int hq, int hkv,
                                       int mask_heads, int d, int causal,
                                       float scale, int dtype, int mask_code,
                                       int dropout, unsigned drop_threshold,
                                       float drop_scale, unsigned drop_seed,
                                       void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, mask, batch, s, hq,
                           hkv, mask_heads, causal, scale, drop_threshold,
                           drop_scale, drop_seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, d, mask_code, dropout != 0,
                  [&](auto t, auto dim, auto m, auto dr) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dim)::value, kMask = decltype(m)::value;
    constexpr bool kDrop = decltype(dr)::value;
    if constexpr (std::is_same_v<T, float>)
      return launch_dkv_fma<D, kMask, kDrop>(a, dk, dv, st);
    else
      return launch_dkv_wgmma<D, kMask, kDrop>(a, dk, dv, st);
  });
}

// Dynamic shared memory (bytes) of the bf16 build of the dQ (kernel 0) or
// dK/dV (kernel 1) kernel for head dim d, a mask code, and whether the mask
// arrives as TMA windows (window 1) or is read from global memory; the
// dropout builds take the same.
extern "C" int flash_attention_bwd_wgmma_smem(int kernel, int d,
                                              int mask_code, int window,
                                              int /*dropout*/) {
  return dispatch(kBFloat16, d, mask_code, [&](auto, auto dim, auto m) {
    constexpr int D = decltype(dim)::value, kMask = decltype(m)::value;
    if (window && kMask != kNoMask)
      return kernel == 0 ? wg::DqLayout<D, kMask, true>::kBytes
                         : wg::DkvLayout<D, kMask, true>::kBytes;
    return kernel == 0 ? wg::DqLayout<D, kMask, false>::kBytes
                       : wg::DkvLayout<D, kMask, false>::kBytes;
  });
}
