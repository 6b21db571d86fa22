// Flash attention forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched
// by _fwd_call through flash_attention_pallas): blockwise attention with an
// online softmax in float32, native GQA, causal or not, an optional additive
// mask and dropout on the probabilities, writing O in the input type and the
// float32 log-sum-exp per row. The TPU kernel's kv_seqlens is not ported
// yet.
//
// Dropout (a template argument, kDrop, so the builds without it are
// unchanged): the P that multiplies V keeps the entries of the hash mask of
// flash_common.cuh (keep_bits: the TPU kernel's _keep_mask on its interpret
// path, of the absolute row and column, batch * hq + q-head and the seed),
// scaled by 1 / (1 - p); the row sum l and the LSE are the undropped P's,
// as in _fwd_kernel. The backward kernels draw the same mask from the same
// seed, so nothing is stored.
//
// Bound on this card: at the training shape (s = 2048, d = 128, causal) the
// two products do about s / 4 flops per byte of Q, K, V and O, above the
// ~295 at which the H100's bf16 tensor cores become the limit, so the least
// time is set by the tensor cores (0.139 ms); at the prefill shape (s =
// 512) it is set by bytes.
//
// bfloat16 inputs (the serving and training paths) take flash_fwd_wgmma:
// bf16 wgmma products with float32 accumulators, fed by TMA, the design of
// flash_attention_bwd.cu's dQ kernel (hopper_mma.cuh and flash_common.cuh
// hold the building blocks; the consumer loop, fwd_consume, is shared with
// block_sparse_attention.cu).
//   * Blocks of 384 threads: one producer warpgroup (its first warp issues
//     the TMA loads; setmaxnreg moves its registers to the others: 24 and
//     240 a thread) and two consumer warpgroups of 64 Q rows each, so a
//     block owns 128 rows.
//   * Grid order: a one-dimensional grid whose fastest index is the Q tile
//     (the heaviest causal tiles first), then batch * q-head. Measured
//     (tools/attn_variants.py, H100 80GB HBM3): with batch * q-head
//     fastest, the ~132 resident blocks belonged to ~128 heads whose K and
//     V (1 MB a head at s = 2048) could not stay in the 50 MB L2, so every
//     block streamed them from memory and the kernel ran at the memory's
//     rate (0.76 ms non-causal at [4, 2048, 32, 128]); with a head's tiles
//     together it takes 0.46 ms.
//   * Q arrives once, as 4-D boxes over [b, s, hq, d] of 64 bf16 columns in
//     the 128-byte swizzle. K and V stream through a ring of full/empty
//     mbarriers in tiles of 128 rows unmasked (S products of N = 128; 64
//     was ~10% slower) and 64 with a mask, whose window beside 128-row
//     tiles would not fit twice: 3 stages where shared memory holds them, 2
//     with a float32 mask window at d = 128 (FwdLayout; chip_smoke.py's
//     device phase prints each build's shared memory).
//   * S = Q K^T is an SS product, scaled in float32 (a bf16 Q / sqrt(128)
//     would round); the online softmax runs in the accumulator registers,
//     the row max and sum across the four lanes that share a row, with no
//     score tile in shared memory. P is one FMA and ex2 with scale log2(e)
//     pre-multiplied; with a mask the score is formed first and the mask
//     added, as the plain version does. P is rounded to bf16 in place as the
//     A operand of O += P V (RS, V read MN-major); l sums the unrounded P,
//     as FlashAttention-2/3 do.
//   * Schedule, as FlashAttention-3's: within a warpgroup, S(t) and
//     P(t-1) V(t-1) are issued together and the softmax of S(t) runs while
//     P V is in flight (where the ring has 3 stages); and the two
//     warpgroups take turns to issue (ping-pong on named barriers), so one's
//     softmax runs under the other's products. Each step retires its own
//     products and the branches are hoisted out of the loops, so ptxas
//     serialises no wgmma (it serialises a product in flight across a
//     branch it cannot prove uniform: C7518, C7520).
//   * Only tiles on the causal diagonal or the ragged edge check positions
//     (a loop of their own); a dropped score's P is forced to 0 (TMA's zero
//     fill gives a row past s a score of 0, not -inf), and l is clamped at
//     1e-20 as in _finalize, so a fully masked tile or row cannot produce
//     NaN.
//   * The mask arrives as a TMA window [128 q x 72] with its K/V tile, whose
//     pitch keeps the consumers' reads off shared banks. A mask whose rows
//     are not a multiple of 16 bytes (s * its element size) cannot be
//     mapped and takes a separate build (kWindow false) that reads it from
//     global memory, so the window build carries none of that code.
//   * The epilogue writes O / l, rounded to bf16, into the warpgroup's own
//     Q tile and stores it by TMA, which skips rows past s; LSE is the row
//     max in natural-log units plus log(l), for rows < s.
//
// float32 inputs take flash_fwd_kernel, which multiplies with plain float32
// FMAs (TF32 tensor cores would hold about 1e-3 relative, outside the
// float32 tolerance of 2e-5):
//   * One block of 256 threads per (64-row Q tile, batch * q-head). The
//     TPU kernel's sequential K/V grid dimension becomes a loop inside the
//     block; blocks share nothing, so no cross-block reduction is needed.
//   * The Q tile is scaled by 1/sqrt(d) in float32 once and kept in shared
//     memory; K and V tiles of 64 rows take turns in one float32 buffer,
//     which keeps shared memory at 85 KB for d = 128 so two blocks fit on
//     an SM.
//   * Each thread owns a 4 x 4 patch of the 64 x 64 score tile and a 4 x
//     d/16 patch of the output. Shared-memory reads are 16 bytes wide, so
//     the inner loops issue one load per four to ten FMAs.
//   * Causal blocks stop at the diagonal tile, and the heaviest Q tiles are
//     scheduled first. Masks come from absolute positions (col <= row;
//     col < s for the ragged tail), so s is never padded and rows past s
//     are never written. Masked scores are -1e30 and their probabilities
//     are forced to 0, so a fully masked tile cannot produce NaN.
//   * GQA is index arithmetic: q-head h reads kv-head h / (hq / hkv).
//   * The additive mask [batch, 1 | hq, s, s] (float32, a template
//     argument, so the unmasked build is unchanged) is added to the scaled
//     scores before the causal mask, as _tile_scores does. Each thread
//     reads its 4 x 4 scores' elements straight from global memory (L2)
//     into registers.
//
// Both: no atomics, so two launches give identical bits.
#include "flash_common.cuh"

namespace {

template <int D>
struct Smem {
  static constexpr int kLdQ = D + 4;        // +4 floats: 16-byte aligned
  static constexpr int kLdKV = D + 4;       // rows, conflict-free float4 reads
  static constexpr int kLdP = kBlockN + 4;
  static constexpr int kFloats =
      kBlockM * kLdQ + kBlockN * kLdKV + kBlockM * kLdP;
  static constexpr int kBytes = kFloats * static_cast<int>(sizeof(float));
};

template <typename T, int D, int kMask, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const void* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, int s, int hq,
                 int hkv, int mask_heads, bool causal, float scale,
                 Dropout drop) {
  using L = Smem<D>;
  constexpr int kCols = D / 16;      // output columns per thread
  constexpr int kChunks = kCols / 4; // float4 chunks of them
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sKV = sQ + kBlockM * L::kLdQ;
  float* sP = sKV + kBlockN * L::kLdKV;

  const int bh = blockIdx.x;                       // batch * hq + head
  const int qt = gridDim.y - 1 - blockIdx.y;       // heaviest tiles first
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBlockM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const uint32_t drop_base = kDrop ? drop.base(bh) : 0u;

  const size_t q_stride = static_cast<size_t>(hq) * D;
  const size_t kv_stride = static_cast<size_t>(hkv) * D;
  const T* q_base = q + (static_cast<size_t>(b) * s + q0) * q_stride +
                    static_cast<size_t>(h) * D;
  const T* k_base = k + static_cast<size_t>(b) * s * kv_stride +
                    static_cast<size_t>(hk) * D;
  const T* v_base = v + static_cast<size_t>(b) * s * kv_stride +
                    static_cast<size_t>(hk) * D;

  load_tile<T, D>(sQ, L::kLdQ, q_base, q_stride, s - q0, scale);

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles_all = (s + kBlockN - 1) / kBlockN;
  const int n_tiles = causal ? min(qt + 1, n_tiles_all) : n_tiles_all;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();  // previous tile's P.V reads of sKV/sP are done
    load_tile<T, D>(sKV, L::kLdKV, k_base + k0 * kv_stride, kv_stride,
                    s - k0, 1.f);
    __syncthreads();

    // scores: rows ty*4+i, columns tx+16*j of the tile
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            sQ + (ty * 4 + i) * L::kLdQ + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            sKV + (tx + 16 * j) * L::kLdKV + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    if constexpr (kMask != kNoMask) {
      const void* plane = mask_plane<kMask>(mask, b, h, mask_heads, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx + 16 * j;
          if (row < s && col < s)
            sc[i][j] += mask_at<kMask>(plane, s, row, col);
        }
      }
    }

    // online softmax over this tile's columns, per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        keep[j] = col < s && (!causal || col <= row);
        if (!keep[j]) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
      const uint32_t drop_row =
          static_cast<uint32_t>(row) * kDropRowMul ^ drop_base;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = keep[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        if constexpr (kDrop)
          p = keep_bits(drop_row,
                        static_cast<uint32_t>(k0 + tx + 16 * j) *
                            kDropColMul,
                        drop.threshold)
                  ? p * drop.scale
                  : 0.f;
        sP[(ty * 4 + i) * L::kLdP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      m[i] = m_new;
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // sP written; everyone is done reading K from sKV
    load_tile<T, D>(sKV, L::kLdKV, v_base + k0 * kv_stride, kv_stride,
                    s - k0, 1.f);
    __syncthreads();

    // acc[i][c] += sum_j P[row i][j] * V[j][col c]; the thread's columns
    // are 64 * cc + 4 * tx + (0..3)
#pragma unroll 2
    for (int j = 0; j < kBlockN; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            sP + (ty * 4 + i) * L::kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cc = 0; cc < kChunks; ++cc) {
          const float4 vv = *reinterpret_cast<const float4*>(
              sKV + (j + jj) * L::kLdKV + 64 * cc + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pv[i].x
                          : jj == 1 ? pv[i].y
                          : jj == 2 ? pv[i].z
                                    : pv[i].w;
            acc[i][cc * 4 + 0] = fmaf(p, vv.x, acc[i][cc * 4 + 0]);
            acc[i][cc * 4 + 1] = fmaf(p, vv.y, acc[i][cc * 4 + 1]);
            acc[i][cc * 4 + 2] = fmaf(p, vv.z, acc[i][cc * 4 + 2]);
            acc[i][cc * 4 + 3] = fmaf(p, vv.w, acc[i][cc * 4 + 3]);
          }
        }
      }
    }
  }

  // finalize: O = acc / l in the input type, LSE = m + log(l) in float32
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    const float lc = fmaxf(l[i], 1e-20f);
    const float inv = 1.f / lc;
    T* orow = o + (static_cast<size_t>(b) * s + row) * q_stride +
              static_cast<size_t>(h) * D;
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      store4<T>(orow + 64 * cc + 4 * tx, acc[i][cc * 4 + 0] * inv,
                acc[i][cc * 4 + 1] * inv, acc[i][cc * 4 + 2] * inv,
                acc[i][cc * 4 + 3] * inv);
    }
    if (tx == 0) lse[static_cast<size_t>(bh) * s + row] = m[i] + logf(lc);
  }
}

// K/V tile rows of the bf16 build: 128 unmasked (S products of N = 128
// read less shared memory per flop than N = 64); 64 with a mask, whose
// window beside 128-row K and V tiles would not fit twice in shared memory.
template <int kMask>
constexpr int kFwdTileRows = kMask == kNoMask ? 128 : 64;

template <int D, int kMask, bool kWindow, bool kDrop>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_mask,
                const __grid_constant__ CUtensorMap tm_o,
                float* __restrict__ lse, const void* __restrict__ mask, int s,
                int hq, int hkv, int mask_heads, int causal, float scale,
                Dropout drop) {
  using namespace wg;
  constexpr int kN = kFwdTileRows<kMask>;
  using L = FwdLayout<D, kMask, kWindow, 2, kN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* qbar = empty + L::kStages;

  // one head's Q tiles run together (the heaviest causal tiles first), so
  // that its K and V stay in L2
  const int n_qt = (s + 2 * kRows - 1) / (2 * kRows);
  const int bh = blockIdx.x / n_qt;            // batch * hq + head
  const int qt = n_qt - 1 - blockIdx.x % n_qt;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * 2 * kRows;
  const int nk = (s + kN - 1) / kN;
  const int n_tiles =
      causal ? min(nk, (min(q0 + 2 * kRows, s) - 1) / kN + 1) : nk;

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
    hopper::mbar_arrive_expect_tx(qbar, 2 * L::kTile);
    for (int half = 0; half < 2; ++half)
      load_rows<D, kRows>(smem + L::kQ + half * L::kTile, &tm_q, qbar, h,
                          q0 + kRows * half, b);
    const int plane = b * mask_heads + (mask_heads == 1 ? 0 : h);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % L::kStages;
      uint8_t* stage = smem + L::kStage0 + st * L::kStageBytes;
      hopper::mbar_wait(&empty[st], ((t / L::kStages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&full[st],
                                    2 * L::kKVTile + L::kMaskBox);
      load_rows<D, kN>(stage, &tm_k, &full[st], hk, kN * t, b);
      load_rows<D, kN>(stage + L::kKVTile, &tm_v, &full[st], hk, kN * t, b);
      if constexpr (kWindow)
        hopper::tma_load_3d(stage + 2 * L::kKVTile, &tm_mask, &full[st],
                            kN * t, q0, plane);
    }
    return;
  }

  // consumers: warpgroup cw owns Q rows row0 = q0 + 64 cw ..
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int cw = (threadIdx.x - 128) / 128;
  const int row0 = q0 + kRows * cw;
  uint8_t* sQ = smem + L::kQ + cw * L::kTile;
  const void* plane = nullptr;
  if constexpr (kMask != kNoMask && !kWindow)
    plane = mask_plane<kMask>(mask, b, h, mask_heads, s);
  // the tiles that hold a column at or before this warpgroup's last row,
  // and of those the ones with no column past s or past its first row
  const int n_active =
      row0 >= s ? 0
      : causal  ? min(n_tiles, (row0 + kRows - 1) / kN + 1)
                : n_tiles;
  const int n_interior =
      row0 + kRows > s
          ? 0
          : min(n_active, min(s / kN, causal ? (row0 + 1) / kN : n_tiles));
  auto k0_of = [](int t) { return kN * t; };
  auto mask_pair = [&](const uint8_t* stage, int r, int c, int row,
                       int col) {
    if constexpr (kWindow)
      return window_pair<kMask>(stage + 2 * L::kKVTile, L::kPitch,
                                kRows * cw + r, c);
    else
      return global_pair<kMask>(plane, s, row, col);
  };
  float acc[D / 2], m[2], l[2];
  hopper::mbar_wait(qbar, 0);
  // products overlapping the softmax where the ring has 3 stages; the two
  // warpgroups taking turns
  fwd_consume<D, kN, kMask, L::kStages >= 3, true, kDrop>(
      sQ, smem + L::kStage0, L::kStageBytes, L::kStages, L::kKVTile, full,
      empty, n_tiles, n_active, n_interior, row0, s, causal != 0, scale, cw,
      k0_of, mask_pair, acc, m, l, drop, kDrop ? drop.base(bh) : 0u);

  // LSE = the row max in natural-log units + log(l): unmasked, m is a raw
  // score's
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  if (lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 16 * warp + lane / 4 + 8 * i;
      if (row < s)
        lse[static_cast<size_t>(bh) * s + row] =
            m[i] * (kMask == kNoMask ? scale : 1.f) +
            logf(fmaxf(l[i], 1e-20f));
    }
  }
  store_o<D>(acc, l, sQ, &tm_o, cw, h, row0, b, row0 < s);
}

template <typename T, int D, int kMask, bool kDrop>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* o, void* lse, int batch, int s, int hq, int hkv,
           int mask_heads, bool causal, float scale, Dropout drop,
           cudaStream_t stream) {
  using L = Smem<D>;
  // above the 48 KB default, so opt in (a cheap host call, made per launch
  // so that it holds on whichever card is current)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kMask, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(batch * hq, (s + kBlockM - 1) / kBlockM), block(kThreads);
  flash_fwd_kernel<T, D, kMask, kDrop><<<grid, block, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o),
      static_cast<float*>(lse), s, hq, hkv, mask_heads, causal, scale, drop);
  RETURN_LAUNCH_ERROR();
}

// The build that takes the mask as TMA windows when its rows can be
// mapped, else the one that reads it from global memory.
template <int D, int kMask, bool kDrop>
int launch_wgmma_fwd(const void* q, const void* k, const void* v,
                     const void* mask, void* o, void* lse, int batch, int s,
                     int hq, int hkv, int mask_heads, bool causal,
                     float scale, Dropout drop, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tmask = {}, to;
  if (!rows_map(&tq, q, batch, s, hq, D) ||
      !rows_map(&tk, k, batch, s, hkv, D) ||
      !rows_map(&tv, v, batch, s, hkv, D) ||
      !rows_map(&to, o, batch, s, hq, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch * hq * ((s + 2 * wg::kRows - 1) / (2 * wg::kRows)));
  float* lse_f = static_cast<float*>(lse);
  constexpr int kN = kFwdTileRows<kMask>;
  using Window = wg::FwdLayout<D, kMask, true, 2, kN>;
  using Global = wg::FwdLayout<D, kMask, false, 2, kN>;
  if constexpr (kMask != kNoMask) {
    const int window = mask_map<kMask>(&tmask, mask, batch, mask_heads, s,
                                       Window::kPitch, 2 * wg::kRows);
    if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (window)
      return launch_wgmma(flash_fwd_wgmma<D, kMask, true, kDrop>,
                          Window::kBytes, grid, wg::kThreads, stream, tq, tk,
                          tv, tmask, to, lse_f, mask, s, hq, hkv, mask_heads,
                          static_cast<int>(causal), scale, drop);
  }
  return launch_wgmma(flash_fwd_wgmma<D, kMask, false, kDrop>, Global::kBytes,
                      grid, wg::kThreads, stream, tq, tk, tv, tmask, to,
                      lse_f, mask, s, hq, hkv, mask_heads,
                      static_cast<int>(causal), scale, drop);
}

}  // namespace

DEFINE_ERROR_STRING()

// q, o: [batch, s, hq, d]; k, v: [batch, s, hkv, d], all contiguous of
// `dtype` with 16-byte aligned bases; lse: [batch, hq, s] float32. mask:
// null (mask_code kNoMask) or a contiguous additive [batch, mask_heads, s, s]
// of float32 or `dtype` (mask_code), mask_heads 1 or hq. With `dropout` the
// dropout build runs with the keep mask's threshold, scale and seed
// (Dropout). bfloat16 takes the wgmma kernel, float32 the FMA kernel.
// Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* mask, void* o,
                                   void* lse, int batch, int s, int hq,
                                   int hkv, int mask_heads, int d, int causal,
                                   float scale, int dtype, int mask_code,
                                   int dropout, unsigned drop_threshold,
                                   float drop_scale, unsigned drop_seed,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_threshold, drop_scale, drop_seed};
  return dispatch(dtype, d, mask_code, dropout != 0,
                  [&](auto t, auto dim, auto m, auto dr) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dim)::value, kMask = decltype(m)::value;
    constexpr bool kDrop = decltype(dr)::value;
    if constexpr (std::is_same_v<T, float>)
      return launch<T, D, kMask, kDrop>(q, k, v, mask, o, lse, batch, s, hq,
                                        hkv, mask_heads, causal != 0, scale,
                                        drop, st);
    else
      return launch_wgmma_fwd<D, kMask, kDrop>(q, k, v, mask, o, lse, batch,
                                               s, hq, hkv, mask_heads,
                                               causal != 0, scale, drop, st);
  });
}

// Dynamic shared memory (bytes) of the bf16 build for head dim d, a mask
// code, and whether the mask arrives as TMA windows (window 1) or is read
// from global memory; the dropout builds take the same.
extern "C" int flash_attention_fwd_wgmma_smem(int d, int mask_code,
                                              int window, int /*dropout*/) {
  return dispatch(kBFloat16, d, mask_code, [&](auto, auto dim, auto m) {
    constexpr int D = decltype(dim)::value, kMask = decltype(m)::value;
    constexpr int kN = kFwdTileRows<kMask>;
    if (window && kMask != kNoMask)
      return wg::FwdLayout<D, kMask, true, 2, kN>::kBytes;
    return wg::FwdLayout<D, kMask, false, 2, kN>::kBytes;
  });
}
