// Block-sparse attention forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/block_sparse_attention.py::_bs_fwd_kernel
// (launched by _bs_fwd): attention over the active K/V tiles of a static
// [s / block_q, s / block_k] tile pattern, with an online softmax in float32.
// The pattern arrives compressed (compress_block_mask): kmap[qi, t] lists
// the active K tiles of pattern row qi and counts[qi] how many there are. A
// row with no active tile writes zeros (l = 0), not a uniform softmax.
//
// Bound on this card: every active tile costs 4 * 128 * 128 * d flops of
// products against 2 * 128 * d elements of K and V, so at d = 64 the work
// is bound by the bf16 tensor cores, not by bytes.
//
// Both builds are the flash forward's loop with one indirection: a block
// walks the active K tiles of its pattern row in the order kmap lists them,
// cutting each block_k tile into K/V tiles of 64 rows (float32) or 128 or
// 64 (bfloat16). Masked tiles cost
// neither loads nor flops, as on the TPU where the compressed grid never
// visits them. kmap and counts are an int32 device array each; a block reads
// its own row of them (the TPU kernel's scalar prefetch). Q, K, V and O are
// read and written in place through their (batch, row, head) strides, so
// [b, s, h, d] and a transposed [b, h, s, d] both need no copy. Head dims
// 8..128 in steps of 8 run on the D = 64 or D = 128 build.
//
// bfloat16 inputs take block_sparse_fwd_wgmma: the flash forward's design
// (flash_attention.cu), whose consumer loop (fwd_consume in
// flash_common.cuh) it shares, schedule included. A producer warpgroup's
// first thread issues the TMA loads: the block's Q tiles once, then the
// active K and V tiles through a ring of 3 stages; the tensor maps are
// built from the strides, with an inner extent of d, so TMA zero-fills
// loads past d and clips the stores. Every score of an active tile counts,
// so no position is checked. A one-dimensional grid runs one head's Q
// blocks together, so that its K and V stay in L2. K/V tiles are 128 rows
// where block_k allows, else 64.
//   * A block of two consumer warpgroups owns 128 Q rows, which lie in one
//     pattern row when block_q is a multiple of 128. When block_q is an odd
//     multiple of 64 a 128-row block would span two pattern rows, so such
//     patterns take a build of one consumer warpgroup and 64-row blocks
//     (template argument kWGs 1; no setmaxnreg, no ping-pong), where each
//     K/V tile serves half as many rows.
//   * At d = 64 the softmax's exponentials (one per score, 16 a clock on an
//     SM) cost as much as the products, so the kernel sits further from its
//     tensor-core bound than the flash forward at d = 128.
//
// float32 inputs take block_sparse_fwd_kernel, on plain float32 FMAs (TF32
// tensor cores would hold about 1e-3 relative): one block of 256 threads
// per (64-row Q tile, batch * head); loads past d are zero-filled, so they
// add nothing to the scores or the output, and stores past d are skipped;
// 85 KB of shared memory at D = 128 (the scaled Q tile, one K-or-V tile,
// the probabilities), so two blocks fit on an SM.
#include "flash_common.cuh"

namespace {

template <int D>
struct BsSmem {
  static constexpr int kLd = D + 4;  // 16-byte aligned rows
  static constexpr int kBytes =
      (2 * kBlockM * kLd + kBlockM * kLdS) * static_cast<int>(sizeof(float));
};

struct Strides {  // elements between batches, rows and heads
  long long b, s, h;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        const int* __restrict__ kmap,
                        const int* __restrict__ counts, int h, int d,
                        int n_tiles_max, int block_q, int block_k,
                        Strides qs, Strides os, Strides ks, float scale) {
  using L = BsSmem<D>;
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sKV = sQ + kBlockM * L::kLd;
  float* sP = sKV + kBlockN * L::kLd;

  const int bh = blockIdx.x;  // batch * h + head
  const int b = bh / h, hh = bh % h;
  const int q0 = blockIdx.y * kBlockM;
  const int qi = q0 / block_q;  // the pattern row of this Q tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const T* q_base = q + b * qs.b + q0 * qs.s + hh * qs.h;
  const T* k_base = k + b * ks.b + hh * ks.h;
  const T* v_base = v + b * ks.b + hh * ks.h;

  load_tile<T, D>(sQ, L::kLd, q_base, qs.s, kBlockM, scale, d);

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_active = counts[qi];
  const int subs = block_k / kBlockN;
  for (int t = 0; t < n_active * subs; ++t) {
    const int k0 = kmap[qi * n_tiles_max + t / subs] * block_k +
                   (t % subs) * kBlockN;
    __syncthreads();  // the previous tile's P.V reads of sKV/sP are done
    load_tile<T, D>(sKV, L::kLd, k_base + k0 * ks.s, ks.s, kBlockN, 1.f, d);
    __syncthreads();
    float sc[4][4];
    tile_dot<D>(sQ, sKV, L::kLd, sc);

    // online softmax over this tile's columns, per row: every score of an
    // active tile counts
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        sP[(ty * 4 + i) * kLdS + tx + 16 * j] = p;
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
    load_tile<T, D>(sKV, L::kLd, v_base + k0 * ks.s, ks.s, kBlockN, 1.f, d);
    __syncthreads();
    tile_accumulate<D>(sP, sKV, L::kLd, acc);
  }

  // O = acc / max(l, 1e-20) in the input type: exactly 0 for an empty row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    T* orow = o + b * os.b + (q0 + ty * 4 + i) * os.s + hh * os.h;
#pragma unroll
    for (int cc = 0; cc < D / 64; ++cc) {
      const int c = 64 * cc + 4 * tx;
      if (c >= d) continue;  // d is a multiple of 8: whole chunks only
      store4<T>(orow + c, acc[i][cc * 4 + 0] * inv, acc[i][cc * 4 + 1] * inv,
                acc[i][cc * 4 + 2] * inv, acc[i][cc * 4 + 3] * inv);
    }
  }
}

template <int D, int kWGs, int kN>
__global__ void __launch_bounds__(128 * (1 + kWGs), 1)
block_sparse_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       const int* __restrict__ kmap,
                       const int* __restrict__ counts,
                       const int* __restrict__ order, int h, int s,
                       int n_tiles_max, int block_q, int block_k,
                       float scale) {
  using namespace wg;
  using L = FwdLayout<D, kNoMask, false, kWGs, kN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* qbar = empty + L::kStages;

  // one head's Q blocks run together, so that its K and V stay in L2, the
  // pattern rows with the most active tiles first (`order`), so that the
  // grid does not end on a long one
  const int n_qb = s / (kWGs * kRows);
  const int per_row = block_q / (kWGs * kRows);  // blocks a pattern row
  const int bh = blockIdx.x / n_qb;  // batch * h + head
  const int b = bh / h, hh = bh % h;
  const int j = blockIdx.x % n_qb;
  const int qi = order[j / per_row];  // the pattern row of this block
  const int q0 = qi * block_q + j % per_row * kWGs * kRows;
  const int subs = block_k / kN;
  const int n_tiles = counts[qi] * subs;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 4 * kWGs);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // (with one consumer warpgroup every thread may hold 255 registers)
  if (threadIdx.x < 128) {  // producer
    if constexpr (kWGs == 2) hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    hopper::mbar_arrive_expect_tx(qbar, kWGs * L::kTile);
    for (int w = 0; w < kWGs; ++w)
      load_rows<D, kRows>(smem + L::kQ + w * L::kTile, &tm_q, qbar, hh,
                          q0 + kRows * w, b);
    const int* row = kmap + static_cast<size_t>(qi) * n_tiles_max;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = row[t / subs] * block_k + (t % subs) * kN;
      const int st = t % L::kStages;
      uint8_t* stage = smem + L::kStage0 + st * L::kStageBytes;
      hopper::mbar_wait(&empty[st], ((t / L::kStages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&full[st], 2 * L::kKVTile);
      load_rows<D, kN>(stage, &tm_k, &full[st], hh, k0, b);
      load_rows<D, kN>(stage + L::kKVTile, &tm_v, &full[st], hh, k0, b);
    }
    return;
  }

  // consumers: warpgroup cw owns Q rows row0 = q0 + 64 cw ..
  if constexpr (kWGs == 2) hopper::setmaxnreg_inc<kConsumerRegs>();
  const int cw = (threadIdx.x - 128) / 128;
  const int row0 = q0 + kRows * cw;
  uint8_t* sQ = smem + L::kQ + cw * L::kTile;
  auto k0_of = [](int) { return 0; };  // (positions are never checked)
  auto no_mask = [](const uint8_t*, int, int, int, int) {
    return make_float2(0.f, 0.f);
  };
  float acc[D / 2], m[2], l[2];
  hopper::mbar_wait(qbar, 0);
  // products overlapping the softmax; the two warpgroups taking turns
  fwd_consume<D, kN, kNoMask, true, kWGs == 2>(
      sQ, smem + L::kStage0, L::kStageBytes, L::kStages, L::kKVTile, full,
      empty, n_tiles, n_tiles, n_tiles, row0, s, false, scale, cw, k0_of,
      no_mask, acc, m, l);
  // O = acc / max(l, 1e-20): exactly 0 for an empty row
  store_o<D>(acc, l, sQ, &tm_o, cw, hh, row0, b, true);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kmap, const int* counts, int batch, int s, int h, int d,
           int n_tiles_max, int block_q, int block_k, Strides qs, Strides os,
           Strides ks, float scale, cudaStream_t stream) {
  const int bytes = BsSmem<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      block_sparse_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(batch * h, s / kBlockM);
  block_sparse_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kmap, counts, h, d,
      n_tiles_max, block_q, block_k, qs, os, ks, scale);
  RETURN_LAUNCH_ERROR();
}

template <int D, int kWGs, int kN>
int launch_wgmma_bs(const void* q, const void* k, const void* v, void* o,
                    const int* kmap, const int* counts, const int* order,
                    int batch, int s, int h, int d, int n_tiles_max,
                    int block_q, int block_k, Strides qs, Strides os,
                    Strides ks, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!rows_map(&tq, q, batch, s, h, d, qs.b, qs.s, qs.h) ||
      !rows_map(&tk, k, batch, s, h, d, ks.b, ks.s, ks.h) ||
      !rows_map(&tv, v, batch, s, h, d, ks.b, ks.s, ks.h) ||
      !rows_map(&to, o, batch, s, h, d, os.b, os.s, os.h))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch * h * (s / (kWGs * wg::kRows)));
  return launch_wgmma(block_sparse_fwd_wgmma<D, kWGs, kN>,
                      wg::FwdLayout<D, kNoMask, false, kWGs, kN>::kBytes, grid,
                      128 * (1 + kWGs), stream, tq, tk, tv, to, kmap, counts,
                      order, h, s, n_tiles_max, block_q, block_k, scale);
}

}  // namespace

DEFINE_ERROR_STRING()

// q, o, k, v: [batch, s, h, d] of `dtype` with element strides (batch,
// row, head) qs*, os*, ks* (k and v share theirs); the last dimension
// contiguous, every stride a multiple of 16 bytes, bases 16-byte aligned. kmap:
// [s / block_q, n_tiles_max] int32, counts: [s / block_q] int32 and order:
// the pattern rows by falling count, [s / block_q] int32, on the device
// (the float32 build takes no order). block_q and block_k are multiples of
// 64 dividing s; d is a
// multiple of 8 up to 128. bfloat16 takes the wgmma kernel (64-row blocks
// when block_q is an odd multiple of 64), float32 the FMA kernel. Launches
// on `stream`, allocates nothing, does not synchronise.
extern "C" int block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* kmap,
    const void* counts, const void* order, int batch, int s, int h, int d,
    int n_tiles_max,
    int block_q, int block_k, long long qsb, long long qss, long long qsh,
    long long osb, long long oss, long long osh, long long ksb, long long kss,
    long long ksh, float scale, int dtype, void* stream) {
  const Strides qs{qsb, qss, qsh}, os{osb, oss, osh}, ks{ksb, kss, ksh};
  const int* km = static_cast<const int*>(kmap);
  const int* cn = static_cast<const int*>(counts);
  const int* od = static_cast<const int*>(order);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > 128 || d % 8 || block_q % kBlockM || block_k % kBlockN ||
      s % block_q || s % block_k)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = d > 64;
  if (dtype == kFloat32)
    return wide ? launch<float, 128>(q, k, v, o, km, cn, batch, s, h, d,
                                     n_tiles_max, block_q, block_k, qs, os,
                                     ks, scale, st)
                : launch<float, 64>(q, k, v, o, km, cn, batch, s, h, d,
                                    n_tiles_max, block_q, block_k, qs, os,
                                    ks, scale, st);
  if (dtype == kBFloat16) {
    auto go = [&](auto dim, auto wgs, auto rows) {
      return launch_wgmma_bs<decltype(dim)::value, decltype(wgs)::value,
                             decltype(rows)::value>(
          q, k, v, o, km, cn, od, batch, s, h, d, n_tiles_max, block_q,
          block_k, qs, os, ks, scale, st);
    };
    auto by_rows = [&](auto dim, auto wgs) {
      return block_k % 128 == 0 ? go(dim, wgs, Int<128>{})
                                : go(dim, wgs, Int<64>{});
    };
    auto by_wgs = [&](auto dim) {
      return block_q % 128 == 0 ? by_rows(dim, Int<2>{})
                                : by_rows(dim, Int<1>{});
    };
    return wide ? by_wgs(Int<128>{}) : by_wgs(Int<64>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory (bytes) of the bf16 build for head dim D (64 or
// 128), kWGs consumer warpgroups (1 or 2) and K/V tiles of kN rows (64 or
// 128).
extern "C" int block_sparse_attention_fwd_wgmma_smem(int d, int wgs,
                                                     int kn) {
  auto bytes = [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    using wg::FwdLayout;
    if (wgs == 2)
      return kn == 128 ? FwdLayout<D, kNoMask, false, 2, 128>::kBytes
                       : FwdLayout<D, kNoMask, false, 2, 64>::kBytes;
    return kn == 128 ? FwdLayout<D, kNoMask, false, 1, 128>::kBytes
                     : FwdLayout<D, kNoMask, false, 1, 64>::kBytes;
  };
  if (d == 64) return bytes(Int<64>{});
  if (d == 128) return bytes(Int<128>{});
  return -1;
}
