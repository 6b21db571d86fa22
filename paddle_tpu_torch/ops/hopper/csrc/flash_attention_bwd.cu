// Flash attention backward for Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (both launched by _bwd_call). With S = (Q / sqrt(d)) K^T
// and P = exp(S - LSE) recomputed in float32 from the forward's LSE, and
// delta = rowsum(dO * O) computed by the caller:
//   dQ = scale * sum_k dS K,   dS = P * (dO V^T - delta)
//   dV = P^T dO,               dK = dS^T (Q * scale)
// Causal or not, native GQA. The TPU kernels' mask, kv_seqlens and dropout
// are not ported yet.
//
// Bound on this card: at the training shape (s = 2048, d = 128, causal) the
// three (dQ) and four (dK/dV) products do about s / 2 flops per byte moved,
// above the H100's ~295, so the least time is set by the bf16 tensor cores.
// This first version multiplies with plain float32 FMAs (67 TFLOP/s peak),
// so its own arithmetic limits it; mma.sync and then wgmma fed by TMA are
// later work.
//
// Design, against that bound:
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
//   * Masks come from absolute positions (col <= row; both < s for the
//     ragged tail), so s is never padded and rows past s are never written.
//     A masked probability is forced to 0 rather than computed, so a fully
//     masked tile cannot produce NaN.
//   * No atomics: every output element is written by one thread of one
//     block after a fixed-order sum, so two launches give identical bits.
#include "flash_common.cuh"

namespace {

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int s, int hq, int hkv, bool causal, float scale) {
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const size_t at = static_cast<size_t>(bh) * s + row;
    row_lse[i] = row < s ? lse[at] : 0.f;
    row_delta[i] = row < s ? delta[at] : 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int n_tiles_all = (s + kBlockN - 1) / kBlockN;
  const int n_tiles = causal ? min(qt + 1, n_tiles_all) : n_tiles_all;

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
        const float p = keep ? expf(sc[i][j] - row_lse[i]) : 0.f;
        sdS[(ty * 4 + i) * kLdS + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int s, int hq, int hkv, bool causal,
                     float scale) {
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
          const float p = keep ? expf(st[i][j] - sLse[qc]) : 0.f;
          sP[(ty * 4 + i) * kLdS + qc] = p;
          sdS[(ty * 4 + i) * kLdS + qc] = p * (dpt[i][j] - sDelta[qc]);
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

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int batch, s, hq, hkv;
  bool causal;
  float scale;
};

template <typename T, int D>
int launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  const int bytes = BwdSmem<D>::kDqBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.batch * a.hq, (a.s + kBlockM - 1) / kBlockM);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.s, a.hq, a.hkv, a.causal, a.scale);
  RETURN_LAUNCH_ERROR();
}

template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  const int bytes = BwdSmem<D>::kDkvBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.batch * a.hkv, (a.s + kBlockN - 1) / kBlockN);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.s, a.hq, a.hkv,
      a.causal, a.scale);
  RETURN_LAUNCH_ERROR();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int batch, int s, int hq,
               int hkv, int causal, float scale) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), batch, s, hq, hkv,
              causal != 0, scale};
}

}  // namespace

DEFINE_ERROR_STRING()

// q, dout, dq: [batch, s, hq, d]; k, v, dk, dv: [batch, s, hkv, d], all
// contiguous of `dtype` with 16-byte aligned bases; lse, delta: [batch, hq,
// s] float32. Each entry launches one kernel on `stream`, allocates nothing
// and does not synchronise.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int batch, int s, int hq,
                                      int hkv, int d, int causal, float scale,
                                      int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, batch, s, hq, hkv,
                           causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && d == 64) return launch_dq<float, 64>(a, dq, st);
  if (dtype == kFloat32 && d == 128) return launch_dq<float, 128>(a, dq, st);
  if (dtype == kBFloat16 && d == 64)
    return launch_dq<__nv_bfloat16, 64>(a, dq, st);
  if (dtype == kBFloat16 && d == 128)
    return launch_dq<__nv_bfloat16, 128>(a, dq, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int batch, int s,
                                       int hq, int hkv, int d, int causal,
                                       float scale, int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, batch, s, hq, hkv,
                           causal, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && d == 64)
    return launch_dkv<float, 64>(a, dk, dv, st);
  if (dtype == kFloat32 && d == 128)
    return launch_dkv<float, 128>(a, dk, dv, st);
  if (dtype == kBFloat16 && d == 64)
    return launch_dkv<__nv_bfloat16, 64>(a, dk, dv, st);
  if (dtype == kBFloat16 && d == 128)
    return launch_dkv<__nv_bfloat16, 128>(a, dk, dv, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
