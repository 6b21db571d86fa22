// Flash attention forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched
// by _fwd_call through flash_attention_pallas): blockwise attention with an
// online softmax in float32, native GQA, causal or not, writing O in the
// input type and the float32 log-sum-exp per row. The TPU kernel's additive
// mask, kv_seqlens and dropout are not ported yet.
//
// Bound on this card: at the prefill shape (s = 512, d = 128, causal) the
// product does about s / 4 flops per byte of Q, K, V and O, below the ~295
// at which the H100's bf16 tensor cores become the limit, so the least
// time is set by bytes. This first version does its products with plain
// float32 FMAs (67 TFLOP/s peak, not 989), so in practice its own
// arithmetic limits it; tensor-core products (mma.sync, then wgmma fed by
// TMA) are later work.
//
// Design, against that bound:
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s, int hq, int hkv, bool causal,
                 float scale) {
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int s, int hq, int hkv, bool causal, float scale,
           cudaStream_t stream) {
  using L = Smem<D>;
  // above the 48 KB default, so opt in (a cheap host call, made per launch
  // so that it holds on whichever card is current)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(batch * hq, (s + kBlockM - 1) / kBlockM), block(kThreads);
  flash_fwd_kernel<T, D><<<grid, block, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s, hq, hkv, causal, scale);
  RETURN_LAUNCH_ERROR();
}

}  // namespace

DEFINE_ERROR_STRING()

// q, o: [batch, s, hq, d]; k, v: [batch, s, hkv, d], all contiguous of
// `dtype` with 16-byte aligned bases; lse: [batch, hq, s] float32.
// Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int batch, int s, int hq, int hkv, int d,
                                   int causal, float scale, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (dtype == kFloat32 && d == 64)
    return launch<float, 64>(q, k, v, o, lse, batch, s, hq, hkv, c, scale, st);
  if (dtype == kFloat32 && d == 128)
    return launch<float, 128>(q, k, v, o, lse, batch, s, hq, hkv, c, scale, st);
  if (dtype == kBFloat16 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, batch, s, hq, hkv, c,
                                     scale, st);
  if (dtype == kBFloat16 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, batch, s, hq, hkv, c,
                                      scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
