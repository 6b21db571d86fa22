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
// is bound by the bf16 tensor cores, not by bytes. This first version
// multiplies with plain float32 FMAs (67 TFLOP/s peak), as the flash kernels
// do; tensor-core products are later work.
//
// Design, against that bound:
//   * The flash forward's loop with one indirection. One block of 256
//     threads per (64-row Q tile, batch * head) walks the active K tiles of
//     its pattern row in the order kmap lists them, cutting each block_k
//     tile into 64-row K/V sub-tiles. Masked tiles cost neither loads nor
//     flops, as on the TPU where the compressed grid never visits them.
//   * kmap and counts are an int32 device array each; a block reads its
//     own row of them (the TPU kernel's scalar prefetch).
//   * Q, K, V and O are read and written in place through their (batch,
//     row, head) strides, so [b, s, h, d] and a transposed [b, h, s, d]
//     both need no copy. The last dimension is contiguous.
//   * Head dims 8..128 in steps of 8 run on the D = 64 or D = 128 build:
//     loads past d are zero-filled, so they add nothing to the scores or
//     the output, and stores past d are skipped.
//   * 85 KB of shared memory at D = 128 (the scaled Q tile, one K-or-V
//     tile, the probabilities), so two blocks fit on an SM.
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

}  // namespace

DEFINE_ERROR_STRING()

// q, o, k, v: [batch, s, h, d] of `dtype` with element strides (batch,
// row, head) qs*, os*, ks* (k and v share theirs); the last dimension
// contiguous, every stride a multiple of 16 bytes, bases 16-byte aligned. kmap:
// [s / block_q, n_tiles_max] int32 and counts: [s / block_q] int32 on the
// device. block_q and block_k are multiples of 64 dividing s; d is a
// multiple of 8 up to 128. Launches on `stream`, allocates nothing, does
// not synchronise.
extern "C" int block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* kmap,
    const void* counts, int batch, int s, int h, int d, int n_tiles_max,
    int block_q, int block_k, long long qsb, long long qss, long long qsh,
    long long osb, long long oss, long long osh, long long ksb, long long kss,
    long long ksh, float scale, int dtype, void* stream) {
  const Strides qs{qsb, qss, qsh}, os{osb, oss, osh}, ks{ksb, kss, ksh};
  const int* km = static_cast<const int*>(kmap);
  const int* cn = static_cast<const int*>(counts);
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
  if (dtype == kBFloat16)
    return wide ? launch<__nv_bfloat16, 128>(q, k, v, o, km, cn, batch, s, h,
                                             d, n_tiles_max, block_q, block_k,
                                             qs, os, ks, scale, st)
                : launch<__nv_bfloat16, 64>(q, k, v, o, km, cn, batch, s, h,
                                            d, n_tiles_max, block_q, block_k,
                                            qs, os, ks, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
