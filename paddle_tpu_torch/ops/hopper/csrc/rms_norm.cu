// RMSNorm forward and backward for Hopper (sm_90a).
//
// Forward: replaces paddle_tpu/ops/pallas/fused_ops.py::_rms_fwd_kernel
// (launched by _rms_fwd_call): y = (x * rstd) * w with
// rstd = 1 / sqrt(mean(x^2) + eps), computed in float32 and rounded to the
// output type once, plus rstd in float32 per row.
//
// Backward: replaces ::_rms_bwd_kernel (launched by _rms_bwd_call): with
// c = sum(g * w * x) / h per row,
//   dx = (g * w - x * c * rstd^2) * rstd,   dw = sum over rows of g * x * rstd,
// in float32, dx rounded to x's type and dw to w's type once.
//
// Bound on this card: bytes. Each element is read once and written once
// with a handful of flops in between, far below the ~295 flops per byte at
// which the H100 stops being memory-bound. So the design keeps enough
// 16-byte loads in flight and touches device memory once per byte.
//
// Two builds of each kernel; the wrapper's plan (fused_ops.py,
// rms_fwd_plan / rms_bwd_plan) picks one per call:
//
// Vector builds (rows of a whole number of 16-byte vectors, x, w, g 16-byte
// aligned, up to a register budget). Vector j of a row belongs to thread
// j % blockDim.x, slot j / blockDim.x, for every row the block takes, so a
// thread keeps w (and, backward, its float32 dw partial) in registers.
// - Forward (rms_norm_fwd_vec): a block of kVpt * blockDim.x >= h / vec
//   slots walks rows blockIdx.x, + gridDim.x, ... (a grid of as many blocks
//   as fit on the card at once). A row is held in registers: all of its
//   loads go out together, and the next row's loads are in flight before this
//   row is reduced. The sum of squares is reduced by warp shuffles and one
//   shared exchange (one barrier a row), then the row is normalised from
//   registers and stored as 16-byte vectors.
// - Backward row pass (rms_norm_bwd_vec): one block per SM, each over a
//   contiguous range of rows. Thread 0 streams the x and g rows into a ring
//   of kStages (3) shared-memory stages with TMA bulk copies that complete
//   on mbarriers, so the next stages' rows are in flight while a row's c is
//   reduced; the barrier of that reduction also frees the stage for its next
//   row. dx goes out as 16-byte stores; each block writes one float32 dw
//   partial.
// General builds (any other width or alignment): one block of 256 threads
// per row (forward) or per group of rows (backward) with scalar coalesced
// loads; the backward keeps its dw partial in shared memory (column i
// belongs to thread i % 256), so widths up to 51,200 fit.
//
// Blocks run in any order and share nothing, so dw is summed in a second
// kernel (rms_norm_dw_sum): each block owns a few columns, its warps' lanes
// sum fixed ranges of the partials, and the ranges are combined in shared
// memory in a fixed order. No atomics: two launches give the same bits.
#include "common.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int kThreads = 256;      // general builds and the column sum
constexpr int kVecThreads = 512;   // most threads of a vector-build block
constexpr int kStages = 3;         // rows of x and g in the backward's ring

// 16 bytes of T as float32 values.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& v,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& v,
                                                float (&f)[8]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[8]) {
    return make_uint4(hopper::pack_bf16(f[0], f[1]),
                      hopper::pack_bf16(f[2], f[3]),
                      hopper::pack_bf16(f[4], f[5]),
                      hopper::pack_bf16(f[6], f[7]));
  }
};

// The block's sum of v, the same bits in every thread: warp shuffles, then
// one exchange through `red` (a float per warp). Callers alternate between
// two `red` buffers row by row, so one barrier a row suffices.
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x / 32); ++i) s += red[i];
  return s;
}

// -- vector builds -----------------------------------------------------------

template <int kVpt>
__device__ __forceinline__ void load_row(uint4 (&v)[kVpt],
                                         const uint4* __restrict__ row,
                                         int nv) {
#pragma unroll
  for (int k = 0; k < kVpt; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    v[k] = j < nv ? row[j] : make_uint4(0, 0, 0, 0);
  }
}

// Keeps w packed from row to row: without it the compiler hoists w's
// unpacking out of the row loop and holds bf16 w as float32, twice the
// registers (the bf16 forward with 8 vectors a thread spilled).
template <int kVpt>
__device__ __forceinline__ void keep_packed(uint4 (&v)[kVpt]) {
#pragma unroll
  for (int k = 0; k < kVpt; ++k)
    asm volatile("" : "+r"(v[k].x), "+r"(v[k].y), "+r"(v[k].z), "+r"(v[k].w));
}

template <typename T, int kVpt>
__global__ void __launch_bounds__(kVecThreads)
rms_norm_fwd_vec(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, float* __restrict__ rstd, int rows,
                 int h, float eps) {
  using V = Vec<T>;
  __shared__ float red[2][kVecThreads / 32];
  const int nv = h / V::kN;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  uint4 wr[kVpt], cur[kVpt], nxt[kVpt];
  load_row<kVpt>(wr, reinterpret_cast<const uint4*>(w), nv);
  int row = blockIdx.x;
  load_row<kVpt>(cur, xv + static_cast<size_t>(row) * nv, nv);
  for (int parity = 0; row < rows; row += gridDim.x, parity ^= 1) {
    keep_packed(wr);
    const int next = row + gridDim.x;
    if (next < rows)
      load_row<kVpt>(nxt, xv + static_cast<size_t>(next) * nv, nv);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      float f[V::kN];
      V::unpack(cur[k], f);
#pragma unroll
      for (int e = 0; e < V::kN; ++e) ss = fmaf(f[e], f[e], ss);
    }
    ss = row_sum(ss, red[parity]);
    const float r = 1.0f / sqrtf(ss / static_cast<float>(h) + eps);
    if (threadIdx.x == 0) rstd[row] = r;
    uint4* yr = yv + static_cast<size_t>(row) * nv;
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      if (j < nv) {
        float f[V::kN], wf[V::kN];
        V::unpack(cur[k], f);
        V::unpack(wr[k], wf);
#pragma unroll
        for (int e = 0; e < V::kN; ++e) f[e] = f[e] * r * wf[e];
        yr[j] = V::pack(f);
      }
    }
#pragma unroll
    for (int k = 0; k < kVpt; ++k) cur[k] = nxt[k];
  }
}

template <typename T, int kVpt>
__global__ void __launch_bounds__(kVecThreads, 1)
rms_norm_bwd_vec(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ g, const float* __restrict__ rstd,
                 T* __restrict__ dx, float* __restrict__ dw_part, int rows,
                 int h) {
  using V = Vec<T>;
  // stage s holds the x row, then the g row
  extern __shared__ __align__(128) uint4 ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float red[2][kVecThreads / 32];
  const int nv = h / V::kN;
  const uint32_t row_bytes = static_cast<uint32_t>(nv) * 16u;
  const int r0 = static_cast<int>(static_cast<long long>(blockIdx.x) * rows /
                                  gridDim.x);
  const int n = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                 rows / gridDim.x) - r0;
  auto fetch = [&](int s, int row) {  // thread 0: row into stage s
    const size_t off = static_cast<size_t>(row) * h;
    hopper::mbar_arrive_expect_tx(&full[s], 2 * row_bytes);
    hopper::bulk_load(ring + 2 * s * nv, x + off, row_bytes, &full[s]);
    hopper::bulk_load(ring + (2 * s + 1) * nv, g + off, row_bytes,
                      &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages && s < n; ++s) fetch(s, r0 + s);

  uint4 wr[kVpt];
  load_row<kVpt>(wr, reinterpret_cast<const uint4*>(w), nv);
  float acc[kVpt][V::kN];
#pragma unroll
  for (int k = 0; k < kVpt; ++k)
#pragma unroll
    for (int e = 0; e < V::kN; ++e) acc[k][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int row = r0 + i;
    const float r = rstd[row];
    keep_packed(wr);
    hopper::mbar_wait(&full[s], (i / kStages) & 1);
    uint4 xr[kVpt], gr[kVpt];
    load_row<kVpt>(xr, ring + 2 * s * nv, nv);
    load_row<kVpt>(gr, ring + (2 * s + 1) * nv, nv);
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      float xf[V::kN], gf[V::kN], wf[V::kN];
      V::unpack(xr[k], xf);
      V::unpack(gr[k], gf);
      V::unpack(wr[k], wf);
#pragma unroll
      for (int e = 0; e < V::kN; ++e) part = fmaf(gf[e] * wf[e], xf[e], part);
    }
    // every thread has read stage s once the exchange's barrier is passed
    const float c = row_sum(part, red[i & 1]) / static_cast<float>(h);
    if (threadIdx.x == 0 && i + kStages < n) fetch(s, row + kStages);
    const float k2 = c * r * r;
    uint4* dxr = reinterpret_cast<uint4*>(dx) + static_cast<size_t>(row) * nv;
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      if (j < nv) {
        float xf[V::kN], gf[V::kN], wf[V::kN], o[V::kN];
        V::unpack(xr[k], xf);
        V::unpack(gr[k], gf);
        V::unpack(wr[k], wf);
#pragma unroll
        for (int e = 0; e < V::kN; ++e) {
          o[e] = fmaf(-xf[e], k2, gf[e] * wf[e]) * r;
          acc[k][e] = fmaf(gf[e] * xf[e], r, acc[k][e]);
        }
        dxr[j] = V::pack(o);
      }
    }
  }
  float4* out = reinterpret_cast<float4*>(dw_part + static_cast<size_t>(
                                                        blockIdx.x) * h);
#pragma unroll
  for (int k = 0; k < kVpt; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < nv) {
#pragma unroll
      for (int q = 0; q < V::kN / 4; ++q)
        out[j * (V::kN / 4) + q] =
            make_float4(acc[k][4 * q], acc[k][4 * q + 1], acc[k][4 * q + 2],
                        acc[k][4 * q + 3]);
    }
  }
}

// -- general builds ----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ rstd, int h,
                    float eps) {
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;
  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  const float r =
      1.0f / sqrtf(row_sum(ss, red) / static_cast<float>(h) + eps);
  if (threadIdx.x == 0) rstd[row] = r;
  for (int i = threadIdx.x; i < h; i += kThreads)
    yr[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(w[i]));
}

// rows blockIdx.x, blockIdx.x + gridDim.x, ...; dw_part: [gridDim.x, h]
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ g, const float* __restrict__ rstd,
                    T* __restrict__ dx, float* __restrict__ dw_part, int rows,
                    int h) {
  extern __shared__ float s_dw[];  // h floats
  __shared__ float red[2][kThreads / 32];
  for (int i = threadIdx.x; i < h; i += kThreads) s_dw[i] = 0.f;
  for (int row = blockIdx.x, parity = 0; row < rows;
       row += gridDim.x, parity ^= 1) {
    const size_t off = static_cast<size_t>(row) * h;
    const T* xr = x + off;
    const T* gr = g + off;
    const float r = rstd[row];
    float part = 0.f;
    for (int i = threadIdx.x; i < h; i += kThreads)
      part = fmaf(to_f32(gr[i]) * to_f32(w[i]), to_f32(xr[i]), part);
    const float c = row_sum(part, red[parity]) / static_cast<float>(h);
    T* dxr = dx + off;
    for (int i = threadIdx.x; i < h; i += kThreads) {
      const float xv = to_f32(xr[i]), gv = to_f32(gr[i]);
      const float gw = gv * to_f32(w[i]);
      dxr[i] = from_f32<T>((gw - xv * c * r * r) * r);
      s_dw[i] = fmaf(gv * xv, r, s_dw[i]);
    }
  }
  float* out = dw_part + static_cast<size_t>(blockIdx.x) * h;
  for (int i = threadIdx.x; i < h; i += kThreads) out[i] = s_dw[i];
}

// -- the column sum ----------------------------------------------------------

// dw[i] = sum over the partials' rows of dw_part[b][i]. A block owns `cols`
// columns (8, 16 or 32); its kThreads / cols groups of threads sum fixed,
// contiguous ranges of the partials, combined in shared memory in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_dw_sum(const float* __restrict__ dw_part, T* __restrict__ dw,
                int parts, int h, int cols) {
  __shared__ float sums[kThreads];
  const int groups = kThreads / cols;
  const int c = threadIdx.x % cols, q = threadIdx.x / cols;
  const int col = blockIdx.x * cols + c;
  const int lo = q * parts / groups, hi = (q + 1) * parts / groups;
  float acc = 0.f;
  if (col < h) {
#pragma unroll 4
    for (int b = lo; b < hi; ++b)
      acc += dw_part[static_cast<size_t>(b) * h + col];
  }
  sums[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < cols && col < h) {
    float total = 0.f;
    for (int i = 0; i < groups; ++i) total += sums[i * cols + threadIdx.x];
    dw[col] = from_f32<T>(total);
  }
}

// -- launches ----------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The vector forward's grid: as many blocks as fit on `sms` SMs at once
// (occupancy kept per build and block size), at most one per row.
template <typename T, int kVpt>
int launch_fwd_vec(const T* x, const T* w, T* y, float* rstd, int rows,
                   int h, float eps, int threads, int sms, cudaStream_t s) {
  static int per_sm[kVecThreads / 32 + 1];
  int& fit = per_sm[threads / 32];
  if (fit == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, rms_norm_fwd_vec<T, kVpt>, threads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (fit < 1) fit = 1;
  }
  const long long capacity = static_cast<long long>(fit) * sms;
  const int grid = static_cast<int>(rows < capacity ? rows : capacity);
  rms_norm_fwd_vec<T, kVpt><<<grid, threads, 0, s>>>(x, w, y, rstd, rows, h,
                                                     eps);
  RETURN_LAUNCH_ERROR();
}

template <typename T>
int launch_fwd(const void* xp, const void* wp, void* yp, void* rp, int rows,
               int h, float eps, int vpt, int threads, int sms,
               cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  T* y = static_cast<T*>(yp);
  float* rstd = static_cast<float*>(rp);
  if (vpt == 0) {
    rms_norm_fwd_kernel<T><<<rows, kThreads, 0, s>>>(x, w, y, rstd, h, eps);
    RETURN_LAUNCH_ERROR();
  }
  if (h % Vec<T>::kN || !aligned16(x) || !aligned16(w) || !aligned16(y) ||
      threads % 32 || threads < 32 || threads > kVecThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (vpt) {
    case 1:
      return launch_fwd_vec<T, 1>(x, w, y, rstd, rows, h, eps, threads, sms,
                                  s);
    case 4:
      return launch_fwd_vec<T, 4>(x, w, y, rstd, rows, h, eps, threads, sms,
                                  s);
    case 8:
      return launch_fwd_vec<T, 8>(x, w, y, rstd, rows, h, eps, threads, sms,
                                  s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int kVpt>
cudaError_t launch_bwd_vec(const T* x, const T* w, const T* g,
                           const float* rstd, T* dx, float* dw_part,
                           int rows, int h, int parts, int threads,
                           cudaStream_t s) {
  const int bytes = 2 * kStages * h * static_cast<int>(sizeof(T));
  const cudaError_t e = cudaFuncSetAttribute(
      rms_norm_bwd_vec<T, kVpt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  rms_norm_bwd_vec<T, kVpt><<<parts, threads, bytes, s>>>(
      x, w, g, rstd, dx, dw_part, rows, h);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* xp, const void* wp, const void* gp,
               const void* rp, void* dxp, void* dwp, void* partp, int rows,
               int h, int parts, int vpt, int threads, int sum_cols,
               cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  const T* g = static_cast<const T*>(gp);
  const float* rstd = static_cast<const float*>(rp);
  T* dx = static_cast<T*>(dxp);
  float* dw_part = static_cast<float*>(partp);
  if (sum_cols != 8 && sum_cols != 16 && sum_cols != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (vpt == 0) {
    const int bytes = h * static_cast<int>(sizeof(float));
    e = cudaFuncSetAttribute(rms_norm_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    rms_norm_bwd_kernel<T><<<parts, kThreads, bytes, s>>>(x, w, g, rstd, dx,
                                                          dw_part, rows, h);
    e = cudaGetLastError();
  } else {
    if (h % Vec<T>::kN || !aligned16(x) || !aligned16(w) || !aligned16(g) ||
        !aligned16(dx) || !aligned16(dw_part) || threads % 32 ||
        threads < 32 || threads > kVecThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (vpt) {
      case 1:
        e = launch_bwd_vec<T, 1>(x, w, g, rstd, dx, dw_part, rows, h, parts,
                                 threads, s);
        break;
      case 2:
        e = launch_bwd_vec<T, 2>(x, w, g, rstd, dx, dw_part, rows, h, parts,
                                 threads, s);
        break;
      case 4:
        e = launch_bwd_vec<T, 4>(x, w, g, rstd, dx, dw_part, rows, h, parts,
                                 threads, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  rms_norm_dw_sum<T><<<(h + sum_cols - 1) / sum_cols, kThreads, 0, s>>>(
      dw_part, static_cast<T*>(dwp), parts, h, sum_cols);
  RETURN_LAUNCH_ERROR();
}

}  // namespace

DEFINE_ERROR_STRING()

// x, y: [rows, h] contiguous of `dtype`; w: [h] of `dtype`; rstd: [rows]
// float32. `vpt` 0 takes the general build; 1, 4 or 8 the vector build with
// that many 16-byte vectors per thread and `threads` threads per block (a
// multiple of 32, at most 512), on a card of `sms` SMs. Launches on
// `stream`, allocates nothing, does not synchronise.
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, void* rstd,
                            int rows, int h, float eps, int dtype, int vpt,
                            int threads, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_fwd<float>(x, w, y, rstd, rows, h, eps, vpt, threads, sms,
                             s);
  if (dtype == kBFloat16)
    return launch_fwd<__nv_bfloat16>(x, w, y, rstd, rows, h, eps, vpt,
                                     threads, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, g, dx: [rows, h] contiguous of `dtype`; w, dw: [h] of `dtype`; rstd:
// [rows] float32; dw_part: [parts, h] float32 scratch, parts <= rows, one
// partial per row-pass block. `vpt` 0 takes the general row pass; 1, 2 or 4
// the vector build with `threads` threads per block and a ring of kStages
// rows of x and g (2 * kStages * h elements of shared memory). The column
// sum takes `sum_cols` (8, 16 or 32) columns per block. Launches the row
// pass and the column sum on `stream`, allocates nothing, does not
// synchronise.
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* g,
                            const void* rstd, void* dx, void* dw,
                            void* dw_part, int rows, int h, int parts,
                            int dtype, int vpt, int threads, int sum_cols,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_bwd<float>(x, w, g, rstd, dx, dw, dw_part, rows, h, parts,
                             vpt, threads, sum_cols, s);
  if (dtype == kBFloat16)
    return launch_bwd<__nv_bfloat16>(x, w, g, rstd, dx, dw, dw_part, rows, h,
                                     parts, vpt, threads, sum_cols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
