// RMSNorm forward and backward for Hopper (sm_90a).
//
// Forward: replaces paddle_tpu/ops/pallas/fused_ops.py::_rms_fwd_kernel
// (launched by _rms_fwd_call): y = x * rsqrt(mean(x^2) + eps) * w, computed
// in float32 and rounded to the output type once, plus rstd in float32 per
// row.
//
// Backward: replaces ::_rms_bwd_kernel (launched by _rms_bwd_call): with
// c = sum(g * w * x) / h per row,
//   dx = (g * w - x * c * rstd^2) * rstd,   dw = sum over rows of g * x * rstd,
// in float32, dx rounded to x's type and dw to w's type once.
//
// Bound on this card: bytes. Each element is read once and written once
// with a handful of flops in between, far below the ~295 flops per byte at
// which the H100 stops being memory-bound.
//
// Design: one block of 256 threads per row (the forward) or per group of
// rows (the backward), so a row of any width is reduced without padding
// rows (the TPU kernel padded rows to a multiple of 8 for its (8, 128)
// tiling). Row sums accumulate in float32 per thread, then across the warp
// with shuffles and across the block's eight warps through shared memory.
// The second pass over a row re-reads it, which an 8-16 KB row keeps in L1,
// so device memory sees each byte once. Loads are scalar and coalesced;
// vector loads are left for a later change.
//
// The TPU kernel sums dw over rows in its sequential grid; Hopper blocks run
// in any order and share nothing. So each backward block keeps its own
// float32 dw partial in shared memory (column i belongs to thread i % 256,
// so no two threads touch one entry), writes it out once, and a second
// kernel sums the partials column by column in a fixed order: no atomics,
// and two launches give identical bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ rstd, int h,
                    float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;

  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float row_rstd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) {
      const float r = 1.0f / sqrtf(v / static_cast<float>(h) + eps);
      row_rstd = r;
      rstd[row] = r;
    }
  }
  __syncthreads();
  const float r = row_rstd;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    yr[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(w[i]));
  }
}

// a block's row-sum of v, returned to every thread; `scratch` holds
// kThreads / 32 floats and `result` one
__device__ __forceinline__ float block_sum(float v, float* scratch,
                                           float* result) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? scratch[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) *result = t;
  }
  __syncthreads();
  return *result;
}

// rows blockIdx.x, blockIdx.x + gridDim.x, ...; dw_part: [gridDim.x, h]
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ g, const float* __restrict__ rstd,
                    T* __restrict__ dx, float* __restrict__ dw_part, int rows,
                    int h) {
  extern __shared__ float s_dw[];  // h floats
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float row_c;
  for (int i = threadIdx.x; i < h; i += kThreads) s_dw[i] = 0.f;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = static_cast<size_t>(row) * h;
    const T* xr = x + off;
    const T* gr = g + off;
    const float r = rstd[row];
    float part = 0.f;
    for (int i = threadIdx.x; i < h; i += kThreads)
      part = fmaf(to_f32(gr[i]) * to_f32(w[i]), to_f32(xr[i]), part);
    const float c = block_sum(part, warp_sums, &row_c) / static_cast<float>(h);
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

// dw[i] = sum over the partials' rows of dw_part[b][i], in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_dw_kernel(const float* __restrict__ dw_part, T* __restrict__ dw,
                   int parts, int h) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= h) return;
  float acc = 0.f;
  for (int b = 0; b < parts; ++b) acc += dw_part[static_cast<size_t>(b) * h + i];
  dw[i] = from_f32<T>(acc);
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* g, const void* rstd,
               void* dx, void* dw, void* dw_part, int rows, int h, int parts,
               cudaStream_t s) {
  const int bytes = h * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rms_norm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rms_norm_bwd_kernel<T><<<parts, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<const float*>(rstd),
      static_cast<T*>(dx), static_cast<float*>(dw_part), rows, h);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rms_norm_dw_kernel<T><<<(h + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(dw_part), static_cast<T*>(dw), parts, h);
  RETURN_LAUNCH_ERROR();
}

}  // namespace

DEFINE_ERROR_STRING()

// x, y: [rows, h] contiguous of `dtype`; w: [h] of `dtype`; rstd: [rows]
// float32. Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, void* rstd,
                            int rows, int h, float eps, int dtype,
                            void* stream) {
  const dim3 grid(rows), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    rms_norm_fwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), static_cast<float*>(rstd), h, eps);
  } else if (dtype == kBFloat16) {
    rms_norm_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(rstd), h, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RETURN_LAUNCH_ERROR();
}

// x, g, dx: [rows, h] contiguous of `dtype`; w, dw: [h] of `dtype`; rstd:
// [rows] float32; dw_part: [parts, h] float32 scratch, parts <= rows.
// Launches the row pass and the column sum on `stream`, allocates nothing,
// does not synchronise.
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* g,
                            const void* rstd, void* dx, void* dw,
                            void* dw_part, int rows, int h, int parts,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_bwd<float>(x, w, g, rstd, dx, dw, dw_part, rows, h, parts,
                             s);
  if (dtype == kBFloat16)
    return launch_bwd<__nv_bfloat16>(x, w, g, rstd, dx, dw, dw_part, rows, h,
                                     parts, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
