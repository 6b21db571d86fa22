// RMSNorm forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/fused_ops.py::_rms_fwd_kernel (launched by
// _rms_fwd_call): y = x * rsqrt(mean(x^2) + eps) * w, computed in float32
// and rounded to the output type once, plus rstd in float32 per row.
//
// Bound on this card: bytes. Each element is read once and written once
// with four flops in between, far below the ~295 flops per byte at which
// the H100 stops being memory-bound.
//
// Design: one block of 256 threads per row, so a row of any width is
// reduced without padding rows (the TPU kernel padded rows to a multiple of
// 8 for its (8, 128) tiling). The sum of squares accumulates in float32 per
// thread, then across the warp with shuffles and across the block's eight
// warps through shared memory. The second pass re-reads the row, which an
// 8-16 KB row keeps in L1, so device memory sees each byte once. Loads are
// scalar and coalesced; vector loads are left for a later change.
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
