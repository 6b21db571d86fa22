// Single-pass AdamW update for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/fused_ops.py::_adamw_kernel (launched by
// adamw_pallas): in float32,
//   m' = b1 m + (1 - b1) g,   v' = b2 v + (1 - b2) g^2,
//   p' = p (1 - lr wd) - lr (m' / bc1) / (sqrt(v' / bc2) + eps),
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t, written over p, m and v in place
// (the TPU kernel's input_output_aliases) and, when asked, p' rounded to a
// bf16 parameter copy in the same pass (the cast the JAX train step fuses
// into the same executable). The caller forms 1 - b1, 1 - b2 and 1 - lr wd
// in double precision and rounds each once, as the JAX package's XLA update
// does; the TPU kernel forms them in float32, where 1 - 0.999 loses 1.3e-5
// of its value to cancellation.
//
// Bound on this card: bytes. Per element the update reads p, m, v and g and
// writes p, m, v (and the bf16 copy) with some fifteen flops in between: 28
// bytes for a float32 master with a bf16 grad and copy, far below the ~295
// flops per byte at which the H100 stops being memory-bound.
//
// Design: one launch per tensor, a grid-stride loop over groups of four
// elements with 16-byte (float32) or 8-byte (bf16) vector loads when every
// pointer is aligned for them, and a scalar loop for the tail (or for the
// whole tensor when a pointer is not aligned). The TPU kernel's padding to
// (8, 128) tiles has no counterpart: any size is taken as it is.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM at most

// c1 = 1 - beta1, c2 = 1 - beta2, keep = 1 - lr * wd
struct Hyper {
  float lr, beta1, beta2, c1, c2, eps, keep, bc1, bc2;
};

__device__ __forceinline__ float update(float p, float& m, float& v, float g,
                                        const Hyper& a) {
  m = a.beta1 * m + a.c1 * g;
  v = a.beta2 * v + a.c2 * g * g;
  const float m_hat = m / a.bc1;
  const float v_hat = v / a.bc2;
  return p * a.keep - a.lr * m_hat / (sqrtf(v_hat) + a.eps);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void put4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

// elements [0, 4 * n_vec) in groups of four, then [4 * n_vec, n) one by one
template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(TP* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
             const TG* __restrict__ g, __nv_bfloat16* __restrict__ p_lowp,
             size_t n, size_t n_vec, Hyper a) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t first = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (size_t i = first; i < n_vec; i += stride) {
    const size_t e = 4 * i;
    const float4 pv = load4(p + e), gv = load4(g + e);
    float4 mv = load4(m + e), vv = load4(v + e);
    float4 out;
    out.x = update(pv.x, mv.x, vv.x, gv.x, a);
    out.y = update(pv.y, mv.y, vv.y, gv.y, a);
    out.z = update(pv.z, mv.z, vv.z, gv.z, a);
    out.w = update(pv.w, mv.w, vv.w, gv.w, a);
    put4(p + e, out);
    put4(m + e, mv);
    put4(v + e, vv);
    if (p_lowp != nullptr) put4(p_lowp + e, out);
  }
  for (size_t e = 4 * n_vec + first; e < n; e += stride) {
    float mv = m[e], vv = v[e];
    const float out = update(to_f32(p[e]), mv, vv, to_f32(g[e]), a);
    p[e] = from_f32<TP>(out);
    m[e] = mv;
    v[e] = vv;
    if (p_lowp != nullptr) p_lowp[e] = __float2bfloat16_rn(out);
  }
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename TP, typename TG>
int launch(void* p, void* m, void* v, const void* g, void* p_lowp, size_t n,
           const Hyper& a, cudaStream_t s) {
  const bool vec = aligned(p, 4 * sizeof(TP)) && aligned(m, 16) &&
                   aligned(v, 16) && aligned(g, 4 * sizeof(TG)) &&
                   (p_lowp == nullptr || aligned(p_lowp, 8));
  const size_t n_vec = vec ? n / 4 : 0;
  const size_t work = n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec;
  size_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks == 0) blocks = 1;
  adamw_kernel<TP, TG><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<TP*>(p), static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const TG*>(g), static_cast<__nv_bfloat16*>(p_lowp), n,
      n_vec, a);
  RETURN_LAUNCH_ERROR();
}

}  // namespace

DEFINE_ERROR_STRING()

// p: n elements of `p_dtype` (float32 master or bfloat16); m, v: n float32;
// g: n elements of `g_dtype`; p_lowp: n bfloat16 or null. All contiguous.
// Updates p, m, v (and writes p_lowp) in place on `stream`; allocates
// nothing, does not synchronise. c1 = 1 - beta1, c2 = 1 - beta2,
// keep = 1 - lr * weight_decay; bc1 = 1 - beta1^t, bc2 = 1 - beta2^t.
extern "C" int adamw_update(void* p, void* m, void* v, const void* g,
                            void* p_lowp, long long n, float lr, float beta1,
                            float beta2, float c1, float c2, float eps,
                            float keep, float bc1, float bc2, int p_dtype,
                            int g_dtype, void* stream) {
  const Hyper a{lr, beta1, beta2, c1, c2, eps, keep, bc1, bc2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t count = static_cast<size_t>(n);
  if (p_dtype == kFloat32 && g_dtype == kFloat32)
    return launch<float, float>(p, m, v, g, p_lowp, count, a, s);
  if (p_dtype == kFloat32 && g_dtype == kBFloat16)
    return launch<float, __nv_bfloat16>(p, m, v, g, p_lowp, count, a, s);
  if (p_dtype == kBFloat16 && g_dtype == kFloat32)
    return launch<__nv_bfloat16, float>(p, m, v, g, p_lowp, count, a, s);
  if (p_dtype == kBFloat16 && g_dtype == kBFloat16)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, m, v, g, p_lowp, count, a,
                                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
