// Adam's update for Hopper (sm_90a): one pass over a flat leaf.
//
// Replaces no TPU kernel. The JAX package writes Adam as one elementwise
// expression that XLA fuses into one loop (horovod_tpu/parallel/
// precision.py:118 _adam_leaf); its plain PyTorch counterpart
// (horovod_tpu_torch/ops/adam.py _adam_leaf) is about twenty whole-leaf
// kernels. This kernel is that expression as one pass, for the port's
// fused_adam, fused_master_adam and ZeRO-1's shard Adam
// (parallel/{precision,zero}.py).
//
// Two variants, each over n elements at any element offset:
// - moments in the parameter dtype: p, g, mu and nu all bf16 or all f32;
//   writes p_out (p itself, or ZeRO's separate shard), mu and nu;
// - f32 master: master, mu and nu f32, g in the compute dtype (bf16 or
//   f32); writes the master, mu, nu and the new master's compute-dtype
//   cast (the step's params).
//
// Bits: the plain version's. Every operation is the f32 operation torch
// runs, in its order, rounded once: mu2 = b1*mu + (1-b1)*g, nu2 = b2*nu +
// (1-b2)*g*g, update = lr*(mu2/bc1) / (sqrt(nu2/bc2) + eps), p2 = p -
// update, written with __fmul_rn/__fadd_rn/__fsub_rn (no contraction
// into an FMA), IEEE __fdiv_rn and __fsqrt_rn; the scalars arrive
// rounded to f32 as torch rounds a Python scalar; stores round to
// nearest even. bc1 and bc2 are the 0-d f32 device tensors of the bias
// corrections, read through a pointer: an apply never waits on the host.
//
// What bounds it on an H100: bytes. The bf16 variant reads p, g, mu, nu
// and writes p, mu, nu: 14 B a parameter; the master variant 28 B (f32
// master, mu, nu read and written, bf16 g read and cast written). A
// few dozen flops an element are far below the card's ridge. Design: a
// grid-stride loop over groups of 8 elements, each a 16-byte vector
// load of a bf16 array or two of an f32 one when every pointer is
// 16-byte aligned, neighbouring threads on neighbouring groups; the
// remainder, and every element of a misaligned call, take the scalar
// loop. A simple kernel first; its times are in PERF.md.

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int64_t kMaxBlocks = 4096;

template <typename T>
struct IsVoid {
  static constexpr bool value = false;
};
template <>
struct IsVoid<void> {
  static constexpr bool value = true;
};

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ float load1(const float* p, int64_t i) {
  return p[i];
}

__device__ __forceinline__ float load1(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store1(float* p, int64_t i, float v) {
  p[i] = v;
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, int64_t i,
                                       float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j],
                                                           v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// One element's step, in the plain version's order; p, m, v are updated.
__device__ __forceinline__ void step(float& p, float g, float& m, float& v,
                                     const Hyper& h, float bc1, float bc2) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float update = __fdiv_rn(
      __fmul_rn(h.lr, __fdiv_rn(m, bc1)),
      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps));
  p = __fsub_rn(p, update);
}

// TC is void for the variant without a cast.
template <typename TP, typename TG, typename TC>
__global__ void __launch_bounds__(kThreads)
adam_kernel(TP* p_out, const TP* p, const TG* g, TP* mu, TP* nu, TC* cast,
            int64_t n, Hyper h, const float* bc1_ptr, const float* bc2_ptr,
            bool vec) {
  constexpr bool kCast = !IsVoid<TC>::value;
  const float bc1 = *bc1_ptr, bc2 = *bc2_ptr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    const int64_t groups = n / kVec;
    for (int64_t i = tid; i < groups; i += stride) {
      const int64_t e = i * kVec;
      float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
      load8(p + e, pv);
      load8(g + e, gv);
      load8(mu + e, mv);
      load8(nu + e, vv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) step(pv[j], gv[j], mv[j], vv[j], h,
                                          bc1, bc2);
      store8(p_out + e, pv);
      store8(mu + e, mv);
      store8(nu + e, vv);
      if constexpr (kCast) store8(cast + e, pv);
    }
    head = groups * kVec;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    float pi = load1(p, i), mi = load1(mu, i), vi = load1(nu, i);
    step(pi, load1(g, i), mi, vi, h, bc1, bc2);
    store1(p_out, i, pi);
    store1(mu, i, mi);
    store1(nu, i, vi);
    if constexpr (kCast) store1(cast, i, pi);
  }
}

bool aligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <typename TP, typename TG, typename TC>
int launch(void* p_out, const void* p, const void* g, void* mu, void* nu,
           void* cast, int64_t n, const Hyper& h, const float* bc1,
           const float* bc2, cudaStream_t s) {
  const bool vec = aligned(p_out) && aligned(p) && aligned(g) &&
                   aligned(mu) && aligned(nu) && (!cast || aligned(cast));
  const int64_t work = vec ? (n + kVec - 1) / kVec : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  adam_kernel<TP, TG, TC><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<TP*>(p_out), static_cast<const TP*>(p),
      static_cast<const TG*>(g), static_cast<TP*>(mu),
      static_cast<TP*>(nu), static_cast<TC*>(cast), n, h, bc1, bc2, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16; cast_dtype -1 means no cast (the
// variant with moments in the parameter dtype, p_dtype == g_dtype);
// otherwise p_dtype is 0 (the f32 master) and cast_dtype == g_dtype.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a combination the kernel does not take.
extern "C" int adam_update(void* p_out, const void* p, const void* g,
                           void* mu, void* nu, void* cast, int64_t n,
                           int p_dtype, int g_dtype, int cast_dtype,
                           float lr, float b1, float omb1, float b2,
                           float omb2, float eps, const void* bc1,
                           const void* bc2, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Hyper h{lr, b1, omb1, b2, omb2, eps};
  const float* c1 = static_cast<const float*>(bc1);
  const float* c2 = static_cast<const float*>(bc2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cast_dtype < 0 && cast == nullptr && p_dtype == g_dtype) {
    if (p_dtype == 0)
      return launch<float, float, void>(p_out, p, g, mu, nu, nullptr, n, h,
                                        c1, c2, s);
    if (p_dtype == 1)
      return launch<__nv_bfloat16, __nv_bfloat16, void>(
          p_out, p, g, mu, nu, nullptr, n, h, c1, c2, s);
  } else if (cast != nullptr && p_dtype == 0 && cast_dtype == g_dtype) {
    if (g_dtype == 0)
      return launch<float, float, float>(p_out, p, g, mu, nu, cast, n, h,
                                         c1, c2, s);
    if (g_dtype == 1)
      return launch<float, __nv_bfloat16, __nv_bfloat16>(
          p_out, p, g, mu, nu, cast, n, h, c1, c2, s);
  }
  return (int)cudaErrorInvalidValue;
}
