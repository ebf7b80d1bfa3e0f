// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces horovod_tpu/ops/flash_attention.py:_fwd_kernel, the Pallas
// TPU kernel that _flash_fwd_impl reaches (causal or not, with or
// without the per-key bias; no offsets).
//
// Computes, per (batch, query head), online-softmax attention
//   o = softmax(q k^T * D^-1/2 + causal mask + bias) v,  lse = m + log(l)
// with GQA done natively (kv head = h / n_rep; k and v are never
// repeated in memory) and the TPU kernel's numeric recipe: f32 scores,
// running max m starting at -1e30, p cast UN-normalised to v's dtype
// before the PV product, f32 accumulation, o = acc / max(l, 1e-30) and
// exact zeros for a row whose max never left -1e30.
//
// What bounds it on an H100: at the llama_generate prefill shape
// (B16 H16 Hkv4 T128 D128 bf16) the 21 MB of q/k/v/o take ~6 us at
// 3.35 TB/s against ~1 us of causal matmul work at 989 TFLOP/s, so the
// shape is bound by bytes; at long prompts (T = 4096) the T^2 work
// dominates and the bound is the tensor-core rate.
//
// What this design does about it: it reads q once per block and each
// k/v tile once per query tile (no [T, T] score tensor ever reaches
// device memory), and stops the kv loop at the causal limit, which is
// the TPU kernel's whole-block skip. Any T is taken: the ragged last
// q and kv tiles are masked in the kernel (the TPU code instead picked
// a block size dividing T). The products run on plain FMA in f32 from
// shared memory. This is K1's f32 route; bf16 runs on the tensor cores
// in csrc/flash_fwd_wgmma.cu (ops/flash_attention.py flash_fwd_route),
// and this kernel's bf16 instantiation is kept as that kernel's
// yardstick (taken only when asked for by name).
//
// The bias variant (template flag HAS_BIAS: the same code without it)
// adds bias[b, key] to every score after the mask, from a 64-float tile
// loaded into shared memory with each kv tile.
//
// Layout: q/o [B, H, T, D], k/v [B, Hkv, Tk, D], lse [B, H, T] f32, bias
// [B, Tk] f32 or null, all contiguous. One block of 256 threads per
// (64-row q tile, head, batch).

#include <stdint.h>

#include "common.cuh"

namespace {

using hvd_torch::from_f;
using hvd_torch::kNeg;
using hvd_torch::round_to;
using hvd_torch::to_f;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4-row tile

template <int D, bool HAS_BIAS>
constexpr size_t smem_bytes() {
  // q, k, v tiles [64][D+1] + score tile [64][65] + m, l, corr [64]
  // (+ the kv tile's bias [64])
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) +
                                  BQ * (BK + 1) + 3 * BQ +
                                  (HAS_BIAS ? BK : 0));
}

template <typename T, int D, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int H,
                     int Hkv, int Tq, int Tk, float scale, int causal) {
  constexpr int LD = D + 1;     // padded rows: no shared-memory bank clash
  constexpr int LDS = BK + 1;
  constexpr int NJ = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][LD]
  float* ks = qs + BQ * LD;     // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* ss = vs + BK * LD;     // [BQ][LDS] scores, then rounded p
  float* m_s = ss + BQ * LDS;   // [BQ] running max
  float* l_s = m_s + BQ;        // [BQ] running sum
  float* c_s = l_s + BQ;        // [BQ] this tile's rescale exp(m_old-m_new)
  float* b_s = c_s + BQ;        // [BK] this kv tile's bias (HAS_BIAS)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qp = q + (size_t)(b * H + h) * Tq * D;
  const T* kp = k + (size_t)(b * Hkv + hk) * Tk * D;
  const T* vp = v + (size_t)(b * Hkv + hk) * Tk * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[r * LD + d] = (q0 + r < Tq) ? to_f(qp[(size_t)(q0 + r) * D + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;  // rows ty*4+i, cols tx+16*j
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // Causal whole-tile skip: tiles past this q tile's last row hold no
  // valid key for any of its rows.
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's readers are done with ks/vs/ss
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Tk;
      ks[r * LD + d] = in ? to_f(kp[(size_t)(k0 + r) * D + d]) : 0.f;
      vs[r * LD + d] = in ? to_f(vp[(size_t)(k0 + r) * D + d]) : 0.f;
    }
    if (HAS_BIAS && tid < BK)
      b_s[tid] = k0 + tid < Tk ? bias[(size_t)b * Tk + k0 + tid] : 0.f;
    __syncthreads();

    // s = q k^T * scale, masked to -1e30, plus the bias (scale first, then
    // mask, then bias, as the TPU kernel does).
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int kpos = k0 + c;
        float s = sc[i][j] * scale;
        if (kpos >= Tk || (causal && kpos > q0 + r)) s = kNeg;
        if constexpr (HAS_BIAS) s += b_s[c];
        ss[r * LDS + c] = s;
      }
    __syncthreads();

    // Online softmax, four neighbouring lanes per row.
    {
      const int r = tid / 4, sub = tid % 4;
      float mx = kNeg;
      for (int c = sub; c < BK; c += 4) mx = fmaxf(mx, ss[r * LDS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = sub; c < BK; c += 4) {
        const float p = expf(ss[r * LDS + c] - m_new);
        sum += p;
        ss[r * LDS + c] = round_to<T>(p);  // un-normalised p in v's dtype
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (sub == 0) {
        const float corr = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v, f32 accumulation.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < BK; ++c) {
      float pa[4], vb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ss[(ty * 4 + i) * LDS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vb[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Tq) continue;
    const float m = m_s[r];
    const float l = fmaxf(l_s[r], 1e-30f);
    const bool valid = m > kNeg / 2;
    T* orow = o + ((size_t)(b * H + h) * Tq + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      orow[tx + 16 * j] = from_f<T>(valid ? acc[i][j] / l : 0.f);
    if (tx == 0) lse[(size_t)(b * H + h) * Tq + q0 + r] = m + logf(l);
  }
}

template <typename T, int D, bool HAS_BIAS>
cudaError_t launch_variant(const void* q, const void* k, const void* v,
                           const void* bias, void* o, void* lse, int B, int H,
                           int Hkv, int Tq, int Tk, int causal, float scale,
                           cudaStream_t stream) {
  const size_t smem = smem_bytes<D, HAS_BIAS>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, HAS_BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D, HAS_BIAS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), H, Hkv, Tq, Tk, scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, void* lse, int B, int H,
                   int Hkv, int Tq, int Tk, int causal, float scale,
                   cudaStream_t stream) {
  return bias ? launch_variant<T, D, true>(q, k, v, bias, o, lse, B, H, Hkv,
                                           Tq, Tk, causal, scale, stream)
              : launch_variant<T, D, false>(q, k, v, bias, o, lse, B, H, Hkv,
                                            Tq, Tk, causal, scale, stream);
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success). D must be
// 16, 32, 64 or 128; is_bf16 selects bfloat16 over float32 for q, k, v
// and o; bias is the [B, Tk] f32 per-key bias, or null for none.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* o, void* lse, int B, int H,
                         int Hkv, int Tq, int Tk, int D, int causal,
                         int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HVD_FLASH_CASE(DV)                                                   \
  case DV:                                                                   \
    return is_bf16 ? launch<__nv_bfloat16, DV>(q, k, v, bias, o, lse, B, H,  \
                                                Hkv, Tq, Tk, causal, scale,  \
                                                s)                           \
                   : launch<float, DV>(q, k, v, bias, o, lse, B, H, Hkv, Tq, \
                                       Tk, causal, scale, s);
  switch (D) {
    HVD_FLASH_CASE(16)
    HVD_FLASH_CASE(32)
    HVD_FLASH_CASE(64)
    HVD_FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HVD_FLASH_CASE
}
