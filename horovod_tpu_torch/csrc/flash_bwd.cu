// K2 and K3: the flash-attention backward for Hopper (sm_90a).
//
// K2 flash_bwd_dkv replaces horovod_tpu/ops/flash_attention.py:
// _bwd_dkv_kernel; K3 flash_bwd_dq replaces _bwd_dq_kernel. Both are what
// the TPU module's _flash_bwd_impl reaches (causal or not, with or without
// the per-key bias; no offsets: the backward of every flash call in
// llama_loss and bert_mlm_loss).
//
// Given the forward's residuals (q, k, v, lse) and the output cotangent
// do, with delta = rowsum(do * o) computed outside (f32), both recompute
//   s  = q k^T * D^-1/2, masked to -1e30, + bias[b, key] (if any)
//   p  = s > -1e30/2 ? exp(s - lse) : 0     (guarded on s, not on lse)
//   dp = do v^T
//   ds = p * (dp - delta) * D^-1/2
// and K2 accumulates dv += p^T do and dk += ds^T q over the q tiles of one
// key tile, K3 dq += ds k over the kv tiles of one q tile. The TPU
// kernels' numeric recipe is kept: f32 products and accumulators, p cast
// to do's dtype before p^T do, ds cast to q's (K2) or k's (K3) dtype
// before its product. dk and dv come out PER QUERY HEAD [B, H, Tk, D];
// the caller sums each kv head's n_rep query heads in f32 (as the TPU
// module does outside its kernel). GQA is native: query head h reads kv
// head h / n_rep, and k/v are never repeated in memory.
//
// What bounds them on an H100: at the train step's shape (B4 H16 Hkv4
// T2048 D128 bf16 causal) K2 does 4 and K3 3 products of 2*D flop per
// causal pair (~137 and ~103 GFLOP), against ~0.1 GB of bytes: both are
// bound by operations, 0.14 / 0.10 ms at 989 TFLOP/s.
//
// What this design does about it: no [T, T] tensor ever reaches device
// memory; each block keeps its pinned tiles (k, v for K2; q, do for K3)
// in shared memory and streams the other side once; the causal skip is
// the loop's bounds (K2 starts at the first q tile whose last row reaches
// the key tile, the TPU kernel's pl.when at :166; K3 stops at the causal
// limit, as K1 does). Any T is taken: ragged q rows and kv columns are
// masked in the kernel. The products run on plain FMA in f32 from shared
// memory (tiles held in f32, padded against bank conflicts), far below
// the tensor-core bound; an mma.sync / wgmma + TMA pipeline is later work.
//
// The bias variants (template flag HAS_BIAS: the same code without it)
// hold the key tile's bias in shared memory: once for K2's pinned keys,
// per kv tile for K3.
//
// Layout: q/do/dq [B, H, Tq, D]; k/v [B, Hkv, Tk, D]; dk/dv [B, H, Tk, D];
// lse and delta [B, H, Tq] f32; bias [B, Tk] f32 or null; all contiguous.
// One block of 256 threads per (64-key tile, head, batch) for K2 and per
// (64-row q tile, head, batch) for K3.

#include <stdint.h>

#include "common.cuh"

namespace {

using hvd_torch::from_f;
using hvd_torch::kNeg;
using hvd_torch::round_to;
using hvd_torch::to_f;

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 cell block

template <int D, bool HAS_BIAS>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, do tiles [64][D+1]; p, ds tiles [64][65]; lse, delta [64]
  // (+ the key tile's bias [64])
  return sizeof(float) * (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) +
                                  2 * BQ * (BK + 1) + 2 * BQ +
                                  (HAS_BIAS ? BK : 0));
}

template <int D, bool HAS_BIAS>
constexpr size_t dq_smem_bytes() {
  // q, do, k, v tiles [64][D+1]; ds tile [64][65]; lse, delta [64]
  // (+ the kv tile's bias [64])
  return sizeof(float) * (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) +
                                  BQ * (BK + 1) + 2 * BQ +
                                  (HAS_BIAS ? BK : 0));
}

// The bias of keys [k0, k0 + 64) of batch b into a [64] tile, 0 past Tk
// (those keys are masked anyway).
template <bool HAS_BIAS>
__device__ __forceinline__ void load_bias(float* dst, const float* bias,
                                          int b, int k0, int Tk) {
  if (HAS_BIAS && threadIdx.x < BK)
    dst[threadIdx.x] =
        k0 + threadIdx.x < Tk ? bias[(size_t)b * Tk + k0 + threadIdx.x] : 0.f;
}

// Copies rows [row0, row0 + 64) of a [rows, D] matrix into a [64][D+1]
// f32 tile, zero past `rows`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * LD + d] =
        (row0 + r < rows) ? to_f(src[(size_t)(row0 + r) * D + d]) : 0.f;
  }
}

// This thread's 4 x 4 cells of s = q k^T (unscaled) and dp = do v^T:
// q rows ty*4+i, keys tx+16*j.
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       int ty, int tx, float s[4][4],
                                       float dp[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = qs[(ty * 4 + i) * LD + d];
      da[i] = dos[(ty * 4 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = ks[(tx + 16 * j) * LD + d];
      vb[j] = vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
}

// p and ds of one cell, the TPU kernels' recipe (scale, then mask, then
// the key's bias; p guarded on s so a row with no valid key gives exact
// zeros).
__device__ __forceinline__ void p_ds(float s, float dp, bool valid,
                                     float kbias, float lse, float delta,
                                     float scale, float* p, float* ds) {
  const float sv = (valid ? s * scale : kNeg) + kbias;
  *p = sv > kNeg * 0.5f ? expf(sv - lse) : 0.f;
  *ds = *p * (dp - delta) * scale;
}

template <typename T, int D, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                         float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LDS = BK + 1;
  constexpr int NJ = D / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* ks = smem;               // [BK][LD]
  float* vs = ks + BK * LD;       // [BK][LD]
  float* qs = vs + BK * LD;       // [BQ][LD]
  float* dos = qs + BQ * LD;      // [BQ][LD]
  float* ps = dos + BQ * LD;      // [BQ][LDS] p in do's dtype
  float* dss = ps + BQ * LDS;     // [BQ][LDS] ds in q's dtype
  float* lse_s = dss + BQ * LDS;  // [BQ]
  float* dl_s = lse_s + BQ;       // [BQ]
  float* b_s = dl_s + BQ;         // [BK] the key tile's bias (HAS_BIAS)

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t qrow0 = (size_t)(b * H + h) * Tq;
  const T* qp = q + qrow0 * D;
  const T* dop = dout + qrow0 * D;
  const float* lsep = lse + qrow0;
  const float* dlp = delta + qrow0;

  load_tile<T, D>(ks, k + (size_t)(b * Hkv + hk) * Tk * D, k0, Tk);
  load_tile<T, D>(vs, v + (size_t)(b * Hkv + hk) * Tk * D, k0, Tk);
  load_bias<HAS_BIAS>(b_s, bias, b, k0, Tk);

  const int ty = tid / 16, tx = tid % 16;
  float dka[4][NJ], dva[4][NJ];  // key rows ty*4+i, columns tx+16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dka[i][j] = 0.f;
      dva[i][j] = 0.f;
    }

  // Causal skip as the loop's start: the first q tile whose last row
  // reaches this key tile's first key.
  const int iq_begin = causal ? k0 / BQ : 0;
  const int n_q_tiles = (Tq + BQ - 1) / BQ;
  for (int iq = iq_begin; iq < n_q_tiles; ++iq) {
    const int q0 = iq * BQ;
    __syncthreads();  // the last tile's readers are done with qs/dos/ps/dss
    load_tile<T, D>(qs, qp, q0, Tq);
    load_tile<T, D>(dos, dop, q0, Tq);
    if (tid < BQ) {
      const bool in = q0 + tid < Tq;
      lse_s[tid] = in ? lsep[q0 + tid] : 0.f;
      dl_s[tid] = in ? dlp[q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(qs, dos, ks, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int qpos = q0 + r, kpos = k0 + c;
        const bool valid =
            qpos < Tq && kpos < Tk && !(causal && kpos > qpos);
        float p, ds;
        p_ds(s[i][j], dp[i][j], valid, HAS_BIAS ? b_s[c] : 0.f, lse_s[r],
             dl_s[r], scale, &p, &ds);
        ps[r * LDS + c] = round_to<T>(p);
        dss[r * LDS + c] = round_to<T>(ds);
      }
    __syncthreads();

    // dv += p^T do and dk += ds^T q over this tile's q rows.
    for (int r = 0; r < BQ; ++r) {
      float pa[4], da[4], dob[NJ], qb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps[r * LDS + ty * 4 + i];
        da[i] = dss[r * LDS + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dob[j] = dos[r * LD + tx + 16 * j];
        qb[j] = qs[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dva[i][j] = fmaf(pa[i], dob[j], dva[i][j]);
          dka[i][j] = fmaf(da[i], qb[j], dka[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = ty * 4 + i;
    if (k0 + kr >= Tk) continue;
    const size_t row = ((size_t)(b * H + h) * Tk + k0 + kr) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[row + tx + 16 * j] = from_f<T>(dka[i][j]);
      dv[row + tx + 16 * j] = from_f<T>(dva[i][j]);
    }
  }
}

template <typename T, int D, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Hkv, int Tq, int Tk, float scale,
                        int causal) {
  constexpr int LD = D + 1;
  constexpr int LDS = BK + 1;
  constexpr int NJ = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][LD]
  float* dos = qs + BQ * LD;      // [BQ][LD]
  float* ks = dos + BQ * LD;      // [BK][LD]
  float* vs = ks + BK * LD;       // [BK][LD]
  float* dss = vs + BK * LD;      // [BQ][LDS] ds in k's dtype
  float* lse_s = dss + BQ * LDS;  // [BQ]
  float* dl_s = lse_s + BQ;       // [BQ]
  float* b_s = dl_s + BQ;         // [BK] the kv tile's bias (HAS_BIAS)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t qrow0 = (size_t)(b * H + h) * Tq;
  const T* kp = k + (size_t)(b * Hkv + hk) * Tk * D;
  const T* vp = v + (size_t)(b * Hkv + hk) * Tk * D;

  load_tile<T, D>(qs, q + qrow0 * D, q0, Tq);
  load_tile<T, D>(dos, dout + qrow0 * D, q0, Tq);
  if (tid < BQ) {
    const bool in = q0 + tid < Tq;
    lse_s[tid] = in ? lse[qrow0 + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[qrow0 + q0 + tid] : 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;  // rows ty*4+i, cols tx+16*j
  float dqa[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqa[i][j] = 0.f;

  // Causal whole-tile skip, as in K1: tiles past this q tile's last row
  // hold no valid key for any of its rows.
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's readers are done with ks/vs/dss
    load_tile<T, D>(ks, kp, k0, Tk);
    load_tile<T, D>(vs, vp, k0, Tk);
    load_bias<HAS_BIAS>(b_s, bias, b, k0, Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(qs, dos, ks, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const int qpos = q0 + r, kpos = k0 + c;
        const bool valid =
            qpos < Tq && kpos < Tk && !(causal && kpos > qpos);
        float p, ds;
        p_ds(s[i][j], dp[i][j], valid, HAS_BIAS ? b_s[c] : 0.f, lse_s[r],
             dl_s[r], scale, &p, &ds);
        dss[r * LDS + c] = round_to<T>(ds);
      }
    __syncthreads();

    // dq += ds k over this tile's keys.
    for (int c = 0; c < BK; ++c) {
      float da[4], kb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = dss[(ty * 4 + i) * LDS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kb[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dqa[i][j] = fmaf(da[i], kb[j], dqa[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Tq) continue;
    T* row = dq + (qrow0 + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f<T>(dqa[i][j]);
  }
}

template <typename T, int D, bool HAS_BIAS>
cudaError_t launch_dkv_variant(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout,
                               const void* lse, const void* delta, void* dk,
                               void* dv, int B, int H, int Hkv, int Tq,
                               int Tk, int causal, float scale,
                               cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D, HAS_BIAS>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, HAS_BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<T, D, HAS_BIAS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Hkv, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* bias, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int H,
                       int Hkv, int Tq, int Tk, int causal, float scale,
                       cudaStream_t stream) {
  return bias ? launch_dkv_variant<T, D, true>(q, k, v, bias, dout, lse,
                                               delta, dk, dv, B, H, Hkv, Tq,
                                               Tk, causal, scale, stream)
              : launch_dkv_variant<T, D, false>(q, k, v, bias, dout, lse,
                                                delta, dk, dv, B, H, Hkv, Tq,
                                                Tk, causal, scale, stream);
}

template <typename T, int D, bool HAS_BIAS>
cudaError_t launch_dq_variant(const void* q, const void* k, const void* v,
                              const void* bias, const void* dout,
                              const void* lse, const void* delta, void* dq,
                              int B, int H, int Hkv, int Tq, int Tk,
                              int causal, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D, HAS_BIAS>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D, HAS_BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, D, HAS_BIAS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, Hkv, Tq, Tk,
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const void* lse,
                      const void* delta, void* dq, int B, int H, int Hkv,
                      int Tq, int Tk, int causal, float scale,
                      cudaStream_t stream) {
  return bias ? launch_dq_variant<T, D, true>(q, k, v, bias, dout, lse, delta,
                                              dq, B, H, Hkv, Tq, Tk, causal,
                                              scale, stream)
              : launch_dq_variant<T, D, false>(q, k, v, bias, dout, lse,
                                               delta, dq, B, H, Hkv, Tq, Tk,
                                               causal, scale, stream);
}

}  // namespace

// Both entries return the CUDA error code of the launch (0 on success).
// D must be 16, 32, 64 or 128; is_bf16 selects bfloat16 over float32 for
// q, k, v, do and the outputs (lse, delta and the [B, Tk] bias, null for
// none, are always f32).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* bias, const void* dout,
                             const void* lse, const void* delta, void* dk,
                             void* dv, int B, int H, int Hkv, int Tq, int Tk,
                             int D, int causal, int is_bf16, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HVD_DKV_CASE(DV)                                                      \
  case DV:                                                                    \
    return is_bf16 ? launch_dkv<__nv_bfloat16, DV>(q, k, v, bias, dout, lse,  \
                                                   delta, dk, dv, B, H, Hkv,  \
                                                   Tq, Tk, causal, scale, s)  \
                   : launch_dkv<float, DV>(q, k, v, bias, dout, lse, delta,   \
                                           dk, dv, B, H, Hkv, Tq, Tk, causal, \
                                           scale, s);
  switch (D) {
    HVD_DKV_CASE(16)
    HVD_DKV_CASE(32)
    HVD_DKV_CASE(64)
    HVD_DKV_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HVD_DKV_CASE
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* bias, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            int B, int H, int Hkv, int Tq, int Tk, int D,
                            int causal, int is_bf16, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HVD_DQ_CASE(DV)                                                       \
  case DV:                                                                    \
    return is_bf16 ? launch_dq<__nv_bfloat16, DV>(q, k, v, bias, dout, lse,   \
                                                  delta, dq, B, H, Hkv, Tq,   \
                                                  Tk, causal, scale, s)       \
                   : launch_dq<float, DV>(q, k, v, bias, dout, lse, delta,    \
                                          dq, B, H, Hkv, Tq, Tk, causal,      \
                                          scale, s);
  switch (D) {
    HVD_DQ_CASE(16)
    HVD_DQ_CASE(32)
    HVD_DQ_CASE(64)
    HVD_DQ_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HVD_DQ_CASE
}
