// K5 and K6: ragged grouped matrix products for Hopper (sm_90a).
//
// K5 grouped_mm replaces horovod_tpu/ops/grouped_moe.py:137 _gmm_tpu
// (megablox gmm): lhs [M, K] holds rows grouped contiguously by expert,
// group e owning rows [offsets[e], offsets[e + 1]), and
//   out[rows of e] = lhs[rows of e] @ rhs[e]          rhs [E, K, N]
// With transpose_rhs (a compile-time flag) the same kernel is the first
// half of K6, :151 _gmm_tpu_bwd's dlhs = gmm(grad, rhs, transpose_rhs=True):
//   dlhs[rows of e] = grad[rows of e] @ rhs[e]^T      grad [M, N] -> [M, K]
// K6's second half, grouped_tgmm, replaces megablox tgmm:
//   drhs[e] = lhs[rows of e]^T @ grad[rows of e]      -> [E, K, N]
// an f32 sum over the group's rows, exactly zero for an empty group.
// Products and sums are f32 (bf16 operands are exact in f32); each output
// is rounded once to the operands' dtype (bf16 or f32).
//
// Group boundaries come from the device: the caller passes the E + 1
// offsets (0, then the cumsum of group_sizes, computed on the card), so no
// launch waits on the host. A gmm block finds its own (group, row tile)
// from them: the grid has the upper bound ceil(M/128) + E - 1 of row-tile
// visits (every non-empty group visits the tiles its rows touch, so a
// tile that straddles a boundary is visited once per group in it), and a
// block past the visits this routing needs exits at once. Each visit
// masks rows outside its group, so boundaries need no alignment; rows of
// [M, N] that no group covers are left as the caller initialised them.
// tgmm runs one block per (group, 128-row K tile, 128-column N tile).
//
// What bounds them on an H100: at the MoE train shape (one microbatch of
// B2 x T2048 tokens, top-2 of 4 experts: M = 8192 routed rows, d_model
// 2048, d_ff 4096, bf16) each product is 2 * 8192 * 2048 * 4096 = 137
// GFLOP against ~0.17 GB of operands: bound by operations, 0.139 ms at
// 989 TFLOP/s (the bytes take 0.05 ms).
//
// What this design does about it: a tile of 128 x 128 outputs per block,
// 256 threads each holding an 8 x 8 block of f32 accumulators, operands
// staged through shared memory in 16-deep slabs converted to f32, so every
// shared-memory load feeds 16 FMAs. It runs on plain FMA at the f32 rate
// (67 TFLOP/s peak), far below the tensor-core bound, but is right on
// every ragged layout and width. K5 runs here for both dtypes; K6 runs
// here for f32 only: its bf16 route is csrc/grouped_mm_wgmma.cu
// (ops/grouped_moe.py grouped_bwd_route), and the bf16 instantiations of
// dlhs and tgmm are kept as that kernel's yardstick (taken only when
// asked for by name).
//
// Layout: lhs [M, K], grad [M, N], rhs [E, K, N], out [M, N] (gmm) or
// [M, K] (dlhs) or [E, K, N] (tgmm), offsets [E + 1] int32; all contiguous.

#include <stdint.h>

#include "common.cuh"

namespace {

using hvd_torch::from_f;
using hvd_torch::to_f;

constexpr int BT = 128;       // output rows and columns per tile
constexpr int BK = 16;        // contraction depth of a shared-memory slab
constexpr int THREADS = 256;  // 16 x 16 threads, each an 8 x 8 cell block
constexpr int LDS = BT + 4;   // padded row of a [BK][BT] slab

// S[kk][r] = src[(row0 + r) * ld + k0 + kk] for r < 128, kk < 16: a slab
// whose contraction index runs along the source's rows. Zero where the
// source row is outside [row_lo, row_hi) or the column reaches kmax.
template <typename T>
__device__ __forceinline__ void load_rows(float* S, const T* src, int ld,
                                          int row0, int row_lo, int row_hi,
                                          int k0, int kmax) {
  const int r = threadIdx.x / 2;
  const int kk0 = (threadIdx.x % 2) * 8;
  const int row = row0 + r;
  const bool row_in = row >= row_lo && row < row_hi;
  const T* p = src + (size_t)(row_in ? row : 0) * ld;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + kk0 + i;
    S[(kk0 + i) * LDS + r] = (row_in && k < kmax) ? to_f(p[k]) : 0.f;
  }
}

// S[kk][c] = src[(k0 + kk) * ld + c0 + c] for kk < 16, c < 128: a slab
// whose contraction index runs down the source's rows. Zero where the
// source row is outside [k_lo, k_hi) or the column reaches cmax.
template <typename T>
__device__ __forceinline__ void load_cols(float* S, const T* src, int ld,
                                          int k0, int k_lo, int k_hi, int c0,
                                          int cmax) {
  const int kk = threadIdx.x / 16;
  const int cc = (threadIdx.x % 16) * 8;
  const int row = k0 + kk;
  const bool row_in = row >= k_lo && row < k_hi;
  const T* p = src + (size_t)(row_in ? row : 0) * ld;
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + cc + i;
    v[i] = (row_in && c < cmax) ? to_f(p[c]) : 0.f;
  }
  float4* dst = reinterpret_cast<float4*>(S + kk * LDS + cc);
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// acc[i][j] += sum_kk A[kk][row i] * B[kk][col j] over one slab; this
// thread's rows are ty*4 + {0..3} and 64 + ty*4 + {0..3}, its columns
// tx*4 + {0..3} and 64 + tx*4 + {0..3}.
__device__ __forceinline__ void slab_fma(const float* As, const float* Bs,
                                         int ty, int tx, float acc[8][8]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * LDS + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * LDS + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * LDS + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * LDS + 64 + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ int cell(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

// Group g's rows, clamped to [0, M) so that no offsets can make a block
// read or write outside the matrices.
__device__ __forceinline__ void group_rows(const int* offsets, int g, int M,
                                           int* lo, int* hi) {
  *lo = min(max(offsets[g], 0), M);
  *hi = min(max(offsets[g + 1], *lo), M);
}

template <typename T, bool kTransposeRhs>
__global__ void __launch_bounds__(THREADS, 2)
    gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               const int* __restrict__ offsets, T* __restrict__ out, int M,
               int Kc, int Nc, int E) {
  __shared__ __align__(16) float As[BK * LDS];
  __shared__ __align__(16) float Bs[BK * LDS];

  // This block's visit: the groups in order, each over the row tiles its
  // rows touch.
  int e = -1, m0 = 0, lo = 0, hi = 0;
  for (int g = 0, seen = 0; g < E; ++g) {
    int glo, ghi;
    group_rows(offsets, g, M, &glo, &ghi);
    if (ghi <= glo) continue;
    const int first = glo / BT;
    const int n_tiles = (ghi - 1) / BT - first + 1;
    if ((int)blockIdx.x < seen + n_tiles) {
      e = g;
      m0 = (first + (int)blockIdx.x - seen) * BT;
      lo = max(glo, m0);
      hi = min(ghi, m0 + BT);
      break;
    }
    seen += n_tiles;
  }
  if (e < 0) return;  // past the visits this routing needs

  const int n0 = blockIdx.y * BT;
  const T* rhs_e = rhs + (size_t)e * Kc * Nc;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kc; k0 += BK) {
    __syncthreads();  // the last slab's readers are done with As/Bs
    load_rows<T>(As, lhs, Kc, m0, lo, hi, k0, Kc);
    if (kTransposeRhs)  // rhs[e] is [Nc, Kc]: B[k][n] = rhs_e[n * Kc + k]
      load_rows<T>(Bs, rhs_e, Kc, n0, 0, Nc, k0, Kc);
    else  // rhs[e] is [Kc, Nc]
      load_cols<T>(Bs, rhs_e, Nc, k0, 0, Kc, n0, Nc);
    __syncthreads();
    slab_fma(As, Bs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + cell(ty, i);
    if (row < lo || row >= hi) continue;
    T* o = out + (size_t)row * Nc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + cell(tx, j);
      if (col < Nc) o[col] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    tgmm_kernel(const T* __restrict__ lhs, const T* __restrict__ grad,
                const int* __restrict__ offsets, T* __restrict__ out, int M,
                int Kd, int Nd) {
  __shared__ __align__(16) float As[BK * LDS];
  __shared__ __align__(16) float Bs[BK * LDS];

  const int e = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const int n0 = blockIdx.z * BT;
  int lo, hi;
  group_rows(offsets, e, M, &lo, &hi);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // The contraction runs over the group's rows, 16 at a time.
  for (int r0 = lo; r0 < hi; r0 += BK) {
    __syncthreads();
    load_cols<T>(As, lhs, Kd, r0, lo, hi, k0, Kd);
    load_cols<T>(Bs, grad, Nd, r0, lo, hi, n0, Nd);
    __syncthreads();
    slab_fma(As, Bs, ty, tx, acc);
  }

  T* out_e = out + (size_t)e * Kd * Nd;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + cell(ty, i);
    if (k >= Kd) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + cell(tx, j);
      if (n < Nd) out_e[(size_t)k * Nd + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_gmm(const void* lhs, const void* rhs, const void* offsets,
                       void* out, int M, int Kc, int Nc, int E,
                       int transpose_rhs, cudaStream_t stream) {
  const dim3 grid((M + BT - 1) / BT + E - 1, (Nc + BT - 1) / BT);
  const T* a = static_cast<const T*>(lhs);
  const T* b = static_cast<const T*>(rhs);
  const int* offs = static_cast<const int*>(offsets);
  T* o = static_cast<T*>(out);
  if (transpose_rhs)
    gmm_kernel<T, true><<<grid, THREADS, 0, stream>>>(a, b, offs, o, M, Kc,
                                                      Nc, E);
  else
    gmm_kernel<T, false><<<grid, THREADS, 0, stream>>>(a, b, offs, o, M, Kc,
                                                       Nc, E);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tgmm(const void* lhs, const void* grad,
                        const void* offsets, void* out, int M, int Kd, int Nd,
                        int E, cudaStream_t stream) {
  const dim3 grid(E, (Kd + BT - 1) / BT, (Nd + BT - 1) / BT);
  tgmm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(grad),
      static_cast<const int*>(offsets), static_cast<T*>(out), M, Kd, Nd);
  return cudaGetLastError();
}

}  // namespace

// Both entries return the CUDA error code of the launch (0 on success).
// is_bf16 selects bfloat16 over float32 for every matrix; offsets are
// int32. The caller launches only when M, Kc/Kd, Nc/Nd and E are > 0.

// out [M, Nc] = per group lhs [M, Kc] @ rhs[e]: rhs is [E, Kc, Nc], or
// [E, Nc, Kc] read transposed when transpose_rhs is set.
extern "C" int grouped_mm(const void* lhs, const void* rhs,
                          const void* offsets, void* out, int M, int Kc,
                          int Nc, int E, int transpose_rhs, int is_bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_gmm<__nv_bfloat16>(lhs, rhs, offsets, out, M, Kc,
                                             Nc, E, transpose_rhs, s)
                 : launch_gmm<float>(lhs, rhs, offsets, out, M, Kc, Nc, E,
                                     transpose_rhs, s);
}

// out [E, Kd, Nd] = per group lhs[rows]^T @ grad[rows], lhs [M, Kd] and
// grad [M, Nd].
extern "C" int grouped_tgmm(const void* lhs, const void* grad,
                            const void* offsets, void* out, int M, int Kd,
                            int Nd, int E, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_tgmm<__nv_bfloat16>(lhs, grad, offsets, out, M, Kd,
                                              Nd, E, s)
                 : launch_tgmm<float>(lhs, grad, offsets, out, M, Kd, Nd, E,
                                      s);
}
