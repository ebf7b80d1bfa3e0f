// K5 and K6 on the tensor cores: the ragged grouped matmul and its
// backward for bf16 on Hopper (sm_90a). The f32 route stays
// csrc/grouped_mm.cu.
//
// K5 replaces horovod_tpu/ops/grouped_moe.py:137 _gmm_tpu (megablox gmm),
// K6 :151 _gmm_tpu_bwd (megablox gmm with a transposed rhs, then tgmm),
// with csrc/grouped_mm.cu's contract:
//   out[rows of e]  = lhs[rows of e] @ rhs[e]      lhs [M, K], rhs [E, K, N]
//   dlhs[rows of e] = grad[rows of e] @ rhs[e]^T   grad [M, N]
//   drhs[e] = lhs[rows of e]^T @ grad[rows of e]   -> [E, K, N]
// group e owning the next sizes[e] rows after the groups before it, read
// from the device group sizes (no host sync). Products are exact bf16 x
// bf16 in f32, sums f32, each output rounded once to bf16; rows no group
// covers are 0 and an empty group's drhs is exactly 0.
//
// What bounds them on an H100: at the MoE train shape (M = 8192 routed
// rows, d_model 2048, d_ff 4096) each is 137 GFLOP, 0.139 ms at 989
// TFLOP/s, against ~0.1 GB of operands (0.03 ms): operations. At decode
// (M = 32 routed rows) K5 computes almost nothing and must stream all of
// rhs, 67 MB at 3.35 TB/s = 0.020 ms: bytes. The FMA kernels ran the
// train shapes at 25-39 TFLOP/s.
//
// What this design does about it: each block computes a 128 x 128 output
// tile on wgmma with f32 accumulators in registers: two consumer
// warpgroups of 64 rows each, and one producer warp whose lane 0 keeps a
// four-stage ring of 64-deep operand tiles full by TMA (mbarriers: full =
// bytes landed, empty = both warpgroups done). Each warpgroup keeps one
// wgmma group in flight while it waits for the next stage.
// - gmm and dlhs share one kernel (gmm_rows_wgmma_kernel): blocks find
//   their (group, row tile) visit from the group sizes; a tile that
//   straddles a group boundary loads its neighbours' rows (row r of the
//   output depends only on row r of lhs) and the store is masked to the
//   group; a warpgroup with no row of the group skips its products.
//   Consecutive blocks share a row tile and walk the N tiles, so one
//   expert's rhs stays in L2 across a wave. lhs is K-major; gmm reads
//   rhs [E, K, N] MN-major (the transpose bit, two 64-column boxes a
//   stage), dlhs reads it K-major.
// - Small M (decode): visits x N tiles may not fill the 132 SMs, and
//   each block streams up to 1 MB of rhs[e] for a few live rows. The
//   caller then cuts the contraction into S 64-aligned splits
//   (ops/grouped_moe.py _gmm_split_k, from the shapes alone); split z
//   writes f32 partials to a [S, M, N] workspace and a second kernel sums
//   them in split order (no atomics: the same bits on every launch) and
//   rounds once.
// - tgmm: both operands are MN-major (the contraction runs down the rows),
//   read with wgmma's transpose bits. The contraction starts at the
//   group's first row (TMA takes any coordinate); the last stage may
//   reach into the next group, so each warpgroup zeroes those rows of its
//   own lhs tile before its products (TMA zero-fills only past M).
//
// Layout: lhs [M, K], grad [M, N], rhs [E, K, N] bf16, sizes [E] int32,
// all contiguous; K and N multiples of 8 (TMA's 16-byte rows).

#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hvd_torch;

constexpr int BT = 128;                  // output rows and columns per tile
constexpr int BC = 64;                   // contraction depth of a stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int TILE = BT * BC * 2;        // 16 KB operand tile per stage
constexpr int HALF = TILE / 2;           // [64][64] box
constexpr int STAGE = 2 * TILE;          // A tile, then B tile
constexpr int BARS = STAGES * STAGE;     // full[STAGES], empty[STAGES]
constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;

// Rows [lo, hi) of the group whose rows start at `start` (clamped to M),
// and the next group's start.
__device__ __forceinline__ int group_rows(const int* sizes, int g, int start,
                                          int M, int* lo, int* hi) {
  *lo = min(max(start, 0), M);
  *hi = min(max(start + sizes[g], *lo), M);
  return start + sizes[g];
}

// The rows some group covers: [0, min(sum of sizes, M)).
__device__ __forceinline__ int covered_rows(const int* sizes, int E, int M) {
  int total = 0;
  for (int g = 0; g < E; ++g) total += sizes[g];
  return min(max(total, 0), M);
}

// The block's shared memory, 1024-byte aligned, and its barriers, set up
// by thread 0 (every thread of the block must call it).
__device__ __forceinline__ uint8_t* ring_setup(uint8_t* raw, uint64_t** full,
                                               uint64_t** empty) {
  uint8_t* smem = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  *full = reinterpret_cast<uint64_t*>(smem + BARS);
  *empty = *full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(*full + s, 1);
      mbar_init(*empty + s, CONSUMERS / 32);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  return smem;
}

// Producer side of stage `i` of the ring: wait until the consumers freed
// its slot, then announce STAGE bytes on its full barrier.
__device__ __forceinline__ uint8_t* produce(uint8_t* smem, uint64_t* full,
                                            uint64_t* empty, int i) {
  const int s = i % STAGES;
  if (i >= STAGES) mbar_wait(empty + s, ((i / STAGES) - 1) & 1);
  mbar_expect_tx(full + s, STAGE);
  return smem + s * STAGE;
}

// Consumer side: after the products of stage i are issued, wait for those
// of stage i - 1 and free its slot (one arrival per warp).
__device__ __forceinline__ void release_previous(uint64_t* empty, int i) {
  wgmma_wait<1>();
  if (i > 0 && threadIdx.x % 32 == 0) mbar_arrive(empty + (i - 1) % STAGES);
}

// out[rows of e] = lhs[rows of e] @ rhs[e] over the contraction range of
// split blockIdx.z: K5 (TRANSPOSE_RHS = false, rhs [E, Kc, Nc], N
// contiguous, read MN-major) or K6's dlhs (true, rhs [E, Nc, Kc] read
// K-major). With one split the bf16 result goes to `out`; with S > 1
// split z writes its f32 partial to ws[z] for gmm_split_reduce_kernel.
template <bool TRANSPOSE_RHS>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_rows_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                          const __grid_constant__ CUtensorMap bmap,
                          const int* __restrict__ sizes,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ ws, int M, int Kc, int Nc,
                          int E, int k_per) {
  extern __shared__ uint8_t smem_raw[];
  // This block's visit: the groups in order, each over the row tiles its
  // rows touch (blockIdx.y), and an N tile (blockIdx.x).
  int e = -1, m0 = 0, lo = 0, hi = 0;
  for (int g = 0, seen = 0, start = 0; g < E; ++g) {
    int glo, ghi;
    start = group_rows(sizes, g, start, M, &glo, &ghi);
    if (ghi <= glo) continue;
    const int first = glo / BT;
    const int n_tiles = (ghi - 1) / BT - first + 1;
    if ((int)blockIdx.y < seen + n_tiles) {
      e = g;
      m0 = (first + (int)blockIdx.y - seen) * BT;
      lo = max(glo, m0);
      hi = min(ghi, m0 + BT);
      break;
    }
    seen += n_tiles;
  }
  if (e < 0) return;  // past the visits this routing needs
  const int n0 = blockIdx.x * BT;
  const int k_begin = blockIdx.z * k_per;  // a multiple of BC
  const int n_k = (min(Kc, k_begin + k_per) - k_begin + BC - 1) / BC;

  uint64_t *full, *empty;
  uint8_t* smem = ring_setup(smem_raw, &full, &empty);
  if (threadIdx.x >= CONSUMERS) {  // producer warp: lane 0 issues TMA
    if (threadIdx.x == CONSUMERS)
      for (int i = 0; i < n_k; ++i) {
        uint8_t* st = produce(smem, full, empty, i);
        uint64_t* bar = full + i % STAGES;
        const int k = k_begin + i * BC;
        tma_load_2d(st, &amap, bar, k, m0);
        if (TRANSPOSE_RHS) {
          tma_load_3d(st + TILE, &bmap, bar, k, n0, e);
        } else {  // [BC rows of K][64 columns of N], twice
          tma_load_3d(st + TILE, &bmap, bar, n0, k, e);
          tma_load_3d(st + TILE + HALF, &bmap, bar, n0 + 64, k, e);
        }
      }
    return;
  }

  const int w = threadIdx.x / 128, tw = threadIdx.x % 128;
  // A warpgroup whose 64 rows hold none of the group's only frees the
  // ring's slots (small M: the routed rows fill a fraction of a tile).
  if (m0 + 64 * w >= hi || m0 + 64 * w + 64 <= lo) {
    for (int i = 0; i < n_k; ++i) {
      mbar_wait(full + i % STAGES, (i / STAGES) & 1);
      if (tw % 32 == 0) mbar_arrive(empty + i % STAGES);
    }
    return;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int i = 0; i < n_k; ++i) {
    mbar_wait(full + i % STAGES, (i / STAGES) & 1);
    const uint8_t* st = smem + (i % STAGES) * STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint64_t da = wgmma_desc(st + w * HALF + kk * 32, 16, 1024);
      if (TRANSPOSE_RHS)
        wgmma_m64n128k16_ss<0, 0>(
            acc, da, wgmma_desc(st + TILE + kk * 32, 16, 1024), 1);
      else  // rhs MN-major: the next 64 columns lie HALF on (LBO)
        wgmma_m64n128k16_ss<0, 1>(
            acc, da, wgmma_desc(st + TILE + kk * 2048, HALF, 1024), 1);
    }
    wgmma_commit();
    release_previous(empty, i);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int row_a = m0 + 64 * w + 16 * (tw / 32) + (tw % 32) / 4;
  const int col = n0 + 2 * (tw % 4);
  float* part = ws + (size_t)blockIdx.z * M * Nc;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row < lo || row >= hi) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (col + 8 * j >= Nc) continue;
      const float x = acc[4 * j + 2 * r], y = acc[4 * j + 2 * r + 1];
      const size_t at = (size_t)row * Nc + col + 8 * j;
      if (gridDim.z == 1)
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(x, y);
      else
        *reinterpret_cast<float2*>(part + at) = make_float2(x, y);
    }
  }
}

// out = the S split partials of ws summed in split order (the same bits
// on every launch), rounded once to bf16; rows no group covers are 0.
// With S = 0 it only writes those zeros (rows past the covered ones).
__global__ void gmm_split_reduce_kernel(const float* __restrict__ ws,
                                        const int* __restrict__ sizes,
                                        __nv_bfloat16* __restrict__ out,
                                        int M, int Nc, int E, int S) {
  const int covered = covered_rows(sizes, E, M);
  const size_t pairs = (size_t)M * Nc / 2, plane = (size_t)M * Nc;
  const size_t first = S ? 0 : (size_t)covered * Nc / 2;
  for (size_t p = first + blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       p < pairs; p += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(2 * p / Nc);
    float2 sum = make_float2(0.f, 0.f);
    if (row < covered)
      for (int z = 0; z < S; ++z) {
        const float2 x = reinterpret_cast<const float2*>(ws + z * plane)[p];
        sum.x += x.x;
        sum.y += x.y;
      }
    reinterpret_cast<__nv_bfloat162*>(out)[p] =
        __floats2bfloat162_rn(sum.x, sum.y);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    gmm_tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                          const __grid_constant__ CUtensorMap bmap,
                          const int* __restrict__ sizes,
                          __nv_bfloat16* __restrict__ out, int M, int Kd,
                          int Nd) {
  extern __shared__ uint8_t smem_raw[];
  const int n0 = blockIdx.x * BT, k0 = blockIdx.y * BT, e = blockIdx.z;
  int lo, hi, start = 0;
  for (int g = 0; g < e; ++g) start += sizes[g];
  group_rows(sizes, e, start, M, &lo, &hi);
  const int n_r = (hi - lo + BC - 1) / BC;  // 0 for an empty group

  uint64_t *full, *empty;
  uint8_t* smem = ring_setup(smem_raw, &full, &empty);
  if (threadIdx.x >= CONSUMERS) {  // producer warp: lane 0 issues TMA
    if (threadIdx.x == CONSUMERS)
      for (int i = 0; i < n_r; ++i) {
        uint8_t* st = produce(smem, full, empty, i);
        uint64_t* bar = full + i % STAGES;
        const int r = lo + i * BC;
        tma_load_2d(st, &amap, bar, k0, r);
        tma_load_2d(st + HALF, &amap, bar, k0 + 64, r);
        tma_load_2d(st + TILE, &bmap, bar, n0, r);
        tma_load_2d(st + TILE + HALF, &bmap, bar, n0 + 64, r);
      }
    return;
  }

  // Warpgroup w: output rows k0 + 64 w .. + 63, i.e. the lhs box at
  // st + w * HALF; grad's two 64-column boxes lie HALF apart (LBO).
  const int w = threadIdx.x / 128, tw = threadIdx.x % 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int i = 0; i < n_r; ++i) {
    mbar_wait(full + i % STAGES, (i / STAGES) & 1);
    uint8_t* st = smem + (i % STAGES) * STAGE;
    const int live = hi - (lo + i * BC);  // rows of this stage in the group
    if (live < BC) {  // the last stage: zero the next group's rows
      uint4* a = reinterpret_cast<uint4*>(st + w * HALF + live * 128);
      for (int j = tw; j < (BC - live) * 8; j += 128)
        a[j] = make_uint4(0, 0, 0, 0);
      fence_proxy_async();
      named_barrier(1 + w, 128);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      wgmma_m64n128k16_ss<1, 1>(
          acc, wgmma_desc(st + w * HALF + kk * 2048, HALF, 1024),
          wgmma_desc(st + TILE + kk * 2048, HALF, 1024), 1);
    wgmma_commit();
    release_previous(empty, i);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int k_a = k0 + 64 * w + 16 * (tw / 32) + (tw % 32) / 4;
  const int col = n0 + 2 * (tw % 4);
  __nv_bfloat16* out_e = out + (size_t)e * Kd * Nd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = k_a + 8 * r;
    if (k >= Kd) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (col + 8 * j < Nd)
        *reinterpret_cast<__nv_bfloat162*>(out_e + (size_t)k * Nd + col +
                                           8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
}

// The row kernel over ceil(Kc / k_per) splits, then the reduction: the
// splits' sum (S > 1) or the zeros of rows no group covers (S = 1), so
// every element of out is written.
template <bool TRANSPOSE_RHS>
cudaError_t launch_rows(const CUtensorMap& am, const CUtensorMap& bm,
                        const void* sizes, void* out, void* ws, int M,
                        int Kc, int Nc, int E, int k_per,
                        cudaStream_t stream) {
  cudaError_t err = allow_smem(gmm_rows_wgmma_kernel<TRANSPOSE_RHS>);
  if (err != cudaSuccess) return err;
  const int splits = (Kc + k_per - 1) / k_per;
  const dim3 grid((Nc + BT - 1) / BT, (M + BT - 1) / BT + E - 1, splits);
  gmm_rows_wgmma_kernel<TRANSPOSE_RHS><<<grid, THREADS, SMEM, stream>>>(
      am, bm, static_cast<const int*>(sizes),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), M, Kc, Nc,
      E, k_per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t blocks = ((size_t)M * Nc / 2 + 255) / 256;
  gmm_split_reduce_kernel<<<(int)(blocks < 1184 ? blocks : 1184), 256, 0,
                            stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(sizes),
      static_cast<__nv_bfloat16*>(out), M, Nc, E, splits > 1 ? splits : 0);
  return cudaGetLastError();
}

}  // namespace

// Every entry returns the CUDA error code of its launches (0 on success;
// cudaErrorInvalidValue for a tensor map the driver refuses). bf16 only;
// the caller launches only when M, K, N and E are > 0. `sizes` are the
// E int32 group sizes on the device; every element of out is written.

// K5: out [M, Nc] = per group lhs [M, Kc] @ rhs[e], rhs [E, Kc, Nc], the
// contraction cut into S = ceil(Kc / k_per) splits (k_per a multiple of
// 64); with S > 1 the f32 partials go through ws [S, M, Nc].
extern "C" int grouped_gmm_wgmma(const void* lhs, const void* rhs,
                                 const void* sizes, void* out, void* ws,
                                 int M, int Kc, int Nc, int E, int k_per,
                                 void* stream) {
  if (k_per <= 0 || k_per % BC) return (int)cudaErrorInvalidValue;
  CUtensorMap am, bm;
  const uint64_t adims[2] = {(uint64_t)Kc, (uint64_t)M};
  const uint64_t bdims[3] = {(uint64_t)Nc, (uint64_t)Kc, (uint64_t)E};
  const uint32_t abox[2] = {BC, BT}, bbox[3] = {64, BC, 1};
  if (!make_tensor_map(&am, lhs, 2, adims, abox) ||
      !make_tensor_map(&bm, rhs, 3, bdims, bbox))
    return (int)cudaErrorInvalidValue;
  return (int)launch_rows<false>(am, bm, sizes, out, ws, M, Kc, Nc, E, k_per,
                                 static_cast<cudaStream_t>(stream));
}

// dlhs [M, Nc] = per group grad [M, Kc] @ rhs[e]^T, rhs [E, Nc, Kc]: the
// contraction Kc is the cotangent's width, Nc the forward's lhs width.
extern "C" int grouped_dlhs_wgmma(const void* grad, const void* rhs,
                                  const void* sizes, void* out, int M,
                                  int Kc, int Nc, int E, void* stream) {
  CUtensorMap am, bm;
  const uint64_t adims[2] = {(uint64_t)Kc, (uint64_t)M};
  const uint64_t bdims[3] = {(uint64_t)Kc, (uint64_t)Nc, (uint64_t)E};
  const uint32_t abox[2] = {BC, BT}, bbox[3] = {BC, BT, 1};
  if (!make_tensor_map(&am, grad, 2, adims, abox) ||
      !make_tensor_map(&bm, rhs, 3, bdims, bbox))
    return (int)cudaErrorInvalidValue;
  return (int)launch_rows<true>(am, bm, sizes, out, nullptr, M, Kc, Nc, E,
                                (Kc + BC - 1) / BC * BC,
                                static_cast<cudaStream_t>(stream));
}

// out [E, Kd, Nd] = per group lhs[rows]^T @ grad[rows], lhs [M, Kd] and
// grad [M, Nd]; every element written.
extern "C" int grouped_tgmm_wgmma(const void* lhs, const void* grad,
                                  const void* sizes, void* out, int M,
                                  int Kd, int Nd, int E, void* stream) {
  CUtensorMap am, bm;
  const uint64_t adims[2] = {(uint64_t)Kd, (uint64_t)M};
  const uint64_t bdims[2] = {(uint64_t)Nd, (uint64_t)M};
  const uint32_t box[2] = {64, BC};
  if (!make_tensor_map(&am, lhs, 2, adims, box) ||
      !make_tensor_map(&bm, grad, 2, bdims, box))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gmm_tgmm_wgmma_kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nd + BT - 1) / BT, (Kd + BT - 1) / BT, E);
  gmm_tgmm_wgmma_kernel<<<grid, THREADS, SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<const int*>(sizes),
      static_cast<__nv_bfloat16*>(out), M, Kd, Nd);
  return (int)cudaGetLastError();
}

// which = 0 (dlhs), 1 (tgmm) or 2 (K5's gmm): out = {registers per
// thread, local (spill) bytes per thread, static shared bytes, dynamic
// shared bytes}.
extern "C" int grouped_wgmma_attrs(int which, int* out) {
  cudaFuncAttributes a;
  cudaError_t err =
      which == 2   ? cudaFuncGetAttributes(&a, gmm_rows_wgmma_kernel<false>)
      : which == 1 ? cudaFuncGetAttributes(&a, gmm_tgmm_wgmma_kernel)
                   : cudaFuncGetAttributes(&a, gmm_rows_wgmma_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = SMEM;
  return 0;
}
