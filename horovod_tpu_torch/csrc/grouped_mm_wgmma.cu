// K6 on the tensor cores: the backward of the ragged grouped matmul for
// bf16 on Hopper (sm_90a). The f32 route, and K5's forward, stay
// csrc/grouped_mm.cu.
//
// Replaces horovod_tpu/ops/grouped_moe.py:151 _gmm_tpu_bwd (megablox gmm
// with a transposed rhs, then tgmm), with csrc/grouped_mm.cu's contract:
//   dlhs[rows of e] = grad[rows of e] @ rhs[e]^T   grad [M, N], rhs [E, K, N]
//   drhs[e] = lhs[rows of e]^T @ grad[rows of e]   lhs [M, K] -> [E, K, N]
// group e owning rows [offsets[e], offsets[e + 1]) of the device offsets
// (no host sync). Products are exact bf16 x bf16 in f32, sums f32, each
// output rounded once to bf16; an empty group's drhs is exactly 0.
//
// What bounds them on an H100: at the MoE train shape (M = 8192 routed
// rows, d_model 2048, d_ff 4096) each is 137 GFLOP, 0.139 ms at 989
// TFLOP/s, against ~0.1 GB of operands (0.03 ms): operations. The FMA
// kernels ran them at 25-39 TFLOP/s.
//
// What this design does about it: each block computes a 128 x 128 output
// tile on wgmma with f32 accumulators in registers: two consumer
// warpgroups of 64 rows each, and one producer warp whose lane 0 keeps a
// four-stage ring of 64-deep operand tiles full by TMA (mbarriers: full =
// bytes landed, empty = both warpgroups done). Each warpgroup keeps one
// wgmma group in flight while it waits for the next stage.
// - dlhs: both operands are K-major (grad rows and rhs[e] rows have the
//   contraction contiguous), wgmma's plain case. Blocks find their (group,
//   row tile) visit from the offsets as the FMA kernel does; a tile that
//   straddles a group boundary loads its neighbours' rows (row r of the
//   output depends only on row r of grad) and the store is masked to the
//   group. Consecutive blocks share a row tile and walk the N tiles, so
//   one expert's rhs stays in L2 across a wave.
// - tgmm: both operands are MN-major (the contraction runs down the rows),
//   read with wgmma's transpose bits. The contraction starts at the
//   group's first row (TMA takes any coordinate); the last stage may
//   reach into the next group, so each warpgroup zeroes those rows of its
//   own lhs tile before its products (TMA zero-fills only past M).
//
// Layout: lhs [M, K], grad [M, N], rhs [E, K, N] bf16, offsets [E + 1]
// int32, all contiguous; K and N multiples of 8 (TMA's 16-byte rows).

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

__device__ __forceinline__ void group_rows(const int* offsets, int g, int M,
                                           int* lo, int* hi) {
  *lo = min(max(offsets[g], 0), M);
  *hi = min(max(offsets[g + 1], *lo), M);
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

__global__ void __launch_bounds__(THREADS, 1)
    gmm_dlhs_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                          const __grid_constant__ CUtensorMap bmap,
                          const int* __restrict__ offsets,
                          __nv_bfloat16* __restrict__ out, int M, int Kc,
                          int Nc, int E) {
  extern __shared__ uint8_t smem_raw[];
  // This block's visit: the groups in order, each over the row tiles its
  // rows touch (blockIdx.y), and an N tile (blockIdx.x).
  int e = -1, m0 = 0, lo = 0, hi = 0;
  for (int g = 0, seen = 0; g < E; ++g) {
    int glo, ghi;
    group_rows(offsets, g, M, &glo, &ghi);
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
  const int n_k = (Kc + BC - 1) / BC;

  uint64_t *full, *empty;
  uint8_t* smem = ring_setup(smem_raw, &full, &empty);
  if (threadIdx.x >= CONSUMERS) {  // producer warp: lane 0 issues TMA
    if (threadIdx.x == CONSUMERS)
      for (int i = 0; i < n_k; ++i) {
        uint8_t* st = produce(smem, full, empty, i);
        tma_load_2d(st, &amap, full + i % STAGES, i * BC, m0);
        tma_load_3d(st + TILE, &bmap, full + i % STAGES, i * BC, n0, e);
      }
    return;
  }

  const int w = threadIdx.x / 128, tw = threadIdx.x % 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int i = 0; i < n_k; ++i) {
    mbar_wait(full + i % STAGES, (i / STAGES) & 1);
    const uint8_t* st = smem + (i % STAGES) * STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      wgmma_m64n128k16_ss<0, 0>(
          acc, wgmma_desc(st + w * HALF + kk * 32, 16, 1024),
          wgmma_desc(st + TILE + kk * 32, 16, 1024), 1);
    wgmma_commit();
    release_previous(empty, i);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int row_a = m0 + 64 * w + 16 * (tw / 32) + (tw % 32) / 4;
  const int col = n0 + 2 * (tw % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row < lo || row >= hi) continue;
    __nv_bfloat16* orow = out + (size_t)row * Nc;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (col + 8 * j < Nc)
        *reinterpret_cast<__nv_bfloat162*>(orow + col + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    gmm_tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                          const __grid_constant__ CUtensorMap bmap,
                          const int* __restrict__ offsets,
                          __nv_bfloat16* __restrict__ out, int M, int Kd,
                          int Nd) {
  extern __shared__ uint8_t smem_raw[];
  const int n0 = blockIdx.x * BT, k0 = blockIdx.y * BT, e = blockIdx.z;
  int lo, hi;
  group_rows(offsets, e, M, &lo, &hi);
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

}  // namespace

// Both entries return the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue for a tensor map the driver refuses). bf16 only;
// the caller launches only when M, K, N and E are > 0.

// dlhs [M, Nc] = per group grad [M, Kc] @ rhs[e]^T, rhs [E, Nc, Kc]: the
// contraction Kc is the cotangent's width, Nc the forward's lhs width.
extern "C" int grouped_dlhs_wgmma(const void* grad, const void* rhs,
                                  const void* offsets, void* out, int M,
                                  int Kc, int Nc, int E, void* stream) {
  CUtensorMap am, bm;
  const uint64_t adims[2] = {(uint64_t)Kc, (uint64_t)M};
  const uint64_t bdims[3] = {(uint64_t)Kc, (uint64_t)Nc, (uint64_t)E};
  const uint32_t abox[2] = {BC, BT}, bbox[3] = {BC, BT, 1};
  if (!make_tensor_map(&am, grad, 2, adims, abox) ||
      !make_tensor_map(&bm, rhs, 3, bdims, bbox))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gmm_dlhs_wgmma_kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Nc + BT - 1) / BT, (M + BT - 1) / BT + E - 1);
  gmm_dlhs_wgmma_kernel<<<grid, THREADS, SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<const int*>(offsets),
      static_cast<__nv_bfloat16*>(out), M, Kc, Nc, E);
  return (int)cudaGetLastError();
}

// out [E, Kd, Nd] = per group lhs[rows]^T @ grad[rows], lhs [M, Kd] and
// grad [M, Nd]; every element written.
extern "C" int grouped_tgmm_wgmma(const void* lhs, const void* grad,
                                  const void* offsets, void* out, int M,
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
      am, bm, static_cast<const int*>(offsets),
      static_cast<__nv_bfloat16*>(out), M, Kd, Nd);
  return (int)cudaGetLastError();
}

// which = 0 (dlhs) or 1 (tgmm): out = {registers per thread, local (spill)
// bytes per thread, static shared bytes, dynamic shared bytes}.
extern "C" int grouped_wgmma_attrs(int which, int* out) {
  cudaFuncAttributes a;
  cudaError_t err =
      which ? cudaFuncGetAttributes(&a, gmm_tgmm_wgmma_kernel)
            : cudaFuncGetAttributes(&a, gmm_dlhs_wgmma_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = SMEM;
  return 0;
}
