// K4 for bf16 on Hopper (sm_90a): single-token GQA decode attention in one
// launch, both products on wgmma. The f32 route stays
// csrc/decode_attention.cu (three passes on FMA).
//
// Replaces horovod_tpu/ops/decode_attention.py:36 _kernel (launched at
// :84), with csrc/decode_attention.cu's contract and numeric recipe: for
// each (batch, kv head) the n_rep query rows that share the head attend
// over its cache [S, D], slots <= pos valid; f32 scores and softmax, p
// NORMALISED first (p = exp(s - m) / l) and only then cast to bf16, PV
// accumulated in f32. Because p is rounded after the division, the global
// (m, l) of a row must be known before any of its p is rounded: an online
// single pass cannot reproduce the recipe.
//
// What bounds it on an H100: bytes. Each valid slot's K and V rows are
// read once (4 D bytes a slot in bf16) for 4 n_rep D flop, far below the
// ~295 flop a byte the tensor cores need. At the decode step's shape (B16
// Hkv4 n_rep4 S192 pos150 D128) that is 4.9 MB, 1.5 us at 3.35 TB/s:
// below a launch's own latency, so the aim is one launch, the cache read
// once at full width, and no intermediate in device memory.
//
// What this design does about it:
// - One launch. A thread-block cluster of C blocks takes one (batch, kv
//   head); C is chosen on the host so that B * Hkv * C fills the card's
//   SMs (up to 16, as far as the card schedules such a cluster), and each
//   block takes a slice of whole 64-slot tiles. A block computes its
//   slice's scores and its local (max, sum) of exp per row, publishes
//   them in its shared memory, and after a cluster barrier reads every
//   peer's (max, sum) by distributed shared memory and combines them in
//   rank order (the same bits in every block). It then rounds its
//   normalised p exactly as the recipe says and computes its partial PV;
//   after a second barrier each block sums a share of the output's
//   elements over the C partials, in rank order, through distributed
//   shared memory, and a last barrier keeps every block's shared memory
//   alive until its peers have read it. No atomics: the same bits on
//   every launch.
// - Full-width loads issued up front. Thread 0 issues TMA loads of q and
//   of the slice's K tiles, then its V tiles, into a ring of up to 160 KB,
//   so V arrives while the scores are computed; a tile's slot is refilled
//   as soon as its product is done (a long slice streams through the
//   ring).
// - Two warpgroups take alternate tiles, each with its own statistics,
//   P^T buffers and output accumulators (summed in a fixed order at the
//   end), so one's softmax arithmetic overlaps the other's products and
//   waits: with one warpgroup a long slice was bound by that arithmetic,
//   not by its loads.
// - Both products on wgmma, transposed, because n_rep is small: the
//   scores as S^T = K q^T (m64 over keys, n = n_rep padded to 8 or 16, K
//   and q both K-major), the output as O^T = V^T P^T (m64 over 64 head
//   dims at a time, V read MN-major by the transpose bit, P^T stored bf16
//   [n_rep][keys] K-major in a 128-byte swizzled tile).
// - Scores stay in shared memory (32 KB: n_rep x slice <= 8192). Where a
//   block's slice of scores outgrows that (a cache of tens of thousands
//   of slots at large n_rep), they spill to an f32 scratch that the
//   caller allocates, [B * Hkv * C, n_rep, slice]: 4 n_rep bytes a slot
//   written and read back, against 4 D bytes of K and V.
//
// Layout: q/out [B, Hkv, R, D] (R = n_rep), k/v [B, Hkv, S, D], all bf16
// and contiguous; R in 1..16; D in {16, 32, 64, 128, 256}.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hvd_torch;

constexpr int THREADS = 256;             // two warpgroups
constexpr int TILE = 64;                 // cache slots a tile
constexpr int CH = 64 * 64 * 2;          // [64 slots][64 dims] bf16 box
constexpr int RING_BYTES = 160 * 1024;
constexpr int SCORE_FLOATS = 8192;       // n_rep x slice held in smem
constexpr int MAX_CLUSTER = 16;

// Shared memory for padded head dim DP and padded n_rep RP: q as DP/64
// chunks of [RP rows][64 dims], two P^T tiles [RP rows][64 slots] for
// each warpgroup, the ring (an even number of tiles, so that a slot
// passing from one V tile to the next stays with one warpgroup), the
// scores, the partial output [R][D] f32, the row statistics (eight
// warps' (max, sum), the block's, the cluster's), the barriers. Tiles
// are 1024-byte aligned (the base is aligned at run time).
template <int DP, int RP>
struct Layout {
  static constexpr int NC = DP / 64;
  static constexpr int QCH = RP * 128;
  static constexpr int PT = NC * QCH;
  static constexpr int RING = PT + 4 * QCH;
  static constexpr int TILE_BYTES = NC * CH;
  static constexpr int STAGES = RING_BYTES / TILE_BYTES / 2 * 2;
  static constexpr int SC = RING + STAGES * TILE_BYTES;
  static constexpr int PO = SC + SCORE_FLOATS * 4;
  static constexpr int RED = PO + RP * DP * 4;       // [8][RP][2]
  static constexpr int ML = RED + 8 * RP * 2 * 4;    // [RP][2]
  static constexpr int GML = ML + RP * 2 * 4;        // [RP][2]
  static constexpr int BARS = GML + RP * 2 * 4;      // q_full, full[]
  static constexpr int BYTES = BARS + (1 + STAGES) * 8 + 1024;
};

// Combines a (max, sum of exp(s - max)) pair into (m, l).
__device__ __forceinline__ void combine(float& m, float& l, float mo,
                                        float lo) {
  const float mn = fmaxf(m, mo);
  l = l * __expf(m - mn) + lo * __expf(mo - mn);
  m = mn;
}

template <int RP>
__device__ __forceinline__ void scores_product(float (&d)[RP / 2],
                                               uint64_t da, uint64_t db,
                                               int scale_d) {
  if constexpr (RP == 8)
    wgmma_m64n8k16_ss<0, 0>(d, da, db, scale_d);
  else
    wgmma_m64n16k16_ss<0, 0>(d, da, db, scale_d);
}

template <int RP>
__device__ __forceinline__ void output_product(float (&d)[RP / 2],
                                               uint64_t da, uint64_t db) {
  if constexpr (RP == 8)
    wgmma_m64n8k16_ss<1, 0>(d, da, db, 1);
  else
    wgmma_m64n16k16_ss<1, 0>(d, da, db, 1);
}

// Issues S^T of the K tile in ring slot `kt` into `d` (one commit group).
template <int DP, int RP>
__device__ __forceinline__ void issue_scores(float (&d)[RP / 2],
                                             const uint8_t* kt,
                                             const uint8_t* qs) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    scores_product<RP>(
        d, wgmma_desc(kt + (kk / 4) * CH + (kk % 4) * 32, 16, 1024),
        wgmma_desc(qs + (kk / 4) * Layout<DP, RP>::QCH + (kk % 4) * 32, 16,
                   1024),
        kk > 0);
  wgmma_commit();
}

template <int DP, int RP>
__global__ void __launch_bounds__(THREADS, 1)
    decode_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                  const __grid_constant__ CUtensorMap kmap,
                                  const __grid_constant__ CUtensorMap vmap,
                                  __nv_bfloat16* __restrict__ out,
                                  float* __restrict__ scratch, int R, int D,
                                  int n_valid, int tpb, float scale) {
  using L = Layout<DP, RP>;
  constexpr int NC = L::NC;
  constexpr int ST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  float* po = reinterpret_cast<float*>(smem + L::PO);
  float* red = reinterpret_cast<float*>(smem + L::RED);
  float* ml = reinterpret_cast<float*>(smem + L::ML);
  float* gml = reinterpret_cast<float*>(smem + L::GML);

  // Warpgroup w takes the block's tiles w, w + 2, ...; its warps and
  // lanes are warp and lane.
  const int tid = threadIdx.x, w = tid / 128, tw = tid % 128;
  const int warp = tw / 32, lane = tw % 32;
  const int rank = (int)cluster_rank();
  const int C = gridDim.x;
  const int bg = blockIdx.z * gridDim.y + blockIdx.y;
  const int n_tiles = (n_valid + TILE - 1) / TILE;
  const int t0 = rank * tpb;
  const int nt = max(0, min(tpb, n_tiles - t0));
  const int j0 = t0 * TILE;                // the slice's first slot
  const int ss = tpb * TILE;               // row stride of the scores
  float* sbuf = scratch ? scratch + ((size_t)bg * C + rank) * R * ss
                        : reinterpret_cast<float*>(smem + L::SC);

  // Tile u of the block's sequence (K tiles 0 .. nt-1, then V tiles)
  // lies in ring slot u % ST.
  auto ring = [&](int u) { return smem + L::RING + (u % ST) * L::TILE_BYTES; };
  auto issue = [&](int u) {
    const int s = u % ST;
    const int slot = (t0 + (u < nt ? u : u - nt)) * TILE;
    mbar_expect_tx(&full[s], L::TILE_BYTES);
    for (int c = 0; c < NC; ++c)
      tma_load_3d(ring(u) + c * CH, u < nt ? &kmap : &vmap, &full[s],
                  64 * c, slot, bg);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  for (int i = tid; i < 4 * L::QCH / 4; i += THREADS)
    reinterpret_cast<uint32_t*>(smem + L::PT)[i] = 0u;  // P^T rows >= R
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_full, NC * L::QCH);
    for (int c = 0; c < NC; ++c)
      tma_load_3d(smem + c * L::QCH, &qmap, q_full, 64 * c, 0, bg);
    for (int u = 0; u < min(ST, 2 * nt); ++u) issue(u);
  }

  // This thread's fragment rows (slots, or head dims for the output)
  // kr and kr + 8, and its columns (query rows) 8 j + col (+ 1).
  const int kr = 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);

  // ---- scores: S^T = K q^T, tile by tile, with per-column (max, sum).
  // The warpgroup's next tile's product runs while this one's scores are
  // processed; a slot is refilled once every warp's product has read it.
  float m_t[RP / 4], l_t[RP / 4], sa[RP / 2], sb[RP / 2];
#pragma unroll
  for (int i = 0; i < RP / 4; ++i) {
    m_t[i] = kNeg;
    l_t[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < RP / 2; ++i) sb[i] = 0.f;
  mbar_wait(q_full, 0);
  if (w < nt) {
    mbar_wait(&full[w], 0);
    issue_scores<DP, RP>(sb, ring(w), smem);
  }
  for (int t = w; t < nt; t += 2) {
    wgmma_wait<0>();
    fence_regs(sb);
#pragma unroll
    for (int i = 0; i < RP / 2; ++i) sa[i] = sb[i];
    named_barrier(1 + w, 128);
    if (tw == 0 && t + ST < 2 * nt) issue(t + ST);
    if (t + 2 < nt) {
      mbar_wait(&full[(t + 2) % ST], ((t + 2) / ST) & 1);
      issue_scores<DP, RP>(sb, ring(t + 2), smem);
    }

    const int jj = t * TILE + kr;  // the slot's index in the slice
    const bool v0 = j0 + jj < n_valid, v1 = j0 + jj + 8 < n_valid;
#pragma unroll
    for (int i = 0; i < RP / 4; ++i) {
      const int r = 8 * (i / 2) + col + (i & 1);
      const float s0 = sa[4 * (i / 2) + (i & 1)] * scale;
      const float s1 = sa[4 * (i / 2) + 2 + (i & 1)] * scale;
      if (r < R) {
        if (v0) sbuf[r * ss + jj] = s0;
        if (v1) sbuf[r * ss + jj + 8] = s1;
      }
      const float mn =
          fmaxf(m_t[i], fmaxf(v0 ? s0 : kNeg, v1 ? s1 : kNeg));
      l_t[i] = l_t[i] * __expf(m_t[i] - mn) +
               (v0 ? __expf(s0 - mn) : 0.f) + (v1 ? __expf(s1 - mn) : 0.f);
      m_t[i] = mn;
    }
  }

  // ---- the block's (max, sum) per row: across the 8 lanes that share a
  // column, then across the 8 warps in order.
#pragma unroll
  for (int i = 0; i < RP / 4; ++i) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      combine(m_t[i], l_t[i], __shfl_xor_sync(0xffffffffu, m_t[i], off),
              __shfl_xor_sync(0xffffffffu, l_t[i], off));
    if (lane < 4) {
      const int r = 8 * (i / 2) + col + (i & 1);
      red[((4 * w + warp) * RP + r) * 2] = m_t[i];
      red[((4 * w + warp) * RP + r) * 2 + 1] = l_t[i];
    }
  }
  __syncthreads();
  if (tid < R) {
    float m = red[tid * 2], l = red[tid * 2 + 1];
    for (int k = 1; k < 8; ++k)
      combine(m, l, red[(k * RP + tid) * 2], red[(k * RP + tid) * 2 + 1]);
    ml[tid * 2] = m;
    ml[tid * 2 + 1] = l;
  }
  cluster_sync();  // every block's (max, sum) published

  // ---- the row's global (max, sum), combined in rank order.
  if (tid < R) {
    float m = kNeg;
    for (int c = 0; c < C; ++c) m = fmaxf(m, ld_cluster_f32(ml + tid * 2, c));
    float l = 0.f;
    for (int c = 0; c < C; ++c)
      l += ld_cluster_f32(ml + tid * 2 + 1, c) *
           __expf(ld_cluster_f32(ml + tid * 2, c) - m);
    gml[tid * 2] = m;
    gml[tid * 2 + 1] = l;
  }
  __syncthreads();

  // ---- output: O^T = V^T P^T, p normalised and then rounded to bf16.
  // P^T of tile t, [RP rows][64 slots] in the warpgroup's buffer
  // (t / 2) % 2, 128-byte swizzled: the 16-byte chunk c of row r lies at
  // chunk c ^ (r % 8). Two slots a thread at a time; rows R .. RP-1 stay
  // zero.
  auto pt_of = [&](int t) {
    return smem + L::PT + (2 * w + ((t >> 1) & 1)) * L::QCH;
  };
  auto write_pt = [&](int t) {
    uint8_t* pt = pt_of(t);
    for (int i = tw; i < R * TILE / 2; i += 128) {
      const int r = i / (TILE / 2), k2 = 2 * (i % (TILE / 2));
      const int jj = t * TILE + k2;
      const float2 sv = *reinterpret_cast<const float2*>(sbuf + r * ss + jj);
      const float m = gml[r * 2], l = gml[r * 2 + 1];
      const float p0 = j0 + jj < n_valid ? __expf(sv.x - m) / l : 0.f;
      const float p1 = j0 + jj + 1 < n_valid ? __expf(sv.y - m) / l : 0.f;
      const int byte = r * 128 + ((((k2 * 2) >> 4) ^ (r & 7)) << 4) +
                       ((k2 * 2) & 15);
      *reinterpret_cast<uint32_t*>(pt + byte) = pack_bf16(p0, p1);
    }
    fence_proxy_async();  // visible to the products (the async proxy)
  };
  float acc[NC][RP / 2];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < RP / 2; ++i) acc[c][i] = 0.f;
  if (w < nt) write_pt(w);
  named_barrier(1 + w, 128);
  // The warpgroup's next P^T is written while this tile's product runs.
  for (int t = w; t < nt; t += 2) {
    const int u = nt + t;
    mbar_wait(&full[u % ST], (u / ST) & 1);
    const uint8_t* vt = ring(u);
    const uint8_t* pt = pt_of(t);
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        output_product<RP>(acc[c],
                           wgmma_desc(vt + c * CH + kk * 2048, CH, 1024),
                           wgmma_desc(pt + kk * 32, 16, 1024));
    wgmma_commit();
    if (t + 2 < nt) write_pt(t + 2);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    // Every warp's product read tile t's slot and P^T; the next P^T is
    // written.
    named_barrier(1 + w, 128);
    if (tw == 0 && u + ST < 2 * nt) issue(u + ST);
  }

  // ---- the block's partial [R][D] in f32 (warpgroup 0's, plus warpgroup
  // 1's), then the sum over the cluster's blocks in rank order, each
  // element by one thread.
  for (int g = 0; g < 2; ++g) {
    if (w == g) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < RP / 4; ++i) {
          const int r = 8 * (i / 2) + col + (i & 1);
          const int d = 64 * c + kr;
          if (r >= R) continue;
          const float a0 = acc[c][4 * (i / 2) + (i & 1)];
          const float a1 = acc[c][4 * (i / 2) + 2 + (i & 1)];
          if (d < D) po[r * D + d] = g ? po[r * D + d] + a0 : a0;
          if (d + 8 < D) po[r * D + d + 8] = g ? po[r * D + d + 8] + a1 : a1;
        }
    }
    __syncthreads();
  }
  cluster_sync();  // every block's partial written
  __nv_bfloat16* o = out + (size_t)bg * R * D;
  for (int i = rank * THREADS + tid; i < R * D; i += C * THREADS) {
    float sum = 0.f;
    for (int c = 0; c < C; ++c) sum += ld_cluster_f32(po + i, c);
    o[i] = __float2bfloat16(sum);
  }
  cluster_sync();  // no block leaves while a peer reads its memory
}

// The kernel's shared-memory size, and leave for clusters above the
// portable 8 blocks: set once per kernel (a launch is host-bound at the
// decode step's shapes).
template <int DP, int RP>
cudaError_t set_attributes() {
  static cudaError_t err = [] {
    auto kernel = decode_attention_wgmma_kernel<DP, RP>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<DP, RP>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return err;
}

template <int DP, int RP>
void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   int cluster, int Hkv, int B, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, Hkv, B);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = Layout<DP, RP>::BYTES;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <int DP, int RP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* scratch, int B, int Hkv, int R, int S, int D,
                   int n_valid, int cluster, int tpb, float scale,
                   cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  const uint64_t qdims[3] = {(uint64_t)D, (uint64_t)R, (uint64_t)B * Hkv};
  const uint64_t kdims[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)B * Hkv};
  const uint32_t qbox[3] = {64, RP, 1}, kbox[3] = {64, TILE, 1};
  if (!make_tensor_map(&qm, q, 3, qdims, qbox) ||
      !make_tensor_map(&km, k, 3, kdims, kbox) ||
      !make_tensor_map(&vm, v, 3, kdims, kbox))
    return cudaErrorInvalidValue;
  cudaError_t err = set_attributes<DP, RP>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config<DP, RP>(&cfg, &attr, cluster, Hkv, B, stream);
  err = cudaLaunchKernelEx(&cfg, decode_attention_wgmma_kernel<DP, RP>, qm,
                           km, vm, static_cast<__nv_bfloat16*>(out),
                           static_cast<float*>(scratch), R, D, n_valid, tpb,
                           scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// out[i] = how many clusters of 2^i blocks (i = 0 .. 4) the card holds
// at once (0 where it cannot schedule one).
template <int DP, int RP>
int active_clusters(int* out) {
  cudaError_t err = set_attributes<DP, RP>();
  if (err != cudaSuccess) return (int)err;
  for (int i = 0, c = 1; c <= MAX_CLUSTER; ++i, c *= 2) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    launch_config<DP, RP>(&cfg, &attr, c, 1, 1, 0);
    out[i] = 0;
    if (cudaOccupancyMaxActiveClusters(
            &out[i], decode_attention_wgmma_kernel<DP, RP>, &cfg) !=
        cudaSuccess)
      out[i] = 0;
  }
  cudaGetLastError();  // clear what a refused size left behind
  return 0;
}

template <int DP, int RP>
int attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, decode_attention_wgmma_kernel<DP, RP>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = Layout<DP, RP>::BYTES;
  return 0;
}

}  // namespace

// Returns CALL(DP, RP) for (R, D): D padded to 64, 128 or 256, n_rep to
// 8 or 16.
#define HVD_K4_DISPATCH(CALL)                                     \
  if (D <= 64) return R > 8 ? CALL(64, 16) : CALL(64, 8);         \
  if (D == 128) return R > 8 ? CALL(128, 16) : CALL(128, 8);      \
  return R > 8 ? CALL(256, 16) : CALL(256, 8)

static bool takes(int R, int D) {
  return R >= 1 && R <= 16 &&
         (D == 16 || D == 32 || D == 64 || D == 128 || D == 256);
}

// q/out [B, Hkv, R, D], k/v [B, Hkv, S, D] bf16; slots < n_valid read;
// a cluster of `cluster` blocks per (batch, kv head), each taking `tpb`
// tiles of 64 slots (cluster * tpb * 64 >= n_valid); `scratch` null, or
// f32 [B * Hkv * cluster, R, tpb * 64] where R * tpb * 64 > 8192.
// Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue for an R, D or plan it does not take).
extern "C" int decode_attention_wgmma(const void* q, const void* k,
                                      const void* v, void* out, void* scratch,
                                      int B, int Hkv, int R, int S, int D,
                                      int n_valid, int cluster, int tpb,
                                      float scale, void* stream) {
  if (!takes(R, D) || n_valid < 1 || n_valid > S || cluster < 1 ||
      cluster > MAX_CLUSTER || tpb < 1 ||
      (long)cluster * tpb * TILE < n_valid ||
      (!scratch && R * tpb * TILE > SCORE_FLOATS))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HVD_K4_LAUNCH(DP, RP)                                             \
  (int)launch<DP, RP>(q, k, v, out, scratch, B, Hkv, R, S, D, n_valid,    \
                      cluster, tpb, scale, s)
  HVD_K4_DISPATCH(HVD_K4_LAUNCH);
#undef HVD_K4_LAUNCH
}

// out[i] = how many clusters of 2^i blocks (i = 0 .. 4) of the kernel for
// (R, D) this card holds at once. Returns a CUDA error code (0 on
// success; cudaErrorInvalidValue for an (R, D) it does not take).
extern "C" int decode_attention_wgmma_clusters(int R, int D, int* out) {
  if (!takes(R, D)) return (int)cudaErrorInvalidValue;
#define HVD_K4_CLUSTERS(DP, RP) active_clusters<DP, RP>(out)
  HVD_K4_DISPATCH(HVD_K4_CLUSTERS);
#undef HVD_K4_CLUSTERS
}

// The compiled kernel for (R, D): out = {registers per thread, local
// (spill) bytes per thread, static shared bytes, dynamic shared bytes}.
extern "C" int decode_attention_wgmma_attrs(int R, int D, int* out) {
  if (!takes(R, D)) return (int)cudaErrorInvalidValue;
#define HVD_K4_ATTRS(DP, RP) attrs<DP, RP>(out)
  HVD_K4_DISPATCH(HVD_K4_ATTRS);
#undef HVD_K4_ATTRS
}
