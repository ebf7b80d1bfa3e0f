// K3 on the tensor cores: the flash-attention backward's dq for bf16 on
// Hopper (sm_90a). The f32 route stays csrc/flash_bwd.cu flash_bwd_dq.
//
// Replaces horovod_tpu/ops/flash_attention.py:208 _bwd_dq_kernel (which
// _flash_bwd_impl reaches at :460), with csrc/flash_bwd.cu's contract and
// numeric recipe: given q, k, v, do, the forward's lse and delta =
// rowsum(do * o) (f32, computed outside),
//   s  = q k^T * D^-1/2, masked to -1e30 (causal, ragged keys)
//   p  = s > -1e30/2 ? exp(s - lse) : 0     (guarded on s, not on lse)
//   dp = do v^T
//   ds = p (dp - delta) D^-1/2
//   dq += bf16(ds) k
// with f32 products and accumulators. GQA is native (query head h reads
// kv head h / n_rep); any T is taken, causal or not. With a per-key bias
// (the TPU kernel's has_bias) s gets bias[b, key] added after the mask, on
// every tile, before p.
//
// What bounds it on an H100: at the train shape (B4 H16 Hkv4 T2048 D128
// causal) its three products are 6 D flop per causal pair, 103 GFLOP,
// 0.104 ms at 989 TFLOP/s, against ~0.1 GB of operands: operations. The
// FMA kernel ran it at ~18 TFLOP/s, off the tensor cores.
//
// What this design does about it: K2's kernel (csrc/flash_bwd_wgmma.cu)
// turned around, on the same hopper.cuh pieces. A block pins 128 query
// rows of one query head: two consumer warpgroups of 64 rows each (raised
// to 232 registers by setmaxnreg) hold their Q and dO tiles in shared
// memory for the whole loop, with their lse and delta, which arrive once
// by bulk copy from the 64-padded [B*H, Tp] buffers K2 also reads. A
// producer warpgroup (cut to 40) keeps a three-stage ring of {K, V} tiles
// of 64 keys full by TMA (mbarriers: full = bytes landed, empty = both
// warpgroups done). Per kv tile each warpgroup computes S = Q K^T and
// dP = dO V^T as m64n64k16 products with both operands K-major, forms P
// and dS on the accumulator fragment, and feeds dS, cast to bf16, back as
// wgmma's register A fragment of dQ += dS K, which reads K MN-major (the
// transpose bit). dQ stays in registers for the whole loop (64 f32 a
// thread at D128). Only tiles on the diagonal or past T are masked; the
// kv loop stops at the causal limit of the block's last row, a
// warpgroup skips the tiles wholly after its own rows, and the heaviest
// (last) q tiles are launched first. No atomics: each dq element is
// written once, by the one thread that summed it, so two launches give
// the same bits. Tensor maps are 3-D over [B*H(kv), T, D], so rows past T
// are zero-filled per head, and head dims below 64 are padded to 64 by
// the same fill. The bias variant (template flag HAS_BIAS; without it the
// kernel is the same code, with the same registers and shared memory)
// stages each kv tile's 64 bias floats in its ring stage by one bulk copy
// on the stage's barrier.
//
// Layout: q/do/dq [B, H, Tq, D], k/v [B, Hkv, Tk, D] bf16; lse and delta
// f32 [B*H, Tp], Tp = Tq rounded up to 64 (the caller pads); bias f32
// [B, Tkp], Tkp = Tk rounded up to 128 (K1's padded bias), or null; all
// contiguous; D in {16, 32, 64, 128}.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hvd_torch;

constexpr int BQ = 128;                   // query rows per block (64 a wg)
constexpr int BK = 64;                    // keys per kv tile
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
constexpr int CH = 64 * 64 * 2;           // [64 rows][64 cols] bf16 box

// Shared memory of a block for padded head dim DP: Q as [warpgroup][NC
// chunks], then dO the same way, then the ring (K chunks, then V chunks,
// then with a bias the tile's bias row padded to 1024 bytes: a stage),
// then lse[128] and delta[128], then the barriers.
template <int DP, bool HAS_BIAS>
struct Layout {
  static constexpr int NC = DP / 64;
  static constexpr int DO = 2 * NC * CH;
  static constexpr int RING = 4 * NC * CH;
  static constexpr int BIAS = 2 * NC * CH;        // a stage's bias row
  static constexpr int STAGE = BIAS + (HAS_BIAS ? 1024 : 0);
  static constexpr int TX = BIAS + (HAS_BIAS ? BK * 4 : 0);  // bytes a stage
  static constexpr int RES = RING + STAGES * STAGE;
  static constexpr int BARS = RES + 2 * BQ * 4;  // q_full, full, empty
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + 1024;
};

template <int DP, bool HAS_BIAS>
__device__ __forceinline__ void consume(
    uint8_t* smem, uint64_t* q_full, uint64_t* full, uint64_t* empty,
    __nv_bfloat16* __restrict__ dq, int bh, int q0, int n_tiles, int Tq,
    int Tk, int D, float scale, int causal) {
  using L = Layout<DP, HAS_BIAS>;
  constexpr int NC = L::NC;

  // This thread's fragment rows (queries) row_a and row_a + 8 of its
  // warpgroup's 64, and its columns 8 j + col (+ 1).
  const int w = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int row_a = 16 * (tw / 32) + (tw % 32) / 4;
  const int col = 2 * (tw % 4);
  const int qw = q0 + 64 * w;  // the warpgroup's first query row
  const bool live = qw < Tq;
  const uint8_t* qs = smem + w * NC * CH;
  const uint8_t* dos = smem + L::DO + w * NC * CH;

  float dqa[DP / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = 0.f;
    dp[i] = 0.f;
  }
  fence_regs(dqa);

  mbar_wait(q_full, 0);
  const float* lse_s = reinterpret_cast<const float*>(smem + L::RES);
  const float* dl_s = lse_s + BQ;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = live ? lse_s[64 * w + row_a + 8 * r] : 0.f;
    dl_r[r] = live ? dl_s[64 * w + row_a + 8 * r] : 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const int k0 = t * BK;
    if (!live || (causal && k0 > qw + 63)) {  // every key after every row
      if (tw % 32 == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const uint8_t* ks = smem + L::RING + s * L::STAGE;
    const uint8_t* vs = ks + NC * CH;
    const float* bias_s = reinterpret_cast<const float*>(ks + L::BIAS);

    // S = Q K^T and dP = dO V^T over the head dim, 16 at a time.
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * CH + (kk % 4) * 32;
      wgmma_m64n64k16_ss<0, 0>(sc, wgmma_desc(qs + off, 16, 1024),
                               wgmma_desc(ks + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * CH + (kk % 4) * 32;
      wgmma_m64n64k16_ss<0, 0>(dp, wgmma_desc(dos + off, 16, 1024),
                               wgmma_desc(vs + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // p: scale, then mask (only a tile past Tk or on the diagonal holds
    // masked pairs), then the bias on every tile, then exp against the
    // row's lse.
    const bool masked = k0 + BK > Tk || (causal && k0 + BK - 1 > qw);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x = sc[i] * scale;
      if (masked) {
        const int kpos = k0 + 8 * (i / 4) + col + (i & 1);
        if (kpos >= Tk || (causal && kpos > qw + row_a + 8 * r)) x = kNeg;
      }
      if constexpr (HAS_BIAS) x += bias_s[8 * (i / 4) + col + (i & 1)];
      sc[i] = x > kNeg * 0.5f ? __expf(x - lse_r[r]) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS in bf16: keys 16 kk .. 16 kk + 15 are fragment columns-of-8
    // 2 kk and 2 kk + 1, wgmma's A layout for k step kk.
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = 8 * kk + 2 * i, r = i & 1;
        da[kk][i] = pack_bf16(sc[a] * (dp[a] - dl_r[r]) * scale,
                              sc[a + 1] * (dp[a + 1] - dl_r[r]) * scale);
      }

    // dQ += dS K, K read MN-major: 16 keys a k step (2048 bytes), the
    // next 64 head dims CH on (LBO).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dk = wgmma_desc(ks + kk * 2048, CH, 1024);
      if constexpr (DP == 128)
        wgmma_m64n128k16_rs<1>(dqa, da[kk], dk, 1);
      else
        wgmma_m64n64k16_rs<1>(dqa, da[kk], dk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    if (tw % 32 == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = qw + row_a + 8 * r;
    if (qrow >= Tq) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * Tq + qrow) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(out + c) =
            __floats2bfloat162_rn(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
    }
  }
}

template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap dmap,
                              const float* __restrict__ bias,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int H, int Hkv,
                              int Tq, int Tk, int D, float scale,
                              int causal) {
  using L = Layout<DP, HAS_BIAS>;
  constexpr int NC = L::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // Heaviest first: the last q tile reaches the most keys.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int bkh = b * Hkv + h / (H / Hkv);
  // The causal limit of the block's last row ends the kv loop.
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int tp = (Tq + 63) / 64 * 64;
  const int n_live = q0 + 64 < Tq ? 2 : 1;  // warpgroups with a row < Tq

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: lane 0 issues the copies; the others only give
    // up their registers to the consumers.
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, 4 * NC * CH + n_live * 2 * 64 * 4);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(smem + (w * NC + c) * CH, &qmap, q_full, 64 * c,
                      q0 + 64 * w, bh);
          tma_load_3d(smem + L::DO + (w * NC + c) * CH, &dmap, q_full,
                      64 * c, q0 + 64 * w, bh);
        }
      float* res = reinterpret_cast<float*>(smem + L::RES);
      for (int w = 0; w < n_live; ++w) {
        const size_t at = (size_t)bh * tp + q0 + 64 * w;
        bulk_load(res + 64 * w, lse + at, 64 * 4, q_full);
        bulk_load(res + BQ + 64 * w, delta + at, 64 * 4, q_full);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* st = smem + L::RING + s * L::STAGE;
        mbar_expect_tx(&full[s], L::TX);
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(st + c * CH, &kmap, &full[s], 64 * c, t * BK, bkh);
          tma_load_3d(st + (NC + c) * CH, &vmap, &full[s], 64 * c, t * BK,
                      bkh);
        }
        if constexpr (HAS_BIAS) {
          const int tkp = (Tk + 127) / 128 * 128;
          bulk_load(st + L::BIAS, bias + (size_t)b * tkp + t * BK, BK * 4,
                    &full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    consume<DP, HAS_BIAS>(smem, q_full, full, empty, dq, bh, q0, n_tiles, Tq,
                          Tk, D, scale, causal);
  }
}

template <int DP, bool HAS_BIAS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int H, int Hkv, int Tq,
                   int Tk, int D, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap qm, km, vm, dm;
  const uint64_t qdims[3] = {(uint64_t)D, (uint64_t)Tq, (uint64_t)B * H};
  const uint64_t kdims[3] = {(uint64_t)D, (uint64_t)Tk, (uint64_t)B * Hkv};
  const uint32_t box[3] = {64, 64, 1};
  if (!make_tensor_map(&qm, q, 3, qdims, box) ||
      !make_tensor_map(&km, k, 3, kdims, box) ||
      !make_tensor_map(&vm, v, 3, kdims, box) ||
      !make_tensor_map(&dm, dout, 3, qdims, box))
    return cudaErrorInvalidValue;
  const int smem = Layout<DP, HAS_BIAS>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<DP, HAS_BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_wgmma_kernel<DP, HAS_BIAS><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, dm, static_cast<const float*>(bias),
      static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H,
      Hkv, Tq, Tk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Same arguments as csrc/flash_bwd.cu's flash_bwd_dq, but lse and delta
// are [B*H, Tp] (padded to a multiple of 64 queries) and a non-null bias
// is [B, Tkp] (padded to a multiple of 128 keys); only bf16 (is_bf16 = 1)
// and D in {16, 32, 64, 128} are taken. Returns the CUDA error code of the
// launch (0 on success; cudaErrorInvalidValue for another dtype or D, or
// a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int flash_bwd_dq_wgmma(const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int B, int H,
                                  int Hkv, int Tq, int Tk, int D, int causal,
                                  int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;
#define HVD_DQ_LAUNCH(DP)                                                  \
  return bias ? launch<DP, true>(q, k, v, bias, dout, lse, delta, dq, B, H, \
                                 Hkv, Tq, Tk, D, causal, scale, s)         \
              : launch<DP, false>(q, k, v, bias, dout, lse, delta, dq, B,  \
                                  H, Hkv, Tq, Tk, D, causal, scale, s);
  if (D == 16 || D == 32 || D == 64) HVD_DQ_LAUNCH(64)
  if (D == 128) HVD_DQ_LAUNCH(128)
#undef HVD_DQ_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <int DP, bool HAS_BIAS>
int attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, flash_bwd_dq_wgmma_kernel<DP, HAS_BIAS>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = Layout<DP, HAS_BIAS>::BYTES;
  return 0;
}

// The compiled kernel for head dim D, with or without the bias: out =
// {registers per thread, local (spill) bytes per thread, static shared
// bytes, dynamic shared bytes}.
extern "C" int flash_bwd_dq_wgmma_attrs(int D, int has_bias, int* out) {
  if (D == 128)
    return has_bias ? attrs<128, true>(out) : attrs<128, false>(out);
  return has_bias ? attrs<64, true>(out) : attrs<64, false>(out);
}
