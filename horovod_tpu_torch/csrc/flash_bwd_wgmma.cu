// K2 on the tensor cores: the flash-attention backward's dk and dv for
// bf16 on Hopper (sm_90a). The f32 route, and K3 (dq), stay
// csrc/flash_bwd.cu.
//
// Replaces horovod_tpu/ops/flash_attention.py:134 _bwd_dkv_kernel, with
// csrc/flash_bwd.cu's contract and numeric recipe: given q, k, v, do and
// the forward's lse, and delta = rowsum(do * o) (f32, computed outside),
//   s  = q k^T * D^-1/2, masked to -1e30 (causal, ragged q and keys)
//   p  = s > -1e30/2 ? exp(s - lse) : 0     (guarded on s, not on lse)
//   dv += bf16(p)^T do
//   dp = do v^T
//   ds = p (dp - delta) D^-1/2              (p in f32 here)
//   dk += bf16(ds)^T q
// with f32 products and accumulators. dk and dv come out PER QUERY HEAD
// [B, H, Tk, D] in bf16; the caller sums each kv head's n_rep query heads
// in f32, as the TPU module does outside its kernel. GQA is native (query
// head h reads kv head h / n_rep); any T is taken, causal or not. With a
// per-key bias (the TPU kernel's has_bias) s gets bias[b, key] added after
// the mask, on every tile, before p. With chunk offsets (has_offsets: a
// ring step) the causal tests compare global positions through shift =
// q_offset - kv_offset (common.cuh); the lse cotangent of a ring step
// reaches the kernel folded into delta by the caller.
//
// What bounds it on an H100: at the train shape (B4 H16 Hkv4 T2048 D128
// causal) its four products are 8 D flop per causal pair, 137 GFLOP,
// 0.139 ms at 989 TFLOP/s, against ~0.1 GB of operands: operations. The
// FMA kernel ran it at ~20 TFLOP/s.
//
// What this design does about it (FA3's transposed formulation): a block
// pins 128 keys of one query head and streams the q tiles that reach
// them, so the causal skip is the loop's start. Two consumer warpgroups
// own 64 keys each (raised to 232 registers by setmaxnreg); a producer
// warpgroup (cut to 40) loads K and V once by TMA and keeps a two-stage
// ring of {Q, dO, lse, delta} tiles of 64 queries full (mbarriers: full =
// bytes landed, empty = both warpgroups done). Per q tile each warpgroup
// computes S^T = K Q^T and dP^T = V dO^T as m64n64k16 products with both
// operands K-major from shared memory; lse and delta are per column of
// S^T, read from the stage. The accumulator fragments P^T and dS^T, cast
// to bf16, are wgmma's register A fragments of dV += P^T dO and
// dK += dS^T Q, which read dO and Q MN-major (the transpose bit); dK and
// dV stay in registers for the whole loop (2 x 64 f32 a thread at D128).
// Only tiles on the diagonal or past T are masked; a q tile that lies
// wholly before a warpgroup's keys is skipped by it. Under offsets the
// diagonal moves by shift and may cut a tile anywhere (a chunk starting
// mid-tile); when no q tile reaches the block's keys (a wholly future
// chunk) the loop is empty and dk = dv = 0 are written. Tensor maps are 3-D
// over [B*H(kv), T, D], so rows past T are zero-filled per head, and
// head dims below 64 are padded to 64 by the same fill. The bias variant
// (template flag HAS_BIAS; without it the kernel is the same code, with
// the same registers and shared memory): a thread's fragment rows are two
// fixed keys for the whole loop, so it holds their two bias values in
// registers, read once.
//
// Layout: q/do [B, H, Tq, D], k/v [B, Hkv, Tk, D] bf16, dk/dv
// [B, H, Tk, D] bf16; lse and delta f32 [B*H, Tp], Tp = Tq rounded up to
// 64 (the caller pads, so each tile's 256 bytes are one aligned bulk
// copy); bias f32 [B, Tkp], Tkp = Tk rounded up to 128 (K1's padded
// bias), or null; all contiguous; D in {16, 32, 64, 128}.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hvd_torch;

constexpr int BQ = 64;                    // queries per q tile
constexpr int BK = 128;                   // keys per block (64 a warpgroup)
constexpr int STAGES = 2;
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
constexpr int CH = 64 * 64 * 2;           // [64 rows][64 cols] bf16 box

// Shared memory of a block for padded head dim DP: K as [warpgroup][NC
// chunks], then V the same way, then the stages (Q chunks, dO chunks,
// lse[64], delta[64], padded to 1024 bytes), then the barriers.
template <int DP>
struct Layout {
  static constexpr int NC = DP / 64;
  static constexpr int V = 2 * NC * CH;
  static constexpr int RING = 4 * NC * CH;
  static constexpr int STAGE = 2 * NC * CH + 1024;
  static constexpr int TX = 2 * NC * CH + 2 * BQ * 4;  // bytes a stage
  static constexpr int BARS = RING + STAGES * STAGE;   // kv, full, empty
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8 + 1024;
};

template <int DP, bool HAS_BIAS>
__device__ __forceinline__ void consume(
    uint8_t* smem, uint64_t* kv_full, uint64_t* full, uint64_t* empty,
    const float* __restrict__ bias_row, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int bh, int k0, int iq_begin, int n_q,
    int Tq, int Tk, int D, float scale, int causal, int shift) {
  using L = Layout<DP>;
  constexpr int NC = L::NC;

  // This thread's fragment rows (keys) row_a and row_a + 8 of its
  // warpgroup's 64, and its columns 8 j + col (+ 1).
  const int w = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int row_a = 16 * (tw / 32) + (tw % 32) / 4;
  const int col = 2 * (tw % 4);
  const int key0 = k0 + 64 * w;
  const uint8_t* ks = smem + w * NC * CH;
  const uint8_t* vs = smem + L::V + w * NC * CH;
  // The bias of this thread's two keys (0 past Tk, where s is masked).
  float kb[2] = {0.f, 0.f};
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + row_a + 8 * r;
      kb[r] = key < Tk ? bias_row[key] : 0.f;
    }
  }

  float dva[DP / 2], dka[DP / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    dva[i] = 0.f;
    dka[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = 0.f;
    dp[i] = 0.f;
  }
  fence_regs(dva);
  fence_regs(dka);

  mbar_wait(kv_full, 0);
  for (int t = 0; t < n_q; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const int q0 = (iq_begin + t) * BQ;
    // Every query before every key:
    if (causal && q0 + BQ - 1 + shift < key0) {
      if (tw % 32 == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const uint8_t* qs = smem + L::RING + s * L::STAGE;
    const uint8_t* dos = qs + NC * CH;
    const float* lse_s = reinterpret_cast<const float*>(dos + NC * CH);
    const float* dl_s = lse_s + BQ;

    // S^T = K Q^T and dP^T = V dO^T over the head dim, 16 at a time.
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * CH + (kk % 4) * 32;
      wgmma_m64n64k16_ss<0, 0>(sc, wgmma_desc(ks + off, 16, 1024),
                               wgmma_desc(qs + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * CH + (kk % 4) * 32;
      wgmma_m64n64k16_ss<0, 0>(dp, wgmma_desc(vs + off, 16, 1024),
                               wgmma_desc(dos + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // p: scale, then mask (only a tile past T or on the diagonal holds
    // masked pairs), then the bias on every tile, then exp against the
    // column's lse.
    const bool masked = q0 + BQ > Tq || key0 + 64 > Tk ||
                        (causal && key0 + 63 > q0 + shift);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i / 4) + col + (i & 1);
      float x = sc[i] * scale;
      if (masked) {
        const int qpos = q0 + qc, kpos = key0 + row_a + 8 * ((i >> 1) & 1);
        if (qpos >= Tq || kpos >= Tk || (causal && kpos > qpos + shift))
          x = kNeg;
      }
      if constexpr (HAS_BIAS) x += kb[(i >> 1) & 1];
      sc[i] = x > kNeg * 0.5f ? __expf(x - lse_s[qc]) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i / 4) + col + (i & 1);
      dp[i] = sc[i] * (dp[i] - dl_s[qc]) * scale;
    }
    // P^T and dS^T in bf16: queries 16 kk .. 16 kk + 15 are fragment
    // columns-of-8 2 kk and 2 kk + 1, wgmma's A layout for k step kk.
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
        da[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      }

    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major: 16 queries
    // a k step (2048 bytes), the next 64 head dims CH on (LBO).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint64_t ddo = wgmma_desc(dos + kk * 2048, CH, 1024);
      const uint64_t dqs = wgmma_desc(qs + kk * 2048, CH, 1024);
      if constexpr (DP == 128) {
        wgmma_m64n128k16_rs<1>(dva, pa[kk], ddo, 1);
        wgmma_m64n128k16_rs<1>(dka, da[kk], dqs, 1);
      } else {
        wgmma_m64n64k16_rs<1>(dva, pa[kk], ddo, 1);
        wgmma_m64n64k16_rs<1>(dka, da[kk], dqs, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    if (tw % 32 == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + row_a + 8 * r;
    if (key >= Tk) continue;
    const size_t row = ((size_t)bh * Tk + key) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col;
      if (c >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + c) =
          __floats2bfloat162_rn(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + c) =
          __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap dmap,
                               const float* __restrict__ bias,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int H,
                               int Hkv, int Tq, int Tk, int D, float scale,
                               int causal, int shift) {
  using L = Layout<DP>;
  constexpr int NC = L::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int bkh = b * Hkv + h / (H / Hkv);
  // Causal skip as the loop's start: the first q tile whose last row
  // reaches this block's first key (global positions: query k0 - shift).
  const int iq_begin = causal ? max(0, k0 - shift) / BQ : 0;
  const int n_q = max(0, (Tq + BQ - 1) / BQ - iq_begin);
  const int tp = (Tq + BQ - 1) / BQ * BQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
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
      mbar_expect_tx(kv_full, 4 * NC * CH);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(smem + (w * NC + c) * CH, &kmap, kv_full, 64 * c,
                      k0 + 64 * w, bkh);
          tma_load_3d(smem + L::V + (w * NC + c) * CH, &vmap, kv_full,
                      64 * c, k0 + 64 * w, bkh);
        }
      for (int t = 0; t < n_q; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* st = smem + L::RING + s * L::STAGE;
        const int q0 = (iq_begin + t) * BQ;
        mbar_expect_tx(&full[s], L::TX);
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(st + c * CH, &qmap, &full[s], 64 * c, q0, bh);
          tma_load_3d(st + (NC + c) * CH, &dmap, &full[s], 64 * c, q0, bh);
        }
        const size_t at = (size_t)bh * tp + q0;
        bulk_load(st + 2 * NC * CH, lse + at, BQ * 4, &full[s]);
        bulk_load(st + 2 * NC * CH + BQ * 4, delta + at, BQ * 4, &full[s]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const float* bias_row =
        HAS_BIAS ? bias + (size_t)b * ((Tk + 127) / 128 * 128) : nullptr;
    consume<DP, HAS_BIAS>(smem, kv_full, full, empty, bias_row, dk, dv, bh,
                          k0, iq_begin, n_q, Tq, Tk, D, scale, causal,
                          shift);
  }
}

template <int DP, bool HAS_BIAS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, int B, int H,
                   int Hkv, int Tq, int Tk, int D, int causal, int shift,
                   float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dm;
  const uint64_t qdims[3] = {(uint64_t)D, (uint64_t)Tq, (uint64_t)B * H};
  const uint64_t kdims[3] = {(uint64_t)D, (uint64_t)Tk, (uint64_t)B * Hkv};
  const uint32_t box[3] = {64, 64, 1};
  if (!make_tensor_map(&qm, q, 3, qdims, box) ||
      !make_tensor_map(&km, k, 3, kdims, box) ||
      !make_tensor_map(&vm, v, 3, kdims, box) ||
      !make_tensor_map(&dm, dout, 3, qdims, box))
    return cudaErrorInvalidValue;
  const int smem = Layout<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<DP, HAS_BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BK - 1) / BK, H, B);
  flash_bwd_dkv_wgmma_kernel<DP, HAS_BIAS><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, dm, static_cast<const float*>(bias),
      static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Hkv, Tq, Tk, D, scale, causal,
      shift);
  return cudaGetLastError();
}

}  // namespace

// Same arguments as csrc/flash_bwd.cu's flash_bwd_dkv (offsets included),
// but lse and delta are [B*H, Tp] (padded to a multiple of 64 queries) and
// a non-null bias is [B, Tkp] (padded to a multiple of 128 keys); only
// bf16 (is_bf16 = 1) and D in {16, 32, 64, 128} are taken. Returns the
// CUDA error code of the launch (0 on success; cudaErrorInvalidValue for
// another dtype or D, or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int flash_bwd_dkv_wgmma(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int B, int H, int Hkv, int Tq, int Tk,
                                   int D, int causal, int q_offset,
                                   int kv_offset, int is_bf16, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  const int shift = q_offset - kv_offset;
#define HVD_DKV_LAUNCH(DP)                                                \
  return bias ? launch<DP, true>(q, k, v, bias, dout, lse, delta, dk, dv, \
                                 B, H, Hkv, Tq, Tk, D, causal, shift,     \
                                 scale, s)                                \
              : launch<DP, false>(q, k, v, bias, dout, lse, delta, dk,    \
                                  dv, B, H, Hkv, Tq, Tk, D, causal,       \
                                  shift, scale, s);
  if (D == 16 || D == 32 || D == 64) HVD_DKV_LAUNCH(64)
  if (D == 128) HVD_DKV_LAUNCH(128)
#undef HVD_DKV_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <int DP, bool HAS_BIAS>
int attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, flash_bwd_dkv_wgmma_kernel<DP, HAS_BIAS>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = Layout<DP>::BYTES;
  return 0;
}

// The compiled kernel for head dim D, with or without the bias: out =
// {registers per thread, local (spill) bytes per thread, static shared
// bytes, dynamic shared bytes}.
extern "C" int flash_bwd_wgmma_attrs(int D, int has_bias, int* out) {
  if (D == 128)
    return has_bias ? attrs<128, true>(out) : attrs<128, false>(out);
  return has_bias ? attrs<64, true>(out) : attrs<64, false>(out);
}
