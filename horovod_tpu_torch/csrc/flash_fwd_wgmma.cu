// K1 on the tensor cores: flash-attention forward for bf16 on Hopper
// (sm_90a). The f32 route stays csrc/flash_fwd.cu.
//
// Replaces horovod_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas TPU
// kernel that _flash_fwd_impl reaches), with csrc/flash_fwd.cu's contract
// and numeric recipe: f32 scores scaled by D^-1/2 and then masked to
// -1e30 (causal and ragged keys), a running max that starts at -1e30,
// p = exp(s - m) summed un-rounded into l but cast UN-normalised to bf16
// for the PV product, f32 accumulation, o = acc / max(l, 1e-30),
// lse = m + log(l), exact zeros for a row whose max never left -1e30.
// GQA is native (kv head = h / n_rep); any T is taken. With a per-key
// bias (the TPU kernel's has_bias: BERT's padding mask) every score gets
// bias[b, key] added after the mask and before the max, on every tile.
//
// What bounds it on an H100: at the train shape (B4 H16 Hkv4 T2048 D128)
// the causal products are 69 GFLOP, 0.07 ms at 989 TFLOP/s, against
// 8.4 MB of q/k/v/o (0.003 ms): operations. The FMA kernel ran them at
// ~19 TFLOP/s from shared memory in f32.
//
// What this design does about it: both products run on wgmma (bf16 in,
// f32 accumulators in registers). A block of 384 threads takes 128 query
// rows: two consumer warpgroups of 64 rows each, raised to 232 registers a
// thread, and a producer warpgroup, cut to 40, whose first thread issues
// TMA loads. Q lands once; K and V tiles of 128 keys
// come through a two-stage ring tracked by mbarriers (full: bytes
// arrived; empty: both warpgroups done), so the next tile's copy overlaps
// this tile's products. Tensor maps are 3-D over [B*H(kv), T, D], so rows
// past T are zero-filled per head and never read the next head; head
// dims below 64 are padded to 64 by the same zero fill. S = Q K^T reads
// both operands K-major from shared memory; the online softmax runs on
// the accumulator fragment (row max and sum across the four lanes of a
// row); p is rounded to bf16 into wgmma's register A fragment and
// O += P V reads V MN-major (the transpose bit). Only diagonal and ragged
// tiles are masked; tiles past the causal limit are skipped whole, and
// the heaviest (last) q tiles are scheduled first. The bias variant
// (template flag HAS_BIAS; without it the kernel is the same code, with
// the same registers and shared memory) stages each kv tile's 128 bias
// floats in its ring stage by one bulk copy on the stage's barrier, and
// every consumer thread reads its 32 keys' values from there.
//
// Layout: q/o [B, H, T, D], k/v [B, Hkv, Tk, D] bf16, lse [B, H, T] f32,
// bias f32 [B, Tkp], Tkp = Tk rounded up to 128 (the caller pads, so each
// tile's 512 bytes are one aligned bulk copy), or null; all contiguous;
// D in {16, 32, 64, 128}.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hvd_torch;

constexpr int BQ = 128;                  // query rows per block
constexpr int BKV = 128;                 // keys per kv tile
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
constexpr int CHUNK = 128 * 64 * 2;      // [128 rows][64 cols] bf16 box

// Shared memory of a block for padded head dim DP: Q as DP/64 chunks of
// [128 rows][64 cols], then two stages of K chunks and V chunks (and,
// with a bias, the tile's bias row padded to 1024 bytes), then the
// barriers. Tiles are 1024-byte aligned (the base is aligned at run time).
template <int DP, bool HAS_BIAS>
struct Layout {
  static constexpr int NC = DP / 64;
  static constexpr int KV = NC * CHUNK;          // first stage
  static constexpr int BIAS = 2 * NC * CHUNK;    // a stage's bias row
  static constexpr int STAGE = BIAS + (HAS_BIAS ? 1024 : 0);
  static constexpr int TX = BIAS + (HAS_BIAS ? BKV * 4 : 0);  // bytes a stage
  static constexpr int BARS = KV + 2 * STAGE;    // q_full, full[2], empty[2]
  static constexpr int BYTES = BARS + 5 * 8 + 1024;
};

// Consumer warpgroup w = threadIdx.x / 128 of a block: query rows
// q0 + 64 w .. + 63, through the block's n_tiles kv tiles.
template <int DP, bool HAS_BIAS>
__device__ __forceinline__ void consume(
    uint8_t* smem, uint64_t* q_full, uint64_t* full, uint64_t* empty,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int bh, int q0,
    int n_tiles, int Tq, int Tk, int D, float scale, int causal) {
  using L = Layout<DP, HAS_BIAS>;
  constexpr int NC = L::NC;

  // This thread's rows in the fragment: row_a and row_a + 8 of the block.
  const int w = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;
  const int row_a = 64 * w + 16 * (tw / 32) + (tw % 32) / 4;
  const int col = 2 * (tw % 4);
  const uint8_t* qs = smem + w * (CHUNK / 2);  // its 64 rows of each chunk

  float acc[DP / 2], sc[64];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    mbar_wait(&full[s], (t >> 1) & 1);
    const uint8_t* ks = smem + L::KV + s * L::STAGE;
    const uint8_t* vs = ks + NC * CHUNK;
    const float* bias_s = reinterpret_cast<const float*>(ks + L::BIAS);

    // S = Q K^T over the head dim, 16 at a time.
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * CHUNK + (kk % 4) * 32;
      wgmma_m64n128k16_ss<0, 0>(sc, wgmma_desc(qs + off, 16, 1024),
                                wgmma_desc(ks + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Scale, then mask: only a tile that reaches past Tk or past this
    // warpgroup's first row (the diagonal) holds masked keys. The bias
    // goes on every tile, after the mask.
    const int k0 = t * BKV;
    const bool masked =
        k0 + BKV > Tk || (causal && k0 + BKV - 1 > q0 + 64 * w);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      float x = sc[i] * scale;
      if (masked) {
        const int kpos = k0 + 8 * (i / 4) + col + (i & 1);
        if (kpos >= Tk || (causal && kpos > q0 + row_a + 8 * r)) x = kNeg;
      }
      if constexpr (HAS_BIAS) x += bias_s[8 * (i / 4) + col + (i & 1)];
      sc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float p = __expf(sc[i] - m[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += p;
      sc[i] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
    // P in bf16, un-normalised: keys 16 kk .. 16 kk + 15 are fragment
    // columns-of-8 2 kk and 2 kk + 1, wgmma's A layout for k step kk.
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V, V read MN-major: the next 64 head dims lie CHUNK on.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t dv = wgmma_desc(vs + kk * 2048, CHUNK, 1024);
      if constexpr (DP == 128)
        wgmma_m64n128k16_rs<1>(acc, pa[kk], dv, 1);
      else
        wgmma_m64n64k16_rs<1>(acc, pa[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (tw % 32 == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = q0 + row_a + 8 * r;
    if (qrow >= Tq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    const bool valid = m[r] > kNeg / 2;
    __nv_bfloat16* orow = o + ((size_t)bh * Tq + qrow) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            valid ? acc[4 * j + 2 * r] / lr : 0.f,
            valid ? acc[4 * j + 2 * r + 1] / lr : 0.f);
    }
    if (tw % 4 == 0) lse[(size_t)bh * Tq + qrow] = m[r] + logf(lr);
  }
}

template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int Hkv, int Tq,
                           int Tk, int D, float scale, int causal) {
  using L = Layout<DP, HAS_BIAS>;
  constexpr int NC = L::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = q_full + 3;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int bkh = b * Hkv + h / (H / Hkv);
  // Causal whole-tile skip: tiles past the block's last row hold no valid
  // key for any of its rows.
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: lane 0 issues TMA; the others only give up
    // their registers to the consumers.
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, NC * CHUNK);
      for (int c = 0; c < NC; ++c)
        tma_load_3d(smem + c * CHUNK, &qmap, q_full, 64 * c, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t & 1;
        if (t >= 2) mbar_wait(&empty[s], ((t >> 1) - 1) & 1);
        uint8_t* st = smem + L::KV + s * L::STAGE;
        mbar_expect_tx(&full[s], L::TX);
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(st + c * CHUNK, &kmap, &full[s], 64 * c, t * BKV, bkh);
          tma_load_3d(st + (NC + c) * CHUNK, &vmap, &full[s], 64 * c,
                      t * BKV, bkh);
        }
        if constexpr (HAS_BIAS) {
          const int tkp = (Tk + BKV - 1) / BKV * BKV;
          bulk_load(st + L::BIAS, bias + (size_t)b * tkp + t * BKV, BKV * 4,
                    &full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    consume<DP, HAS_BIAS>(smem, q_full, full, empty, o, lse, bh, q0, n_tiles,
                          Tq, Tk, D, scale, causal);
  }
}

template <int DP, bool HAS_BIAS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* o, void* lse, int B, int H,
                   int Hkv, int Tq, int Tk, int D, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  const uint64_t qdims[3] = {(uint64_t)D, (uint64_t)Tq, (uint64_t)B * H};
  const uint64_t kdims[3] = {(uint64_t)D, (uint64_t)Tk, (uint64_t)B * Hkv};
  const uint32_t box[3] = {64, 128, 1};
  if (!make_tensor_map(&qm, q, 3, qdims, box) ||
      !make_tensor_map(&km, k, 3, kdims, box) ||
      !make_tensor_map(&vm, v, 3, kdims, box))
    return cudaErrorInvalidValue;
  const int smem = Layout<DP, HAS_BIAS>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DP, HAS_BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_wgmma_kernel<DP, HAS_BIAS><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Hkv, Tq,
      Tk, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Same arguments as csrc/flash_fwd.cu's flash_fwd, but a non-null bias is
// [B, Tkp] (padded to a multiple of 128 keys); only bf16 (is_bf16 = 1) and
// D in {16, 32, 64, 128} are taken. Returns the CUDA error code of the
// launch (0 on success; cudaErrorInvalidValue for another dtype or D, or
// a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int flash_fwd_wgmma(const void* q, const void* k, const void* v,
                               const void* bias, void* o, void* lse, int B,
                               int H, int Hkv, int Tq, int Tk, int D,
                               int causal, int is_bf16, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;
#define HVD_FWD_LAUNCH(DP)                                                  \
  return bias ? launch<DP, true>(q, k, v, bias, o, lse, B, H, Hkv, Tq, Tk, \
                                 D, causal, scale, s)                       \
              : launch<DP, false>(q, k, v, bias, o, lse, B, H, Hkv, Tq, Tk, \
                                  D, causal, scale, s);
  if (D == 16 || D == 32 || D == 64) HVD_FWD_LAUNCH(64)
  if (D == 128) HVD_FWD_LAUNCH(128)
#undef HVD_FWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <int DP, bool HAS_BIAS>
int attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, flash_fwd_wgmma_kernel<DP, HAS_BIAS>);
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
extern "C" int flash_fwd_wgmma_attrs(int D, int has_bias, int* out) {
  if (D == 128)
    return has_bias ? attrs<128, true>(out) : attrs<128, false>(out);
  return has_bias ? attrs<64, true>(out) : attrs<64, false>(out);
}
