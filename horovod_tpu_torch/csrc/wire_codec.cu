// The lane's wire codecs for Hopper (sm_90a): bf16 and the EQuARX int8
// blockwise-scaled codec (arXiv:2506.17615).
//
// Replaces no TPU kernel: these are the counterparts of the reference
// core's host codecs, csrc/ring_ops.cc:160-300 (EncodeBF16,
// DecodeAccumBF16, DecodeScaleBF16, EncodeInt8, DecodeAccumInt8Span,
// DecodeScaleInt8Span) and csrc/half.h:80-90 (FloatToBF16Bits,
// BF16BitsToFloat). The compressed allreduce and reducescatter of the
// port's lane (common/data_plane.py) run them on every f32 gradient byte
// of a compressed response, between its NCCL calls.
//
// Wire images. bf16: 2 bytes an element, little-endian. int8: per
// segment, records of [f32 scale, little-endian | up to 256 int8 quants]
// (the segment's last record holds the remainder), so a segment of n
// elements takes n + 4 * ceil(n / 256) bytes; records restart at every
// segment's start. A multi-segment buffer follows the lane's segment
// layout: nseg segments, the first n_big of `big` elements and the rest
// of `small` (the q + 1 / q split of the ring's segments and of
// reducescatter's rows). Encoded images are packed one after another;
// a decode reads segment i at i * wstride (an all_gather's padded
// slots), or packed when wstride is 0.
//
// Bits: the same as the reference's scalar code on x86-64. Division is
// IEEE (__fdiv_rn), rounding of a quotient to an integer is rint (ties
// to even, as nearbyintf), and the decode's multiply and add are
// __fmul_rn and __fadd_rn so that nvcc cannot contract them into an FMA
// (g++ -O2 without -mfma rounds twice). No fast math.
//
// What bounds them on an H100: bytes. Each element is read and written
// once, with a handful of integer or float operations: a 64 MiB f32
// bucket encodes to bf16 in (64 + 32) MiB of traffic, ~0.030 ms at
// 3.35 TB/s. Design: grid-stride loops over elements (bf16) or one warp
// per 256-element record (int8: the record's amax is a warp reduction,
// its finiteness a warp vote), neighbouring lanes on neighbouring
// elements. A simple kernel first; its times are in PERF.md.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int64_t kBlock = 256;      // csrc/ring_ops.h kInt8CodecBlock
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kFltMinBits = 0x00800000u;   // FLT_MIN

struct Layout {
  int64_t nseg, n_big, big, small;

  __device__ int64_t elems() const {
    return n_big * big + (nseg - n_big) * small;
  }
};

__device__ __forceinline__ int64_t records(int64_t n) {
  return (n + kBlock - 1) / kBlock;
}

__device__ __forceinline__ int64_t int8_len(int64_t n) {
  return n + 4 * records(n);
}

// The segment of element e: (segment, index within it).
__device__ __forceinline__ void locate(const Layout& L, int64_t e,
                                       int64_t* seg, int64_t* j) {
  const int64_t nb = L.n_big * L.big;
  if (e < nb) {
    *seg = e / L.big;
    *j = e % L.big;
  } else {
    *seg = L.n_big + (e - nb) / L.small;
    *j = (e - nb) % L.small;
  }
}

// One int8 record g of the layout: its segment's first element and
// length, the record's first element within it, and the segment's wire
// offset (packed, or i * wstride).
struct Record {
  int64_t elem0, m, wire;
};

__device__ __forceinline__ Record int8_record(const Layout& L, int64_t g,
                                              int64_t wstride) {
  const int64_t rb = records(L.big), rs = records(L.small);
  int64_t seg, r, len, first, wpacked;
  if (g < L.n_big * rb) {
    seg = g / rb;
    r = g % rb;
    len = L.big;
    first = seg * L.big;
    wpacked = seg * int8_len(L.big);
  } else {
    const int64_t g2 = g - L.n_big * rb;
    seg = L.n_big + g2 / rs;
    r = g2 % rs;
    len = L.small;
    first = L.n_big * L.big + (seg - L.n_big) * L.small;
    wpacked = L.n_big * int8_len(L.big) +
              (seg - L.n_big) * int8_len(L.small);
  }
  const int64_t e0 = r * kBlock;
  Record rec;
  rec.elem0 = first + e0;
  rec.m = min(kBlock, len - e0);
  rec.wire = (wstride > 0 ? seg * wstride : wpacked) + r * (4 + kBlock);
  return rec;
}

__device__ __forceinline__ int64_t total_records(const Layout& L) {
  return L.n_big * records(L.big) + (L.nseg - L.n_big) * records(L.small);
}

// ---- bf16 ---------------------------------------------------------------

__device__ __forceinline__ uint16_t to_bf16_bits(float x) {
  uint32_t f = __float_as_uint(x);
  if ((f & 0x7F800000u) == 0x7F800000u && (f & 0x7FFFFFu)) {
    return (uint16_t)((f >> 16) | 0x40u);  // quiet NaN, sign and payload
  }
  const uint32_t lsb = (f >> 16) & 1u;     // round to nearest even
  f += 0x7FFFu + lsb;
  return (uint16_t)(f >> 16);
}

__device__ __forceinline__ float from_bf16_bits(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

__device__ __forceinline__ float scaled(float v, double post) {
  return post == 1.0 ? v : __double2float_rn(__dmul_rn((double)v, post));
}

__global__ void encode_bf16(const float* __restrict__ src,
                            uint16_t* __restrict__ dst, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    dst[i] = to_bf16_bits(src[i]);
  }
}

// dst[i] += each of k images in order (image t at t * m).
__global__ void decode_accum_bf16(float* __restrict__ dst,
                                  const uint16_t* __restrict__ src,
                                  int64_t m, int64_t k) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = dst[i];
    for (int64_t t = 0; t < k; t++) {
      acc = __fadd_rn(acc, from_bf16_bits(src[t * m + i]));
    }
    dst[i] = acc;
  }
}

__global__ void decode_scale_bf16(float* __restrict__ dst,
                                  const uint8_t* __restrict__ src, Layout L,
                                  int64_t wstride, double post) {
  const int64_t n = L.elems();
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    int64_t off = 2 * e;
    if (wstride > 0) {
      int64_t seg, j;
      locate(L, e, &seg, &j);
      off = seg * wstride + 2 * j;
    }
    const uint16_t b = (uint16_t)src[off] | ((uint16_t)src[off + 1] << 8);
    dst[e] = scaled(from_bf16_bits(b), post);
  }
}

// ---- int8 ---------------------------------------------------------------

__device__ __forceinline__ float load_scale(const uint8_t* p) {
  const uint32_t u = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                     ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  return __uint_as_float(u);
}

// One warp per record: amax by a warp reduction, finiteness by a vote.
__global__ void encode_int8(const float* __restrict__ src,
                            uint8_t* __restrict__ dst, Layout L) {
  const int lane = threadIdx.x % 32;
  const int64_t nrec = total_records(L);
  for (int64_t g = blockIdx.x * (int64_t)kWarps + threadIdx.x / 32;
       g < nrec; g += (int64_t)gridDim.x * kWarps) {
    const Record rec = int8_record(L, g, 0);
    const float* x = src + rec.elem0;
    float amax = 0.0f;
    bool finite = true;
    for (int64_t i = lane; i < rec.m; i += 32) {
      const float v = x[i];
      finite = finite && isfinite(v);
      amax = fmaxf(amax, fabsf(v));
    }
    finite = __all_sync(0xffffffffu, finite);
    for (int s = 16; s > 0; s >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, s));
    }
    uint8_t* out = dst + rec.wire;
    float scale;
    if (!finite) {
      // Poison: a NaN scale and zero quants decode to NaN everywhere.
      scale = __uint_as_float(0x7FC00000u);
    } else {
      const float flt_min = __uint_as_float(kFltMinBits);
      scale = amax > 0.0f ? fmaxf(__fdiv_rn(amax, 127.0f), flt_min) : 1.0f;
    }
    if (lane < 4) out[lane] = (uint8_t)(__float_as_uint(scale) >> (8 * lane));
    for (int64_t i = lane; i < rec.m; i += 32) {
      float q = 0.0f;
      if (finite) {
        q = fminf(fmaxf(rintf(__fdiv_rn(x[i], scale)), -127.0f), 127.0f);
      }
      out[4 + i] = (uint8_t)(int8_t)q;
    }
  }
}

// dst (one segment of m elements) += each of k images in order (image
// t at t * int8_len(m)).
__global__ void decode_accum_int8(float* __restrict__ dst,
                                  const uint8_t* __restrict__ src,
                                  int64_t m, int64_t k) {
  const int lane = threadIdx.x % 32;
  const Layout one{1, 1, m, m};
  const int64_t nrec = records(m), stride = int8_len(m);
  for (int64_t g = blockIdx.x * (int64_t)kWarps + threadIdx.x / 32;
       g < nrec; g += (int64_t)gridDim.x * kWarps) {
    const Record rec = int8_record(one, g, 0);
    for (int64_t i = lane; i < rec.m; i += 32) {
      float acc = dst[rec.elem0 + i];
      for (int64_t t = 0; t < k; t++) {
        const uint8_t* p = src + t * stride + rec.wire;
        acc = __fadd_rn(acc, __fmul_rn(load_scale(p),
                                       (float)(int8_t)p[4 + i]));
      }
      dst[rec.elem0 + i] = acc;
    }
  }
}

__global__ void decode_scale_int8(float* __restrict__ dst,
                                  const uint8_t* __restrict__ src, Layout L,
                                  int64_t wstride, double post) {
  const int lane = threadIdx.x % 32;
  const int64_t nrec = total_records(L);
  for (int64_t g = blockIdx.x * (int64_t)kWarps + threadIdx.x / 32;
       g < nrec; g += (int64_t)gridDim.x * kWarps) {
    const Record rec = int8_record(L, g, wstride);
    const uint8_t* p = src + rec.wire;
    const float scale = load_scale(p);
    for (int64_t i = lane; i < rec.m; i += 32) {
      dst[rec.elem0 + i] =
          scaled(__fmul_rn(scale, (float)(int8_t)p[4 + i]), post);
    }
  }
}

int blocks_for(int64_t work, int per_block) {
  const int64_t b = (work + per_block - 1) / per_block;
  return (int)(b < 1 ? 1 : (b > 132 * 32 ? 132 * 32 : b));
}

bool bad_layout(int64_t nseg, int64_t n_big, int64_t big, int64_t small) {
  return nseg < 1 || n_big < 0 || n_big > nseg || big < 0 || small < 0;
}

}  // namespace

// codec: 1 bf16, 2 int8. Each entry returns cudaGetLastError() after its
// launch (cudaErrorInvalidValue for bad arguments, nothing launched).

extern "C" int wire_encode(const void* src, void* dst, int codec,
                           int64_t nseg, int64_t n_big, int64_t big,
                           int64_t small, void* stream) {
  if (bad_layout(nseg, n_big, big, small) || (codec != 1 && codec != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L{nseg, n_big, big, small};
  const int64_t n = n_big * big + (nseg - n_big) * small;
  if (codec == 1) {
    encode_bf16<<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        static_cast<const float*>(src), static_cast<uint16_t*>(dst), n);
  } else {
    const int64_t nrec = n_big * ((big + kBlock - 1) / kBlock) +
                         (nseg - n_big) * ((small + kBlock - 1) / kBlock);
    encode_int8<<<blocks_for(nrec, kWarps), kThreads, 0, s>>>(
        static_cast<const float*>(src), static_cast<uint8_t*>(dst), L);
  }
  return (int)cudaGetLastError();
}

extern "C" int wire_decode_accum(void* dst, const void* src, int codec,
                                 int64_t m, int64_t k, void* stream) {
  if (m < 0 || k < 0 || (codec != 1 && codec != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (codec == 1) {
    decode_accum_bf16<<<blocks_for(m, kThreads), kThreads, 0, s>>>(
        static_cast<float*>(dst), static_cast<const uint16_t*>(src), m, k);
  } else {
    decode_accum_int8<<<blocks_for((m + kBlock - 1) / kBlock, kWarps),
                        kThreads, 0, s>>>(
        static_cast<float*>(dst), static_cast<const uint8_t*>(src), m, k);
  }
  return (int)cudaGetLastError();
}

extern "C" int wire_decode_scale(void* dst, const void* src, int codec,
                                 int64_t nseg, int64_t n_big, int64_t big,
                                 int64_t small, int64_t wstride, double post,
                                 void* stream) {
  if (bad_layout(nseg, n_big, big, small) || wstride < 0 ||
      (codec != 1 && codec != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L{nseg, n_big, big, small};
  const int64_t n = n_big * big + (nseg - n_big) * small;
  if (codec == 1) {
    decode_scale_bf16<<<blocks_for(n, kThreads), kThreads, 0, s>>>(
        static_cast<float*>(dst), static_cast<const uint8_t*>(src), L,
        wstride, post);
  } else {
    const int64_t nrec = n_big * ((big + kBlock - 1) / kBlock) +
                         (nseg - n_big) * ((small + kBlock - 1) / kBlock);
    decode_scale_int8<<<blocks_for(nrec, kWarps), kThreads, 0, s>>>(
        static_cast<float*>(dst), static_cast<const uint8_t*>(src), L,
        wstride, post);
  }
  return (int)cudaGetLastError();
}
