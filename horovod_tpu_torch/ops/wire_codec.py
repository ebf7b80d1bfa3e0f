"""The lane's wire codecs: bf16 and the int8 blockwise-scaled codec.

Counterparts of the reference core's host codecs
(``csrc/ring_ops.cc:160-300``, ``csrc/half.h:80-90``), which narrow the
wire of an f32 Sum or Average allreduce or reducescatter while every
sum stays in f32 (``docs/wire.md``). Each function runs its kernel
(``csrc/wire_codec.cu``) on a CUDA tensor and its plain PyTorch version,
the same bits by the same arithmetic, on a CPU tensor; there is no
fallback from one to the other.

- bf16 (codec 1): each f32 to the top 16 bits, rounded to nearest even;
  a NaN keeps its sign and payload and gains the quiet bit
  (``(f >> 16) | 0x40``). ``tensor.to(torch.bfloat16)`` canonicalises
  NaNs, so the plain version does the bit arithmetic itself.
- int8 (codec 2, EQuARX): per segment, records of ``[f32 scale | up to
  256 int8]``; ``scale = max(amax / 127, FLT_MIN)`` (1 when amax is 0),
  ``q = rint(x / scale)`` clamped to +-127; a record holding a non-finite
  value is poisoned (NaN scale, zero quants). A segment of n elements
  takes ``n + 4 * ceil(n / 256)`` bytes (``Int8WireLen``).

Images are ``uint8`` tensors. A buffer is cut into segments by a
:class:`Segments` layout (the lane's q + 1 / q split); :func:`encode`
writes the segments' images packed, :func:`decode_scale` reads segment
i at ``i * stride`` (an all_gather's padded slots) or packed, and
:func:`decode_accum` adds k images of one segment into it in order.
Decoding is ``scale * q`` then a separate add (two roundings, no FMA);
a postscale is ``f32(f64(x) * post)``, a plain copy when ``post == 1``.

:data:`launches` counts each kernel's launches (CUDA tensors only).
"""

import collections
import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from horovod_tpu_torch._device import current_stream_ptr, kernel_or_plain
from horovod_tpu_torch.ops import _build

BF16, INT8 = 1, 2
CODEC_NAMES = {0: "off", BF16: "bf16", INT8: "int8"}
BLOCK = 256                     # elements a record (kInt8CodecBlock)
_FLT_MIN = torch.finfo(torch.float32).tiny
KERNELS = ("encode_bf16", "decode_accum_bf16", "decode_scale_bf16",
           "encode_int8", "decode_accum_int8", "decode_scale_int8")
launches = collections.Counter({k: 0 for k in KERNELS})
_count_lock = threading.Lock()


def image_len(n, codec):
    """Wire bytes of one segment of ``n`` f32 elements."""
    if codec == BF16:
        return 2 * n
    if codec == INT8:
        return n + 4 * (-(-n // BLOCK)) if n > 0 else 0
    raise ValueError(f"unknown wire codec {codec}")


class Segments(NamedTuple):
    """``nseg`` segments, the first ``n_big`` of ``big`` elements and the
    rest of ``small``."""

    nseg: int
    n_big: int
    big: int
    small: int

    @classmethod
    def even(cls, count, n):
        """``count`` elements over ``n`` segments, the remainder to the
        lower ones (the ring's segments)."""
        q, r = divmod(count, n)
        return cls(n, r, q + 1, q)

    @classmethod
    def rows(cls, nrows, row, n):
        """``nrows`` rows of ``row`` elements over ``n`` segments, the
        remainder rows to the lower ones (reducescatter's split)."""
        q, r = divmod(nrows, n)
        return cls(n, r, (q + 1) * row, q * row)

    @classmethod
    def one(cls, n):
        return cls(1, 1, n, n)

    def count(self, i):
        return self.big if i < self.n_big else self.small

    def offset(self, i):
        return i * self.big if i <= self.n_big else \
            self.n_big * self.big + (i - self.n_big) * self.small

    @property
    def total(self):
        return self.n_big * self.big + (self.nseg - self.n_big) * self.small

    @property
    def largest(self):
        return self.big if self.n_big else self.small

    def image_bytes(self, codec):
        """Bytes of all the segments' images, packed."""
        return self.n_big * image_len(self.big, codec) + \
            (self.nseg - self.n_big) * image_len(self.small, codec)


# ---- the plain versions ----------------------------------------------------


def _bf16_bits(x):
    """f32 -> the bf16 codec's 16 bits, as int64 in [0, 65535]."""
    f = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    nan = ((f & 0x7F800000) == 0x7F800000) & ((f & 0x7FFFFF) != 0)
    rne = (f + 0x7FFF + ((f >> 16) & 1)) >> 16
    return torch.where(nan, (f >> 16) | 0x40, rne) & 0xFFFF


def _bf16_image(x):
    bits = _bf16_bits(x.reshape(-1))
    return torch.where(bits >= 1 << 15, bits - (1 << 16), bits).to(
        torch.int16).view(torch.uint8)


def _bf16_values(img):
    return img.contiguous().view(torch.int16).to(torch.int32) \
        .bitwise_left_shift(16).view(torch.float32)


def _int8_image(x):
    """[c, m] f32 -> [c, image_len(m)] bytes, one segment a row."""
    c, m = x.shape
    if m == 0:
        return torch.empty((c, 0), dtype=torch.uint8, device=x.device)
    nrec = -(-m // BLOCK)
    xr = torch.zeros((c, nrec * BLOCK), dtype=torch.float32,
                     device=x.device)
    xr[:, :m] = x
    xr = xr.view(c, nrec, BLOCK)
    finite = torch.isfinite(xr).all(-1)
    amax = xr.abs().amax(-1)
    # A tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which rounds differently from IEEE division.
    scale = torch.where(
        amax > 0, torch.clamp_min(amax / torch.full_like(amax, 127.0),
                                  _FLT_MIN), torch.ones_like(amax))
    scale = torch.where(finite, scale, torch.full_like(scale, float("nan")))
    q = torch.round(xr / torch.where(finite, scale, 1.0)[..., None])
    q = torch.where(finite[..., None], q.clamp(-127, 127), 0.0)
    rec = torch.cat([scale[..., None].view(torch.uint8),
                     q.to(torch.int8).view(torch.uint8)], -1)
    return rec.view(c, nrec * (4 + BLOCK))[:, :image_len(m, INT8)]


def _int8_values(img, m):
    """[c, image_len(m)] bytes -> [c, m] f32 (``scale * q``)."""
    c = img.shape[0]
    if m == 0:
        return torch.empty((c, 0), dtype=torch.float32, device=img.device)
    nrec = -(-m // BLOCK)
    rec = torch.zeros((c, nrec * (4 + BLOCK)), dtype=torch.uint8,
                      device=img.device)
    rec[:, :img.shape[1]] = img
    rec = rec.view(c, nrec, 4 + BLOCK)
    scale = rec[..., :4].contiguous().view(torch.float32)
    q = rec[..., 4:].contiguous().view(torch.int8).to(torch.float32)
    return (scale * q).view(c, nrec * BLOCK)[:, :m]


def _groups(seg):
    """The layout's two runs of equal segments: (first segment, count,
    length)."""
    return [(0, seg.n_big, seg.big),
            (seg.n_big, seg.nseg - seg.n_big, seg.small)]


def _encode_plain(src, out, codec, seg):
    if codec == BF16:
        out.copy_(_bf16_image(src))
        return out
    pos = 0
    for first, c, m in _groups(seg):
        if c == 0 or m == 0:
            continue
        x = src[seg.offset(first):seg.offset(first) + c * m].view(c, m)
        img = _int8_image(x)
        out[pos:pos + img.numel()].copy_(img.reshape(-1))
        pos += img.numel()
    return out


def _values(images, codec, m):
    """[k, image_len(m)] bytes -> [k, m] f32."""
    if codec == BF16:
        return _bf16_values(images.reshape(-1)).view(images.shape[0], m)
    return _int8_values(images, m)


def _decode_accum_plain(dst, images, codec, k):
    if k == 0 or dst.numel() == 0:
        return dst
    m = dst.numel()
    vals = _values(images[:k * image_len(m, codec)].view(k, -1), codec, m)
    for t in range(k):
        dst.add_(vals[t])
    return dst


def _decode_scale_plain(dst, src, codec, seg, stride, post):
    pos = 0
    for first, c, m in _groups(seg):
        if c == 0 or m == 0:
            continue
        w = image_len(m, codec)
        if stride:
            img = src[first * stride:(first + c) * stride].view(c, stride)
            img = img[:, :w]
        else:
            img = src[pos:pos + c * w].view(c, w)
            pos += c * w
        vals = _values(img, codec, m)
        if post != 1.0:
            vals = (vals.double() * post).float()
        dst[seg.offset(first):seg.offset(first) + c * m].copy_(
            vals.reshape(-1))
    return dst


# ---- the kernels ------------------------------------------------------------


_P, _I, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                  ctypes.c_double)


@functools.cache
def _bind(function, argtypes):
    fn = getattr(_build.load("wire_codec"), function)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _check(label, t, dtype, numel):
    if t.dtype != dtype or not t.is_contiguous() or t.numel() < numel:
        raise ValueError(f"{label} takes a contiguous {dtype} tensor of at "
                         f"least {numel} elements, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _run(kernel, device, fn, *args):
    with torch.cuda.device(device):
        err = fn(*args, current_stream_ptr(device.index))
    if err:
        raise RuntimeError(f"wire codec {kernel} launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        launches[kernel] += 1


def _encode_cuda(src, out, codec, seg):
    _check("encode", src, torch.float32, seg.total)
    _check("encode", out, torch.uint8, seg.image_bytes(codec))
    if seg.total:
        _run(f"encode_{CODEC_NAMES[codec]}", src.device,
             _bind("wire_encode", (_P, _P, _I, _L, _L, _L, _L, _P)),
             src.data_ptr(), out.data_ptr(), codec, *seg)
    return out


def _decode_accum_cuda(dst, images, codec, k):
    m = dst.numel()
    _check("decode_accum", dst, torch.float32, m)
    _check("decode_accum", images, torch.uint8, k * image_len(m, codec))
    if k and m:
        _run(f"decode_accum_{CODEC_NAMES[codec]}", dst.device,
             _bind("wire_decode_accum", (_P, _P, _I, _L, _L, _P)),
             dst.data_ptr(), images.data_ptr(), codec, m, k)
    return dst


def _decode_scale_cuda(dst, src, codec, seg, stride, post):
    _check("decode_scale", dst, torch.float32, seg.total)
    _check("decode_scale", src, torch.uint8,
           seg.nseg * stride if stride else seg.image_bytes(codec))
    if seg.total:
        _run(f"decode_scale_{CODEC_NAMES[codec]}", dst.device,
             _bind("wire_decode_scale",
                   (_P, _P, _I, _L, _L, _L, _L, _L, _D, _P)),
             dst.data_ptr(), src.data_ptr(), codec, *seg, stride,
             float(post))
    return dst


# ---- the entry points ---------------------------------------------------------


def _codec_arg(codec):
    if codec not in (BF16, INT8):
        raise ValueError(f"wire codec must be 1 (bf16) or 2 (int8), got "
                         f"{codec}")
    return codec


def encode(src, codec, seg=None):
    """The packed images of the 1-D f32 ``src`` cut by ``seg`` (one
    segment by default): a new uint8 tensor on ``src``'s device."""
    seg = seg or Segments.one(src.numel())
    out = torch.empty(seg.image_bytes(_codec_arg(codec)), dtype=torch.uint8,
                      device=src.device)
    return kernel_or_plain("wire encode", src, _encode_cuda, _encode_plain,
                           out, codec, seg)


def decode_accum(dst, images, codec, k=1):
    """In place on the 1-D f32 ``dst`` (one segment): add the ``k``
    images of ``images`` (each ``image_len(dst.numel())`` bytes), in
    order."""
    return kernel_or_plain("wire decode_accum", dst, _decode_accum_cuda,
                           _decode_accum_plain, images, _codec_arg(codec), k)


def decode_scale(dst, src, codec, seg=None, stride=0, post=1.0):
    """In place on the 1-D f32 ``dst``: each segment of ``seg`` decoded
    from ``src`` (segment i at ``i * stride``, or packed when ``stride``
    is 0) and scaled by ``post``."""
    seg = seg or Segments.one(dst.numel())
    return kernel_or_plain("wire decode_scale", dst, _decode_scale_cuda,
                           _decode_scale_plain, src, _codec_arg(codec), seg,
                           int(stride), float(post))
