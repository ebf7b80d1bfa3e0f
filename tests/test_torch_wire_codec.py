"""The port's plain wire codecs (``horovod_tpu_torch/ops/wire_codec.py``)
against the reference core's.

- int8: ``decode_scale(encode(x))`` bit for bit against the core's
  ``hvdtpu_int8_roundtrip`` (``csrc/ring_selftest.cc:411``, loaded from
  ``horovod_tpu/lib/libhvdtpu_core.so``) at a postscale of 1 and of 1/3,
  and the image's length against the length it returns (``Int8WireLen``:
  ``n + 4 * ceil(n / 256)`` a segment);
- bf16: the image's bits against the core's own ``EncodeBF16``
  (``csrc/ring_ops.cc``, ``csrc/half.h``'s ``FloatToBF16Bits``: round to
  nearest even, a NaN keeps its sign and payload and gains the quiet
  bit), with its SIMD path on and off, the NaN case also written out;
  the decode-scale and the decode-accumulate against the core's
  ``DecodeScaleBF16`` (``(float)((double)x * post)``) and
  ``DecodeAccumBF16``;
- int8: the image's bytes against the core's ``EncodeInt8`` and the
  decode-accumulate against its ``DecodeAccumInt8Span``;
- inputs from a numpy seed at lengths 0, 1, 255, 256, 257 and 1025, with
  +-0, +-inf, NaNs with payloads, denormals, an all-zero block and an
  all-denormal block;
- the multi-segment layouts the lane uses (records restart at each
  segment, packed images, padded gather slots) against the same
  functions run one segment at a time, and ``decode_accum`` of k images
  against k single adds.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import wire_codec as wc
from tests.utils_mp import REPO_ROOT

LENGTHS = (0, 1, 255, 256, 257, 1025)


@pytest.fixture(scope="module")
def lib():
    return ctypes.CDLL(os.path.join(REPO_ROOT, "horovod_tpu", "lib",
                                    "libhvdtpu_core.so"))


@pytest.fixture(scope="module")
def core(lib):
    fn = lib.hvdtpu_int8_roundtrip
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_double]
    fn.restype = ctypes.c_int64

    def roundtrip(x, post):
        x = np.ascontiguousarray(x, np.float32)
        out = np.zeros_like(x)
        wlen = fn(x.ctypes.data, x.size, out.ctypes.data, post)
        return wlen, out
    return roundtrip


class _CoreCodec:
    """The core's codec functions (``csrc/ring_ops.h``: C++ symbols of
    ``libhvdtpu_core.so``), on numpy arrays."""

    _P, _I64, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double

    def __init__(self, lib):
        self.lib = lib
        sig = {"_ZN6hvdtpu10EncodeBF16EPtPKfl": [self._P] * 2 + [self._I64],
               "_ZN6hvdtpu15DecodeAccumBF16EPfPKtl":
                   [self._P] * 2 + [self._I64],
               "_ZN6hvdtpu15DecodeScaleBF16EPfPKtld":
                   [self._P] * 2 + [self._I64, self._F64],
               "_ZN6hvdtpu10EncodeInt8EPhPKfl": [self._P] * 2 + [self._I64],
               "_ZN6hvdtpu19DecodeAccumInt8SpanEPfPKhlll":
                   [self._P] * 2 + [self._I64] * 3}
        self.fn = {}
        for symbol, args in sig.items():
            f = getattr(lib, symbol)
            f.argtypes, f.restype = args, None
            m = re.match(r"_ZN6hvdtpu(\d+)", symbol)
            self.fn[symbol[m.end():m.end() + int(m.group(1))]] = f
        lib.hvdtpu_set_simd_enabled.argtypes = [ctypes.c_int]

    def simd(self, on):
        self.lib.hvdtpu_set_simd_enabled(int(on))

    def encode_bf16(self, x):
        x = np.ascontiguousarray(x, np.float32)
        out = np.zeros(x.size, np.uint16)
        self.fn["EncodeBF16"](out.ctypes.data, x.ctypes.data, x.size)
        return out

    def decode_scale_bf16(self, bits, post):
        out = np.zeros(bits.size, np.float32)
        self.fn["DecodeScaleBF16"](out.ctypes.data, bits.ctypes.data,
                                   bits.size, post)
        return out

    def decode_accum_bf16(self, dst, bits):
        dst = dst.copy()
        self.fn["DecodeAccumBF16"](dst.ctypes.data, bits.ctypes.data,
                                   bits.size)
        return dst

    def encode_int8(self, x):
        x = np.ascontiguousarray(x, np.float32)
        out = np.zeros(wc.image_len(x.size, wc.INT8) if x.size else 0,
                       np.uint8)
        self.fn["EncodeInt8"](out.ctypes.data, x.ctypes.data, x.size)
        return out

    def decode_accum_int8(self, dst, img):
        dst = dst.copy()
        self.fn["DecodeAccumInt8Span"](dst.ctypes.data, img.ctypes.data, 0,
                                       img.size, dst.size)
        return dst


@pytest.fixture(scope="module")
def codec(lib):
    c = _CoreCodec(lib)
    yield c
    c.simd(True)


def _specials(n, seed):
    """Seeded values in [-2, 2] with the edge cases planted: +-0, +-inf,
    NaNs with payloads (quiet and signalling, both signs), denormals,
    one all-zero and one all-denormal record where the length allows."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, n).astype(np.float32)
    bits = x.view(np.uint32)
    plant = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001,
             0xFFC12345, 0x7F800001, 0xFF812345, 0x00000001, 0x807FFFFF,
             0x00400000, 0x3F808000, 0x3F818000, 0x7F7FFFFF]
    for i, b in enumerate(plant[:n]):
        bits[(i * 37) % n] = b
    if n >= 3 * wc.BLOCK:
        x[wc.BLOCK:2 * wc.BLOCK] = 0.0
        den = rng.integers(1, 1 << 23, wc.BLOCK).astype(np.uint32)
        den |= rng.integers(0, 2, wc.BLOCK).astype(np.uint32) << 31
        bits[2 * wc.BLOCK:3 * wc.BLOCK] = den
    return x


def _finite_only(x):
    return np.where(np.isfinite(x), x, np.float32(0.5))


def _bits(t):
    return t.numpy().view(np.uint32)


def _same_bits(got, want):
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("post", [1.0, 1.0 / 3.0])
@pytest.mark.parametrize("kind", ["specials", "finite"])
def test_int8_roundtrip_matches_the_core(core, n, post, kind):
    x = _specials(n, 1000 + n)
    if kind == "finite":
        x = _finite_only(x)
    wlen, want = core(x, post)
    img = wc.encode(torch.from_numpy(x), wc.INT8)
    assert img.dtype == torch.uint8 and img.numel() == wlen
    assert wlen == n + 4 * (-(-n // 256)) == wc.image_len(n, wc.INT8)
    got = wc.decode_scale(torch.zeros(n), img, wc.INT8, post=post)
    _same_bits(got.numpy(), want)


def test_int8_poison_and_degenerate_blocks(core):
    x = np.zeros(3 * 256 + 5, np.float32)
    x[10] = np.nan                       # record 0 poisoned
    x[256:512] = np.float32(1e-40)       # all-denormal: scale FLT_MIN
    x[600] = -np.inf                     # record 2 poisoned
    img = wc.encode(torch.from_numpy(x), wc.INT8).numpy()
    scales = [img[r * 260:r * 260 + 4].view(np.float32)[0] for r in range(4)]
    assert np.isnan(scales[0]) and np.isnan(scales[2])
    assert scales[1] == np.finfo(np.float32).tiny
    assert scales[3] == 1.0              # the all-zero tail record
    assert not img[4:260].any() and not img[2 * 260 + 4:3 * 260].any()
    got = wc.decode_scale(torch.zeros(x.size), torch.from_numpy(img),
                          wc.INT8).numpy()
    _same_bits(got, core(x, 1.0)[1])
    assert np.isnan(got[:256]).all() and np.isnan(got[512:768]).all()


@pytest.mark.parametrize("n", LENGTHS)
def test_int8_image_and_accumulate_match_the_core(codec, n):
    x = _specials(n, 3000 + n)
    img = wc.encode(torch.from_numpy(x), wc.INT8).numpy()
    np.testing.assert_array_equal(img, codec.encode_int8(x))
    acc = _finite_only(_specials(n, 3100 + n))
    got = wc.decode_accum(torch.from_numpy(acc.copy()), torch.from_numpy(img),
                          wc.INT8)
    _same_bits(got.numpy(), codec.decode_accum_int8(acc, img))


@pytest.mark.parametrize("simd", [True, False])
@pytest.mark.parametrize("n", LENGTHS)
def test_bf16_bits_follow_half_h(codec, n, simd):
    codec.simd(simd)
    x = _specials(n, 2000 + n)
    img = wc.encode(torch.from_numpy(x), wc.BF16).numpy()
    assert img.size == 2 * n
    np.testing.assert_array_equal(img.view(np.uint16), codec.encode_bf16(x))
    # The NaN case written out: sign and payload kept, quiet bit set.
    if n:
        y = np.array([0x7F800001, 0xFF812345, 0x7FC00001], np.uint32)
        got = wc.encode(torch.from_numpy(y.view(np.float32)), wc.BF16)
        np.testing.assert_array_equal(got.numpy().view(np.uint16),
                                      [0x7FC0, 0xFFC1, 0x7FC0])


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("post", [1.0, 1.0 / 3.0, 0.125])
def test_bf16_decode_scale_and_accum(codec, post, n):
    x = _specials(n, 7 + n)
    img = wc.encode(torch.from_numpy(x), wc.BF16)
    bits = img.numpy().view(np.uint16)
    for simd in (True, False):
        codec.simd(simd)
        got = wc.decode_scale(torch.zeros(n), img, wc.BF16, post=post)
        _same_bits(got.numpy(), codec.decode_scale_bf16(bits, post))
        acc = _finite_only(_specials(n, 8 + n))
        got = wc.decode_accum(torch.from_numpy(acc.copy()), img, wc.BF16)
        _same_bits(got.numpy(), codec.decode_accum_bf16(acc, bits))


def test_to_bfloat16_would_canonicalise_nans():
    # Why the plain version does the bit arithmetic: torch's cast drops
    # the payload.
    y = torch.from_numpy(np.array([0xFF812345], np.uint32).view(np.float32))
    cast = y.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    coded = wc.encode(y, wc.BF16).numpy().view(np.uint16)
    assert coded[0] == 0xFFC1 and cast[0] != coded[0]


@pytest.mark.parametrize("codec", [wc.BF16, wc.INT8])
@pytest.mark.parametrize("count,n", [(1025, 4), (7, 4), (3, 4), (513, 2),
                                     (2048, 3)])
def test_segment_layouts_match_one_segment_at_a_time(codec, count, n):
    x = _finite_only(_specials(count, count + n))
    seg = wc.Segments.even(count, n)
    assert [seg.count(i) for i in range(n)] == \
        [count // n + (i < count % n) for i in range(n)]
    src = torch.from_numpy(x)
    packed = wc.encode(src, codec, seg)
    assert packed.numel() == sum(wc.image_len(seg.count(i), codec)
                                 for i in range(n))
    pieces, stride = [], wc.image_len(seg.largest, codec)
    slots = torch.zeros(n * stride, dtype=torch.uint8)
    for i in range(n):
        part = src[seg.offset(i):seg.offset(i) + seg.count(i)]
        one = wc.encode(part.clone(), codec)
        pieces.append(one)
        slots[i * stride:i * stride + one.numel()] = one
    assert torch.equal(packed, torch.cat(pieces))
    for post in (1.0, 0.25):
        a = wc.decode_scale(torch.zeros(count), packed, codec, seg,
                            post=post)
        b = wc.decode_scale(torch.zeros(count), slots, codec, seg,
                            stride=stride, post=post)
        want = torch.cat([wc.decode_scale(torch.zeros(seg.count(i)), p,
                                          codec, post=post)
                          for i, p in enumerate(pieces)])
        _same_bits(a.numpy(), want.numpy())
        _same_bits(b.numpy(), want.numpy())


@pytest.mark.parametrize("codec", [wc.BF16, wc.INT8])
def test_rows_layout_and_k_images(codec):
    seg = wc.Segments.rows(5, 300, 2)         # rows 3 and 2 of 300
    assert (seg.count(0), seg.count(1), seg.total) == (900, 600, 1500)
    rng = np.random.default_rng(3)
    m, k = 700, 3
    imgs = [wc.encode(torch.from_numpy(
        rng.uniform(-2, 2, m).astype(np.float32)), codec) for _ in range(k)]
    base = rng.uniform(-2, 2, m).astype(np.float32)
    got = wc.decode_accum(torch.from_numpy(base.copy()), torch.cat(imgs),
                          codec, k)
    want = torch.from_numpy(base.copy())
    for img in imgs:
        want.add_(wc.decode_scale(torch.zeros(m), img, codec))
    _same_bits(got.numpy(), want.numpy())


def test_codec_arguments_are_checked():
    with pytest.raises(ValueError):
        wc.encode(torch.zeros(4), 3)
    with pytest.raises(ValueError):
        wc.image_len(4, 0)
