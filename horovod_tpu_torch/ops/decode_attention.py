"""Single-position decode attention on the hand-written K4 kernels.

Counterpart of horovod_tpu/ops/decode_attention.py. The TPU module's
Pallas ``_kernel`` becomes K4, launched by :func:`_decode_attention_cuda`
along the route :func:`decode_route` picks from the dtype: bf16 on
``csrc/decode_attention_wgmma.cu`` (one launch: a thread-block cluster
per (batch, kv head), both products on wgmma), f32 on
``csrc/decode_attention.cu`` (three passes on FMA).
:func:`_decode_attention_reference` is their plain PyTorch version (the
counterpart of the JAX ``_decode_attention_xla``), used for tensors on
the CPU and as the kernels' yardstick on the card. Unlike the TPU
kernel, K4 covers any cache length: it splits S across blocks instead of
falling back to an einsum past a memory budget.

:func:`decode_attention_ragged` (the continuous-batching step's
attention) was an einsum chain on every platform in the JAX package,
not a Pallas kernel; it stays plain PyTorch here.

Numeric recipe (both functions): f32 scores and softmax, p normalised
and then cast to the value dtype, f32-accumulated PV.
"""

import ctypes
import functools

import torch

from horovod_tpu_torch._device import (
    current_stream_ptr,
    dtype_route,
    kernel_or_plain,
    pick_route,
)
from horovod_tpu_torch.ops import _build

_NEG = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_REP = 16
_CHUNK = 128   # cache slots per block of the FMA kernel's passes
_TILE = 64     # cache slots per tile of the wgmma kernel
_WGMMA_HEAD_DIMS = (16, 32, 64, 128, 256)
# n_rep x slice slots of scores one wgmma block holds in shared memory
# (csrc/decode_attention_wgmma.cu SCORE_FLOATS); beyond, an f32 scratch.
_SCORE_FLOATS = 8192


def _softmax(s):
    """exp(s - max) / sum, divided explicitly as the TPU kernel and
    jax.nn.softmax do."""
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def _decode_attention_reference(q, cache_k, cache_v, pos):
    """Plain version of K4. q [B, 1, H, D]; cache_k/v [B, Hkv, S, D];
    slots <= pos valid. Returns [B, 1, H, D] in q's dtype."""
    b, _, hq, d = q.shape
    hkv, s_len = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bgrd,bgsd->bgrs", qg, cache_k.float()) * (d ** -0.5)
    valid = torch.arange(s_len, device=q.device) <= int(pos)
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    p = _softmax(s).to(cache_v.dtype)
    out = torch.einsum("bgrs,bgsd->bgrd", p.float(), cache_v.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _check_kernel_inputs(q, cache_k, cache_v, pos):
    if not (q.is_cuda and cache_k.device == q.device
            and cache_v.device == q.device):
        raise ValueError("K4 needs q and the caches on one CUDA device")
    if q.dtype not in _DTYPES or cache_k.dtype != q.dtype \
            or cache_v.dtype != q.dtype:
        raise ValueError(f"K4 takes float32 or bfloat16 inputs of one "
                         f"dtype, got {q.dtype}/{cache_k.dtype}/"
                         f"{cache_v.dtype}")
    b, one, hq, d = q.shape
    if one != 1 or cache_k.shape != cache_v.shape or cache_k.dim() != 4 \
            or cache_k.shape[0] != b or cache_k.shape[3] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} cache "
                         f"{tuple(cache_k.shape)}")
    hkv = cache_k.shape[1]
    if hq % hkv or hq // hkv > _MAX_REP:
        raise ValueError(f"K4 takes up to {_MAX_REP} query heads per kv "
                         f"head, got {hq} over {hkv}")
    if d > 256 or 256 % d:
        raise ValueError(f"K4 takes a head_dim dividing 256, got {d}")
    if pos < 0 or cache_k.shape[2] < 1:
        raise ValueError(f"K4 needs pos >= 0 and a non-empty cache, got "
                         f"pos {pos}, S {cache_k.shape[2]}")
    if not (q.is_contiguous() and cache_k.is_contiguous()
            and cache_v.is_contiguous()):
        raise ValueError("K4 takes contiguous q and caches")


def decode_route(dtype, head_dim):
    """The K4 kernel that takes (dtype, head_dim): ``"wgmma"``
    (csrc/decode_attention_wgmma.cu) for bfloat16 at head_dim 16-256
    dividing 256, ``"fma"`` (csrc/decode_attention.cu) for float32; a
    ValueError for anything else."""
    route = dtype_route("K4", dtype)
    if route == "wgmma" and head_dim not in _WGMMA_HEAD_DIMS:
        raise ValueError(f"K4 takes bfloat16 head_dim in "
                         f"{_WGMMA_HEAD_DIMS}, got {head_dim}")
    return route


@functools.cache
def _bind(name, argtypes):
    """The ctypes entry ``name`` of csrc/<source>.cu, bound once:
    ``name`` is "<source>.<function>"."""
    source, function = name.split(".")
    fn = getattr(_build.load(source), function)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FMA_ARGS = (_P,) * 7 + (_I,) * 8 + (_F, _P)
_WGMMA_ARGS = (_P,) * 5 + (_I,) * 8 + (_F, _P)


@functools.cache
def _card(device_index, n_rep, head_dim):
    """(SMs, clusters): the card's SM count, and how many clusters of 1,
    2, 4, 8 and 16 blocks of the wgmma kernel for (n_rep, head_dim) it
    holds at once."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device_index):
        err = _bind("decode_attention_wgmma.decode_attention_wgmma_clusters",
                    (_I, _I, ctypes.POINTER(ctypes.c_int)))(
            n_rep, head_dim, out)
    if err:
        raise RuntimeError(f"K4 cluster query failed: CUDA error {err}")
    sms = torch.cuda.get_device_properties(
        device_index).multi_processor_count
    return sms, tuple(out)


def _decode_plan(pairs, n_rep, n_valid, sms, clusters):
    """(cluster, tiles_per_block, spill) of the wgmma kernel, from shapes
    and the card alone: per (batch, kv head) a cluster of C blocks, C the
    largest power of two up to 16 such that the ``pairs`` clusters fill
    at most the card's ``sms`` and all fit at once (``clusters[i]``
    clusters of 2^i blocks do), and no more blocks than 64-slot tiles;
    each block takes ``tiles_per_block`` tiles. ``spill``: a block's
    scores (n_rep x its slots) outgrow its shared memory and go to an f32
    scratch."""
    n_tiles = -(-n_valid // _TILE)
    c, i = 1, 0
    while i + 1 < len(clusters) and pairs * c * 2 <= sms \
            and pairs <= clusters[i + 1] and c * 2 <= n_tiles:
        c, i = c * 2, i + 1
    tpb = -(-n_tiles // c)
    return c, tpb, n_rep * tpb * _TILE > _SCORE_FLOATS


def _decode_attention_cuda(q, cache_k, cache_v, pos, route=None):
    """Launch K4 on the current stream, by :func:`decode_route` unless
    ``route`` names one ("fma" also takes bfloat16: the earlier kernel,
    kept as the wgmma kernel's yardstick). Same contract as the plain
    version."""
    pos = int(pos)
    _check_kernel_inputs(q, cache_k, cache_v, pos)
    b, _, hq, d = q.shape
    hkv, s_len = cache_k.shape[1], cache_k.shape[2]
    n_rep = hq // hkv
    route = pick_route("K4", q.dtype, decode_route(q.dtype, d), route)
    # Slots past pos softmax to exactly 0; the kernels skip them.
    n_valid = min(pos + 1, s_len)
    out = torch.empty_like(q)     # [B, 1, H, D] is [B, Hkv, n_rep, D]
    # Entering the device's context costs more host time than a decode
    # step's kernel takes; skip it when the device is already current.
    if q.device.index == torch.cuda.current_device():
        err = _launch(route, q, cache_k, cache_v, out, b, hkv, n_rep,
                      s_len, d, n_valid)
    else:
        with torch.cuda.device(q.device):
            err = _launch(route, q, cache_k, cache_v, out, b, hkv, n_rep,
                          s_len, d, n_valid)
    if err:
        raise RuntimeError(f"K4 decode_attention ({route}) launch failed: "
                           f"CUDA error {err}")
    _decode_attention_cuda.launches += 1
    _decode_attention_cuda.launches_by_route[route] += 1
    return out


_decode_attention_cuda.launches = 0
_decode_attention_cuda.launches_by_route = {"wgmma": 0, "fma": 0}


def _launch(route, q, cache_k, cache_v, out, b, hkv, n_rep, s_len, d,
            n_valid):
    """One call of the route's C entry on the current device's current
    stream; returns its CUDA error code."""
    dev = q.device.index
    stream = current_stream_ptr(dev)
    if route == "wgmma":
        cluster, tpb, spill = _decode_plan(b * hkv, n_rep, n_valid,
                                           *_card(dev, n_rep, d))
        scratch = torch.empty((b * hkv * cluster, n_rep, tpb * _TILE),
                              dtype=torch.float32, device=q.device) \
            if spill else None
        return _bind("decode_attention_wgmma.decode_attention_wgmma",
                     _WGMMA_ARGS)(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), b,
            hkv, n_rep, s_len, d, n_valid, cluster, tpb, d ** -0.5, stream)
    n_split = -(-n_valid // _CHUNK)
    f32 = dict(dtype=torch.float32, device=q.device)
    scores = torch.empty((b, hkv, n_rep, n_split * _CHUNK), **f32)
    ml = torch.empty((b, hkv, n_split, n_rep, 2), **f32)
    partial = torch.empty((b, hkv, n_split if n_split > 1 else 0, n_rep,
                           d), **f32)
    return _bind("decode_attention.decode_attention", _FMA_ARGS)(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        out.data_ptr(), scores.data_ptr(), ml.data_ptr(), partial.data_ptr(),
        b, hkv, n_rep, s_len, d, n_valid, _CHUNK,
        int(q.dtype == torch.bfloat16), d ** -0.5, stream)


def decode_attention(q, cache_k, cache_v, pos):
    """One-token attention against the cache, GQA-native.

    q [B, 1, H, D]; cache_k/v [B, Hkv, S, D] (heads-major kernel
    layout); slots <= pos valid (inclusive, unlike the ragged path's
    exclusive ``lengths``). Returns [B, 1, H, D] in q's dtype. K4 for
    CUDA tensors, the plain version for CPU tensors.
    """
    return kernel_or_plain("decode attention", q, _decode_attention_cuda,
                           _decode_attention_reference, cache_k, cache_v,
                           pos)


def decode_attention_ragged(q, cache_k, cache_v, lengths, k_new, v_new,
                            k_scale=None, v_scale=None):
    """One-token attention for a continuous-batching step: row b sits
    at its own position ``lengths[b]`` (slots < lengths[b] valid —
    exclusive, unlike :func:`decode_attention`'s ``pos``), and the new
    token's k/v ride alongside instead of being written into the cache
    first (the engine owns the paged write).

    q [B, 1, H, D]; cache_k/v [B, Hkv, S, D]; k_new/v_new
    [B, Hkv, 1, D]. int8 path: ``k_scale``/``v_scale`` [B, Hkv, S] are
    per-slot dequant scales; the cache widens to f32 and is scaled here.
    Plain PyTorch on every device, as the JAX package's einsum chain.
    """
    b, _, hq, d = q.shape
    hkv, s_len = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    if k_scale is not None:
        kc = cache_k.float() * k_scale[..., None]
        vc = cache_v.float() * v_scale[..., None]
    else:
        kc, vc = cache_k, cache_v
    scale = d ** -0.5
    s = torch.einsum("bgrd,bgsd->bgrs", qg, kc.float()) * scale
    lengths = torch.as_tensor(lengths, device=q.device)
    valid = (torch.arange(s_len, device=q.device)[None, :]
             < lengths.to(torch.int64)[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG))
    s_self = torch.einsum("bgrd,bgsd->bgrs", qg,
                          k_new.to(kc.dtype).float()) * scale
    p = _softmax(torch.cat([s, s_self], dim=-1)).to(vc.dtype).float()
    out = (torch.einsum("bgrs,bgsd->bgrd", p[..., :s_len], vc.float())
           + torch.einsum("bgrs,bgsd->bgrd", p[..., s_len:],
                          v_new.to(vc.dtype).float()))
    return out.reshape(b, 1, hq, d).to(q.dtype)
