"""Single-position decode attention on the hand-written K4 kernel.

Counterpart of horovod_tpu/ops/decode_attention.py. The TPU module's
Pallas ``_kernel`` becomes ``csrc/decode_attention.cu`` (launched by
:func:`_decode_attention_cuda`); :func:`_decode_attention_reference`
is its plain PyTorch version (the counterpart of the JAX
``_decode_attention_xla``), used for tensors on the CPU and as the
kernel's yardstick on the card. Unlike the TPU kernel, K4 covers any
cache length: it splits S across blocks instead of falling back to an
einsum past a memory budget.

:func:`decode_attention_ragged` (the continuous-batching step's
attention) was an einsum chain on every platform in the JAX package,
not a Pallas kernel; it stays plain PyTorch here.

Numeric recipe (both functions): f32 scores and softmax, p normalised
and then cast to the value dtype, f32-accumulated PV.
"""

import ctypes

import torch

from horovod_tpu_torch._device import kernel_or_plain
from horovod_tpu_torch.ops import _build

_NEG = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_REP = 16
_CHUNK = 128   # cache slots per block of K4's passes


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


def _decode_attention_cuda(q, cache_k, cache_v, pos):
    """Launch K4 (csrc/decode_attention.cu, its three passes) on the
    current stream. Same contract as the plain version."""
    pos = int(pos)
    _check_kernel_inputs(q, cache_k, cache_v, pos)
    b, _, hq, d = q.shape
    hkv, s_len = cache_k.shape[1], cache_k.shape[2]
    n_rep = hq // hkv
    # Slots past pos softmax to exactly 0; the kernel skips them.
    n_valid = min(pos + 1, s_len)
    n_split = -(-n_valid // _CHUNK)
    f32 = dict(dtype=torch.float32, device=q.device)
    scores = torch.empty((b, hkv, n_rep, n_split * _CHUNK), **f32)
    ml = torch.empty((b, hkv, n_split, n_rep, 2), **f32)
    partial = torch.empty((b, hkv, n_split if n_split > 1 else 0, n_rep,
                           d), **f32)
    out = torch.empty((b, hkv, n_rep, d), dtype=q.dtype, device=q.device)
    lib = _build.load("decode_attention")
    fn = lib.decode_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                 out.data_ptr(), scores.data_ptr(), ml.data_ptr(),
                 partial.data_ptr(), b, hkv, n_rep, s_len, d, n_valid,
                 _CHUNK, int(q.dtype == torch.bfloat16), d ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K4 decode_attention launch failed: CUDA "
                           f"error {err}")
    _decode_attention_cuda.launches += 1
    return out.reshape(b, 1, hq, d)


_decode_attention_cuda.launches = 0


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
