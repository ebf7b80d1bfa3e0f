"""Flash attention on hand-written kernels: K1 forward, K2/K3 backward.

Counterpart of horovod_tpu/ops/flash_attention.py. The TPU module's
Pallas ``_fwd_kernel`` becomes K1, launched by :func:`_flash_fwd_cuda`
along the route :func:`flash_fwd_route` picks from the dtype: bf16 on
the tensor cores (``csrc/flash_fwd_wgmma.cu``), f32 on FMA
(``csrc/flash_fwd.cu``); ``_bwd_dkv_kernel`` becomes K2
(:func:`_flash_bwd_dkv_cuda`, along :func:`flash_bwd_route`: bf16 on
``csrc/flash_bwd_wgmma.cu``, f32 on ``csrc/flash_bwd.cu``) and
``_bwd_dq_kernel`` K3 (:func:`_flash_bwd_dq_cuda`, along the same route:
bf16 on ``csrc/flash_bwd_dq_wgmma.cu``, f32 on ``csrc/flash_bwd.cu``),
launched together by :func:`_flash_bwd_cuda`. :func:`_flash_fwd_reference` and
:func:`_flash_bwd_reference` are their plain PyTorch versions, used for
tensors on the CPU and as the kernels' yardstick on the card.

Each kernel also takes the TPU kernels' ``has_bias`` variant: an
optional per-key f32 bias ``kv_bias`` [B, Tk] (BERT's padding mask),
added to every score after the causal mask and before the softmax. It is
a constant: its cotangent is zero and never computed. The kernels branch
on it at compile time, so a call without it runs the same code as
before. And each takes the TPU kernels' ``has_offsets`` variant: the
global positions ``(q_offset, kv_offset)`` of the first query and key of
a chunk, for the causal mask of one ring-attention step
(:func:`flash_attention_chunk`, whose lse is differentiable: its
cotangent folds into the backward's delta). Offsets (0, 0) are the plain
kernels.

The forward is the custom op ``hvd_torch::flash_fwd`` returning
``(o, lse)``, its backward registered with it; a ring step's is
``hvd_torch::flash_chunk``, the same with the offsets and an lse
cotangent. Being one dispatcher op, each can have its outputs saved by
a selective-checkpoint policy (the TPU module's ``flash_o``/``flash_lse``
names): a ctypes launch inside an
``autograd.Function`` would be invisible to the policy, and remat would
quietly re-run K1 in the backward (models/llama.py).

Layouts follow the JAX package: the public :func:`flash_attention`
takes the framework layout [B, T, H, D]; the kernel layout is
[B, H, T, D] with k/v at their own Hkv heads (GQA-native: query head h
reads kv head h // n_rep, and k/v are never repeated).
"""

import ctypes
import functools
from typing import Optional

import torch

from horovod_tpu_torch._device import dtype_route, kernel_or_plain, pick_route
from horovod_tpu_torch.ops import _build

_NEG = -1e30
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _flash_fwd_reference(q, k, v, causal=True, kv_bias=None, offsets=None):
    """Plain version of K1: the same function with one global softmax
    max (the TPU kernel's result when a single kv block covers T).
    f32 scores, causal mask (at global positions ``offsets`` =
    (q_offset, kv_offset) if given), then ``kv_bias`` [B, Tk] (f32, if
    given) added per key; p cast un-normalised to v's dtype,
    f32-accumulated PV, divided by l at the end; rows with no valid key
    (max still at or below -1e30/2) give exactly 0 and a finite lse
    at or below -1e30 (as the kernels: their loop never raised the max).
    Returns (o [B, H, Tq, D] in q's dtype, lse [B, H, Tq, 1] f32)."""
    h, d = q.shape[1], q.shape[3]
    n_rep = h // k.shape[1]
    kf = k.repeat_interleave(n_rep, dim=1).float()
    vr = v.repeat_interleave(n_rep, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * (d ** -0.5)
    s = _add_bias(_causal_mask(s, causal, offsets), kv_bias)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), vr.float())
    o = torch.where(m > _NEG / 2, acc / l, torch.zeros_like(acc))
    return o.to(q.dtype), m + torch.log(l)


def _causal_mask(s, causal, offsets=None):
    """s [.., Tq, Tk] with the keys after each query row set to -1e30:
    key j is visible to query i iff kv_offset + j <= q_offset + i, the
    ``offsets`` = (q_offset, kv_offset) being the global positions of a
    chunk's first query and key ((0, 0) if None)."""
    if not causal:
        return s
    q_offset, kv_offset = offsets or (0, 0)
    tq, tk = s.shape[-2], s.shape[-1]
    qpos = q_offset + torch.arange(tq, device=s.device)
    kpos = kv_offset + torch.arange(tk, device=s.device)
    mask = kpos[None, :] <= qpos[:, None]
    return torch.where(mask, s, torch.full_like(s, _NEG))


def _add_bias(s, kv_bias):
    """s [B, H, Tq, Tk] plus the per-key bias [B, Tk] (f32), if any."""
    if kv_bias is None:
        return s
    return s + kv_bias.float()[:, None, None, :]


def _delta(o, do, dlse=None):
    """rowsum(do * o) - dlse in f32 [B, H, T, 1]: the backward's softmax
    term, plain PyTorch on every device (the TPU module computes it
    outside Pallas too). An lse cotangent ``dlse`` (a ring step's; None
    is zero) folds in here: ds = p (dp - delta + dlse)."""
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return delta if dlse is None else delta - dlse.float()


def _flash_bwd_reference(q, k, v, o, lse, do, causal=True, kv_bias=None,
                         offsets=None, dlse=None):
    """Plain version of K2 and K3 together, with the TPU kernels'
    recipe: s masked (at global positions ``offsets``, if given), then
    ``kv_bias`` added (if given); p = where(s > -1e30/2, exp(s - lse),
    0); dv = p^T do with p cast to do's dtype; dp = do v^T;
    ds = p (dp - delta) scale, delta = rowsum(do o) - dlse;
    dk = ds^T q and dq = ds k with ds cast to q's / k's dtype; f32
    accumulation throughout. Returns (dq [B, H, T, D] in q's dtype,
    dk, dv [B, H, Tk, D] PER QUERY HEAD in k's / v's dtype) — the
    kernels' outputs, before :func:`_sum_kv_heads`."""
    h, d = q.shape[1], q.shape[3]
    n_rep = h // k.shape[1]
    scale = d ** -0.5
    kr = k.repeat_interleave(n_rep, dim=1)
    vr = v.repeat_interleave(n_rep, dim=1)
    s = _causal_mask(torch.matmul(q.float(), kr.float().transpose(-1, -2))
                     * scale, causal, offsets)
    s = _add_bias(s, kv_bias)
    p = torch.where(s > _NEG / 2, torch.exp(s - lse), torch.zeros_like(s))
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), vr.float().transpose(-1, -2))
    ds = p * (dp - _delta(o, do, dlse)) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dq = torch.matmul(ds.to(k.dtype).float(), kr.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _sum_kv_heads(dk, dv, hkv):
    """Per-query-head dk/dv [B, H, Tk, D] -> [B, Hkv, Tk, D]: each kv
    head's n_rep query heads summed in f32 and cast back (the TPU
    module's order, :452-456)."""
    b, h, tk, d = dk.shape
    if h == hkv:
        return dk, dv
    n_rep = h // hkv

    def fold(x):
        return x.float().reshape(b, hkv, n_rep, tk, d).sum(2).to(x.dtype)

    return fold(dk), fold(dv)


def _check_kernel_inputs(name, q, k, v, *more):
    tensors = (q, k, v) + more
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} needs its inputs on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name} takes float32 or bfloat16 tensors of one "
                         f"dtype, got {[t.dtype for t in tensors]}")
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] \
            or any(t.shape != q.shape for t in more):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError("query heads must be a multiple of kv heads")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {_HEAD_DIMS}, got "
                         f"{q.shape[3]}")
    if k.shape[2] < 1:
        raise ValueError(f"{name} needs at least one key")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _check_bias(name, kv_bias, q, k):
    """A kernel's per-key bias: None, or contiguous f32 [B, Tk] on q's
    device."""
    if kv_bias is None:
        return
    want = (q.shape[0], k.shape[2])
    if kv_bias.dtype != torch.float32 or tuple(kv_bias.shape) != want \
            or not kv_bias.is_contiguous() or kv_bias.device != q.device:
        raise ValueError(f"{name} takes kv_bias as contiguous f32 {want} on "
                         f"{q.device}, got {kv_bias.dtype} "
                         f"{tuple(kv_bias.shape)} on {kv_bias.device}")


def _pad_bias(kv_bias, route="wgmma"):
    """The bias as the route's kernel reads it: as given for FMA; for
    wgmma [B, Tk] -> [B, Tkp], Tkp = Tk rounded up to 128 with zeros (the
    wgmma kernels copy each kv tile's bias whole: K1's 512 bytes, K3's
    256; the padded keys are masked in the kernels). None stays None."""
    if kv_bias is None or route != "wgmma" or kv_bias.shape[1] % 128 == 0:
        return kv_bias
    return torch.nn.functional.pad(kv_bias, (0, -kv_bias.shape[1] % 128))


def _count(wrapper, route, kv_bias, offsets=None):
    """One launch of ``wrapper`` along ``route``, with or without the
    bias, with or without the offsets."""
    wrapper.launches += 1
    wrapper.launches_by_route[route] += 1
    wrapper.bias_launches += kv_bias is not None
    wrapper.offsets_launches += offsets is not None


@functools.cache
def _bind(source, name, n_ptrs):
    """The ctypes entry ``name`` of csrc/<source>.cu: ``n_ptrs``
    pointers (q, k, v, the bias or null, then the rest), then B, H, Hkv,
    Tq, Tk, D, causal, q_offset, kv_offset, is_bf16, the scale and the
    stream (bound once)."""
    fn = getattr(_build.load(source), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(label, fn, tensors, q, k, causal, offsets=None):
    """Launch ``fn`` on ``tensors`` (None passes a null pointer) with the
    chunk ``offsets`` ((0, 0) if None)."""
    b, h, t, d = q.shape
    q_offset, kv_offset = offsets or (0, 0)
    with torch.cuda.device(q.device):
        err = fn(*(None if x is None else x.data_ptr() for x in tensors),
                 b, h, k.shape[1], t, k.shape[2], d, int(bool(causal)),
                 int(q_offset), int(kv_offset),
                 int(q.dtype == torch.bfloat16), d ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{label} launch failed: CUDA error {err}")


def _route(kernel, dtype, head_dim):
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"{kernel} takes head_dim in {_HEAD_DIMS}, got "
                         f"{head_dim}")
    return dtype_route(kernel, dtype)


def flash_fwd_route(dtype, head_dim):
    """The K1 kernel that takes (dtype, head_dim): ``"wgmma"``
    (csrc/flash_fwd_wgmma.cu, tensor cores) for bfloat16, ``"fma"``
    (csrc/flash_fwd.cu) for float32; a ValueError for anything else."""
    return _route("K1", dtype, head_dim)


def flash_bwd_route(dtype, head_dim, kernel="K2"):
    """The K2 and K3 kernels that take (dtype, head_dim): ``"wgmma"``
    (tensor cores: csrc/flash_bwd_wgmma.cu for K2,
    csrc/flash_bwd_dq_wgmma.cu for K3) for bfloat16, ``"fma"``
    (csrc/flash_bwd.cu flash_bwd_dkv and flash_bwd_dq) for float32; a
    ValueError, naming ``kernel``, for anything else."""
    return _route(kernel, dtype, head_dim)


# The ctypes entry of each K1 route: (source, function).
_FWD_ENTRY = {"wgmma": ("flash_fwd_wgmma", "flash_fwd_wgmma"),
              "fma": ("flash_fwd", "flash_fwd")}


def _flash_fwd_cuda(q, k, v, causal=True, kv_bias=None, offsets=None,
                    route=None):
    """Launch K1 on the current stream, by :func:`flash_fwd_route` unless
    ``route`` names one ("fma" also takes bfloat16: the earlier kernel,
    kept as the wgmma kernel's yardstick); with ``kv_bias`` its bias
    variant, with ``offsets`` (q_offset, kv_offset) its offsets variant.
    Same contract as :func:`_flash_fwd_reference`."""
    _check_kernel_inputs("K1", q, k, v)
    _check_bias("K1", kv_bias, q, k)
    route = pick_route("K1", q.dtype, flash_fwd_route(q.dtype, q.shape[3]),
                       route)
    b, h, t, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    if t == 0:
        return o, lse
    bias = _pad_bias(kv_bias, route)
    _launch(f"K1 flash_fwd ({route})", _bind(*_FWD_ENTRY[route], 6),
            (q, k, v, bias, o, lse), q, k, causal, offsets)
    _count(_flash_fwd_cuda, route, kv_bias, offsets)
    return o, lse


# launches: every K1 launch; launches_by_route: by kernel; bias_launches
# and offsets_launches: those of the bias and of the offsets variant.
_flash_fwd_cuda.launches = 0
_flash_fwd_cuda.launches_by_route = {"wgmma": 0, "fma": 0}
_flash_fwd_cuda.bias_launches = 0
_flash_fwd_cuda.offsets_launches = 0


def _check_residuals(q, lse, delta):
    want = (q.shape[0], q.shape[1], q.shape[2], 1)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous f32 {want} on "
                             f"{q.device}")


# The ctypes entry of each K2 route: (source, function).
_DKV_ENTRY = {"wgmma": ("flash_bwd_wgmma", "flash_bwd_dkv_wgmma"),
              "fma": ("flash_bwd", "flash_bwd_dkv")}


def _pad_queries(x, tq):
    """[B, H, Tq, 1] f32 -> [B*H, Tp], Tp = Tq rounded up to 64 with
    zeros: the wgmma kernels copy each 64-query tile's 256 bytes whole."""
    return torch.nn.functional.pad(x.reshape(x.shape[0] * x.shape[1], tq),
                                   (0, -tq % 64))


def _residuals(route, q, lse, delta, padded):
    """lse and delta as the route's kernel reads them: as given for FMA,
    padded by :func:`_pad_queries` for wgmma (``padded``, the pair
    :func:`_flash_bwd_cuda` pads once for K2 and K3, else padded here)."""
    if route != "wgmma":
        return lse, delta
    t = q.shape[2]
    return padded or (_pad_queries(lse, t), _pad_queries(delta, t))


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=True,
                        kv_bias=None, offsets=None, route=None, padded=None):
    """Launch K2 along :func:`flash_bwd_route` unless ``route`` names one
    ("fma" also takes bfloat16): per-query-head (dk, dv) [B, H, Tk, D] in
    k's dtype; with ``kv_bias`` its bias variant, with ``offsets`` its
    offsets variant. ``padded``: lse and delta already padded for
    wgmma."""
    _check_kernel_inputs("K2", q, k, v, do)
    _check_residuals(q, lse, delta)
    _check_bias("K2", kv_bias, q, k)
    route = pick_route("K2", q.dtype, flash_bwd_route(q.dtype, q.shape[3]),
                       route)
    b, h, t, d = q.shape
    dk = torch.empty((b, h, k.shape[2], d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    lse, delta = _residuals(route, q, lse, delta, padded)
    bias = _pad_bias(kv_bias, route)
    _launch(f"K2 flash_bwd_dkv ({route})", _bind(*_DKV_ENTRY[route], 9),
            (q, k, v, bias, do, lse, delta, dk, dv), q, k, causal, offsets)
    _count(_flash_bwd_dkv_cuda, route, kv_bias, offsets)
    return dk, dv


_flash_bwd_dkv_cuda.launches = 0
_flash_bwd_dkv_cuda.launches_by_route = {"wgmma": 0, "fma": 0}
_flash_bwd_dkv_cuda.bias_launches = 0
_flash_bwd_dkv_cuda.offsets_launches = 0


# The ctypes entry of each K3 route: (source, function).
_DQ_ENTRY = {"wgmma": ("flash_bwd_dq_wgmma", "flash_bwd_dq_wgmma"),
             "fma": ("flash_bwd", "flash_bwd_dq")}


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=True, kv_bias=None,
                       offsets=None, route=None, padded=None):
    """Launch K3 along :func:`flash_bwd_route` unless ``route`` names one
    ("fma" also takes bfloat16): dq [B, H, T, D] in q's dtype; with
    ``kv_bias`` its bias variant, with ``offsets`` its offsets variant.
    ``padded``: lse and delta already padded for wgmma."""
    _check_kernel_inputs("K3", q, k, v, do)
    _check_residuals(q, lse, delta)
    _check_bias("K3", kv_bias, q, k)
    route = pick_route("K3", q.dtype,
                       flash_bwd_route(q.dtype, q.shape[3], "K3"), route)
    dq = torch.empty_like(q)
    lse, delta = _residuals(route, q, lse, delta, padded)
    bias = _pad_bias(kv_bias, route)
    _launch(f"K3 flash_bwd_dq ({route})", _bind(*_DQ_ENTRY[route], 8),
            (q, k, v, bias, do, lse, delta, dq), q, k, causal, offsets)
    _count(_flash_bwd_dq_cuda, route, kv_bias, offsets)
    return dq


_flash_bwd_dq_cuda.launches = 0
_flash_bwd_dq_cuda.launches_by_route = {"wgmma": 0, "fma": 0}
_flash_bwd_dq_cuda.bias_launches = 0
_flash_bwd_dq_cuda.offsets_launches = 0


def _flash_bwd_cuda(q, k, v, o, lse, do, causal=True, kv_bias=None,
                    offsets=None, dlse=None):
    """K2 then K3 on the current stream, along their dtype's route, the
    lse cotangent ``dlse`` folded into delta before the wgmma route's
    padded lse and delta are made, once for both. Same contract as
    :func:`_flash_bwd_reference`."""
    delta = _delta(o, do, dlse)
    padded = None
    if flash_bwd_route(q.dtype, q.shape[3]) == "wgmma":
        t = q.shape[2]
        padded = _pad_queries(lse, t), _pad_queries(delta, t)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, kv_bias,
                                 offsets, padded=padded)
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, kv_bias,
                            offsets, padded=padded)
    return dq, dk, dv


def _flash_fwd_impl(q, k, v, causal=True, kv_bias=None, offsets=None):
    """(o, lse) in the kernel layout: K1 for CUDA tensors, the plain
    version for CPU tensors."""
    return kernel_or_plain("flash attention", q, _flash_fwd_cuda,
                           _flash_fwd_reference, k, v, causal, kv_bias,
                           offsets)


def _flash_bwd_impl(q, k, v, o, lse, do, causal=True, kv_bias=None,
                    offsets=None, dlse=None):
    """(dq, dk, dv) with dk/dv at k's Hkv heads: K2 + K3 for CUDA
    tensors, the plain version for CPU tensors, then the n_rep sum."""
    dq, dk, dv = kernel_or_plain("flash attention", q, _flash_bwd_cuda,
                                 _flash_bwd_reference, k, v, o, lse, do,
                                 causal, kv_bias, offsets, dlse)
    return (dq,) + _sum_kv_heads(dk, dv, k.shape[1])


@torch.library.custom_op("hvd_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, kv_bias: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) = flash attention in the kernel layout, through
    :func:`_flash_fwd_impl`; ``kv_bias`` is the optional per-key f32 bias
    [B, Tk], a constant. lse is a residual, not differentiable."""
    return _flash_fwd_impl(q, k, v, causal, kv_bias)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, kv_bias = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.causal = causal
    # Residuals (q, k, v, bias, o, lse), k/v unrepeated (the TPU
    # _flash_biased_fwd; the bias is None without one).
    ctx.save_for_backward(q, k, v, kv_bias, o, lse)


def _flash_backward(ctx, do, _dlse):
    q, k, v, kv_bias, o, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd_impl(q, k, v, o, lse, do.contiguous(),
                                 ctx.causal, kv_bias)
    # The bias is a constant (a padding mask): no cotangent.
    return dq, dk, dv, None, None


torch.library.register_autograd("hvd_torch::flash_fwd", _flash_backward,
                                setup_context=_flash_setup)


@torch.library.custom_op("hvd_torch::flash_chunk", mutates_args=())
def flash_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_offset: int, kv_offset: int, causal: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of one ring step in the kernel layout, through
    :func:`_flash_fwd_impl` with the chunk's offsets; both outputs are
    differentiable."""
    return _flash_fwd_impl(q, k, v, causal, None, (q_offset, kv_offset))


def _chunk_setup(ctx, inputs, output):
    q, k, v, q_offset, kv_offset, causal = inputs
    o, lse = output
    ctx.offsets = (q_offset, kv_offset)
    ctx.causal = causal
    # Residuals (q, k, v, o, lse), k/v unrepeated (the TPU
    # _flash_offsets_fwd).
    ctx.save_for_backward(q, k, v, o, lse)


def _chunk_backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd_impl(q, k, v, o, lse, do.contiguous(),
                                 ctx.causal, None, ctx.offsets, dlse)
    return dq, dk, dv, None, None, None


torch.library.register_autograd("hvd_torch::flash_chunk", _chunk_backward,
                                setup_context=_chunk_setup)


def flash_attention_chunk(q, k, v, q_offset, kv_offset, causal=True):
    """One ring-attention step: attention of the local queries against
    ONE K/V chunk, in the kernel layout (q [B, H, Tq, D], k/v
    [B, Hkv, Tk, D], Tq and Tk free), with ``q_offset`` and ``kv_offset``
    the global positions of the chunk's first query and key for the
    causal mask. Returns ``(o, lse)`` (o in q's dtype, lse f32
    [B, H, Tq, 1]) ready for logsumexp merging; both are differentiable
    (the lse cotangent folds into the backward's delta). A row with no
    visible key (a wholly future chunk) gives o = 0 and a finite lse at
    or below -1e30, so the merge weighs it out without a NaN."""
    return flash_chunk(q.contiguous(), k.contiguous(), v.contiguous(),
                       int(q_offset), int(kv_offset), bool(causal))


def flash_attention(q, k, v, causal=True, kv_bias=None):
    """Flash attention in the framework layout: q [B, T, H, D], k/v
    [B, T, Hkv, D] (GQA-native). Returns [B, T, H, D] in q's dtype;
    differentiable through K2/K3.

    ``kv_bias`` is an optional [B, Tk] additive per-key bias, taken in
    f32 and as a constant (detached, zero cotangent), as the JAX
    ``flash_attention(..., kv_bias=)``: a padding mask passes 0 for real
    keys and -1e30 for padding."""
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    if kv_bias is not None:
        kv_bias = kv_bias.detach().to(torch.float32).contiguous()
    o, _lse = flash_fwd(qt, kt, vt, causal, kv_bias)
    return o.transpose(1, 2)
