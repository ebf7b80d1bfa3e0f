"""Adam's update on one flat leaf: one pass (``csrc/adam.cu``) on the card.

The JAX package writes its fused Adam as one elementwise expression
that XLA fuses into one loop (``horovod_tpu/parallel/precision.py:118
_adam_leaf``). :func:`adam_update` is that step for the port's
``fused_adam``, ``fused_master_adam`` and ZeRO-1's shard Adam
(``parallel/{precision,zero}.py``): its kernel on a CUDA tensor, its
plain version (:func:`_adam_leaf`, about twenty whole-leaf torch ops)
on a CPU tensor, the same bits by the same f32 arithmetic in the same
order; there is no fallback from one to the other.

Two variants:

- moments in the parameter dtype (no ``cast``): ``p``, ``g``, ``mu`` and
  ``nu`` all bfloat16 or all float32;
- an f32 master (``cast`` given): ``p`` (the master), ``mu`` and ``nu``
  float32, ``g`` in the compute dtype, and ``cast`` in that dtype
  receives the new master's cast.

``mu`` and ``nu`` are written in place, the new ``p`` into ``out``
(``p`` itself by default). ``bc1`` and ``bc2`` are the bias corrections'
0-d f32 tensors on the leaf's device, which the kernel reads there.

``_adam_cuda.launches`` counts the kernel's launches (CUDA tensors only),
``_adam_cuda.launches_by_variant`` them by variant ("adam", "master").
"""

import ctypes
import functools
import threading

import torch

from horovod_tpu_torch._device import current_stream_ptr, kernel_or_plain
from horovod_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def _adam_leaf(p, g, mu, nu, lr, b1, b2, eps, bc1, bc2, out_dtype):
    """One leaf's full Adam step in f32. Returns (p2 in ``out_dtype``,
    mu2, nu2 in their own dtypes); the caller stores them."""
    gf = g.float()
    mu2 = b1 * mu.float() + (1.0 - b1) * gf
    nu2 = b2 * nu.float() + (1.0 - b2) * torch.square(gf)
    update = lr * (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
    p2 = (p.float() - update).to(out_dtype)
    return p2, mu2.to(mu.dtype), nu2.to(nu.dtype)


def _adam_plain(p, g, mu, nu, lr, b1, b2, eps, bc1, bc2, out, cast):
    out = p if out is None else out
    p2, mu2, nu2 = _adam_leaf(p, g, mu, nu, lr, b1, b2, eps, bc1, bc2,
                              out.dtype)
    out.copy_(p2)
    mu.copy_(mu2)
    nu.copy_(nu2)
    if cast is not None:
        cast.copy_(p2.to(cast.dtype))
    return out


@functools.cache
def _bind():
    fn = _build.load("adam").adam_update
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
        ctypes.c_float
    fn.argtypes = [P, P, P, P, P, P, L, I, I, I, F, F, F, F, F, F, P, P, P]
    fn.restype = ctypes.c_int
    return fn


def _variant(p, g, mu, nu, out, cast):
    """"adam" or "master" for these tensors, or a ValueError."""
    n = p.numel()
    named = dict(p=p, g=g, mu=mu, nu=nu, out=out, cast=cast)
    for name, t in named.items():
        if t is None:
            continue
        if t.device != p.device or not t.is_contiguous() or t.numel() != n:
            raise ValueError(
                f"adam_update: {name} must be a contiguous tensor of {n} "
                f"elements on {p.device}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    if out.dtype != p.dtype or mu.dtype != p.dtype or nu.dtype != p.dtype:
        raise ValueError(
            f"adam_update: out, mu and nu must have p's dtype {p.dtype}, "
            f"got {out.dtype}, {mu.dtype}, {nu.dtype}")
    if cast is None:
        if p.dtype in _DTYPES and g.dtype == p.dtype:
            return "adam"
    elif p.dtype == torch.float32 and g.dtype in _DTYPES and \
            cast.dtype == g.dtype:
        return "master"
    raise ValueError(
        "adam_update's kernel takes p, g, mu, nu all float32 or all "
        "bfloat16, or an f32 master with g and cast in one compute dtype "
        f"(float32 or bfloat16); got p {p.dtype}, g {g.dtype}, cast "
        f"{None if cast is None else cast.dtype}")


def _adam_cuda(p, g, mu, nu, lr, b1, b2, eps, bc1, bc2, out, cast):
    out = p if out is None else out
    variant = _variant(p, g, mu, nu, out, cast)
    for name, bc in (("bc1", bc1), ("bc2", bc2)):
        if not torch.is_tensor(bc) or bc.device != p.device or \
                bc.dtype != torch.float32 or bc.numel() != 1:
            raise ValueError(f"adam_update: {name} must be a one-element "
                             f"float32 tensor on {p.device}")
    if p.numel() == 0:
        return out
    dev = p.device
    with torch.cuda.device(dev):
        err = _bind()(
            out.data_ptr(), p.data_ptr(), g.data_ptr(), mu.data_ptr(),
            nu.data_ptr(), None if cast is None else cast.data_ptr(),
            p.numel(), _DTYPES[p.dtype], _DTYPES[g.dtype],
            -1 if cast is None else _DTYPES[cast.dtype], lr, b1, 1.0 - b1,
            b2, 1.0 - b2, eps, bc1.data_ptr(), bc2.data_ptr(),
            current_stream_ptr(dev.index))
    if err:
        raise RuntimeError(f"adam kernel launch failed: CUDA error {err}")
    with _count_lock:
        _adam_cuda.launches += 1
        _adam_cuda.launches_by_variant[variant] += 1
    return out


_adam_cuda.launches = 0
_adam_cuda.launches_by_variant = {"adam": 0, "master": 0}


def adam_update(p, g, mu, nu, lr, b1, b2, eps, bc1, bc2, out=None,
                cast=None):
    """One Adam step on one leaf in f32, in ``_adam_leaf``'s order:
    writes ``mu`` and ``nu`` in place, the new params into ``out``
    (default ``p``) and, for the master variant, their cast into
    ``cast``. Returns ``out``. The kernel on a CUDA ``p``, the plain
    version on a CPU one."""
    return kernel_or_plain("adam_update", p, _adam_cuda, _adam_plain, g, mu,
                           nu, lr, b1, b2, eps, bc1, bc2, out, cast)
