"""Dropless sorted grouped-GEMM mixture-of-experts FFN on hand-written
kernels: K5 (the grouped matmul) and K6 (its backward).

Counterpart of horovod_tpu/ops/grouped_moe.py, keeping its names. Flatten
the (token, k) slots, sort them by routed expert (a STABLE sort, as
``jnp.argsort`` is: torch's default sort is not, and the rows of
``x_sorted`` would then differ from JAX's), gather the activation rows
once, run the three expert projections as ragged grouped matmuls, and
un-permute. Every token-slot is computed: no capacity, no dropped
tokens. The gather and the un-permute have inverse-gather backwards
(permute back with ``argsort``, then a reshape-sum over K): no scatter
on the path.

The TPU module's megablox ``gmm`` (``_gmm_tpu``, :137) becomes
``csrc/grouped_mm.cu`` ``grouped_mm`` (K5, :func:`_gmm_cuda`); its
backward ``_gmm_tpu_bwd`` (:151) becomes K6, dlhs
(:func:`_gmm_dlhs_cuda`) and tgmm (:func:`_tgmm_cuda`), along the route
:func:`grouped_bwd_route` picks from the dtype: bf16 on the tensor cores
(``csrc/grouped_mm_wgmma.cu``), f32 on FMA (the K5 kernel reading rhs
transposed, and ``grouped_tgmm``). :func:`_gmm_reference` and
:func:`_tgmm_reference` are their plain versions, used for tensors on
the CPU and as the kernels' yardstick on the card. Group boundaries stay
on the device: no wrapper reads ``group_sizes`` on the host.

Remat: PyTorch's selective checkpointing decides per dispatcher op, and
its replay re-runs, in order, every op it does not save up to the last
residual the backward needs (JAX drops what the backward does not use).
So each save-name of the TPU module is the output of one custom op:
``hvd_torch::dispatch_gather`` gives ``moe_x_sorted``;
``hvd_torch::gmm`` carries its name (``moe_gate_act``, ``moe_up_act``);
and ``moe_y_slots`` comes from ``hvd_torch::gmm_unpermute``, the down
K5 and the un-permute in one op, so that saving ``moe_y_slots`` also
keeps the replay from re-running the down product only to discard it.
"""

import ctypes

import torch
import torch.nn.functional as F

from horovod_tpu_torch._device import kernel_or_plain
from horovod_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)


# ---- plain versions ------------------------------------------------------


def _gmm_reference(lhs, rhs, group_sizes, transpose_rhs=False):
    """Plain version of K5 (and, with ``transpose_rhs``, of K6's dlhs):
    out[rows of e] = lhs[rows of e] @ rhs[e] (rhs[e]^T), f32 products
    and sums, cast to lhs's dtype. lhs [M, K]; rhs [E, K, N] ([E, N, K]
    transposed); rows past sum(group_sizes) are 0."""
    m = lhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros((m, n), dtype=lhs.dtype, device=lhs.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, m)
        w = rhs[e].float()
        out[start:end] = (lhs[start:end].float()
                          @ (w.t() if transpose_rhs else w)).to(lhs.dtype)
        start = end
    return out


def _gmm_dlhs_reference(grad, rhs, group_sizes):
    """Plain version of K6's dlhs: :func:`_gmm_reference` reading rhs
    transposed, dlhs [M, K] = per group grad @ rhs[e]^T."""
    return _gmm_reference(grad, rhs, group_sizes, transpose_rhs=True)


def _tgmm_reference(lhs, grad, group_sizes):
    """Plain version of K6's tgmm: out[e] = lhs[rows of e]^T @
    grad[rows of e], an f32 sum over the group's rows cast to lhs's
    dtype; exactly 0 for an empty group. lhs [M, K], grad [M, N] ->
    [E, K, N]."""
    out = torch.zeros((group_sizes.shape[0], lhs.shape[1], grad.shape[1]),
                      dtype=torch.float32, device=lhs.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = start + size
        out[e] = lhs[start:end].float().t() @ grad[start:end].float()
        start = end
    return out.to(lhs.dtype)


# ---- the kernels ---------------------------------------------------------


def _check_kernel_inputs(name, a, b, group_sizes, n_groups):
    if not all(t.is_cuda and t.device == a.device
               for t in (a, b, group_sizes)):
        raise ValueError(f"{name} needs its inputs on one CUDA device")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"{name} takes float32 or bfloat16 matrices of one "
                         f"dtype, got {a.dtype} and {b.dtype}")
    if group_sizes.dtype != torch.int32 \
            or tuple(group_sizes.shape) != (n_groups,):
        raise ValueError(f"{name} takes int32 group_sizes [{n_groups}], got "
                         f"{group_sizes.dtype} {tuple(group_sizes.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} takes contiguous matrices")


def _offsets(group_sizes):
    """The E + 1 group boundaries (0, then the running sum) as int32 on
    group_sizes' device: computed there, never read on the host."""
    return F.pad(torch.cumsum(group_sizes, 0, dtype=torch.int32), (1, 0))


def _bind(name, n_ints, source="grouped_mm"):
    """The ctypes entry ``name`` of csrc/<source>.cu: four pointers,
    ``n_ints`` ints, then the stream."""
    fn = getattr(_build.load(source), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(label, fn, *args):
    with torch.cuda.device(args[0].device):
        err = fn(*(t.data_ptr() for t in args[:4]), *args[4:],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{label} launch failed: CUDA error {err}")


def _grouped_mm_cuda(label, lhs, rhs, group_sizes, transpose_rhs):
    """Launch csrc/grouped_mm.cu grouped_mm; returns (out, launched)."""
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"{label} takes lhs [M, K] and rhs [E, K, N], got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    _check_kernel_inputs(label, lhs, rhs, group_sizes, rhs.shape[0])
    m, kc = lhs.shape
    n_groups, contraction, nc = (rhs.shape[0], rhs.shape[2], rhs.shape[1]) \
        if transpose_rhs else rhs.shape
    if contraction != kc:
        raise ValueError(f"{label}: lhs {tuple(lhs.shape)} does not contract "
                         f"with rhs {tuple(rhs.shape)} (transpose_rhs="
                         f"{transpose_rhs})")
    # Zeros: rows that no group covers stay 0, as in the plain version.
    out = torch.zeros((m, nc), dtype=lhs.dtype, device=lhs.device)
    if m == 0 or nc == 0:
        return out, False
    _launch(label, _bind("grouped_mm", 6), lhs, rhs, _offsets(group_sizes),
            out, m, kc, nc, n_groups, int(transpose_rhs),
            int(lhs.dtype == torch.bfloat16))
    return out, True


def _gmm_cuda(lhs, rhs, group_sizes):
    """Launch K5 on the current stream. Same contract as
    :func:`_gmm_reference`."""
    out, launched = _grouped_mm_cuda("K5 gmm", lhs, rhs, group_sizes, False)
    _gmm_cuda.launches += int(launched)
    return out


_gmm_cuda.launches = 0


def grouped_bwd_route(dtype):
    """The K6 kernels (dlhs and tgmm) that take ``dtype``: ``"wgmma"``
    (csrc/grouped_mm_wgmma.cu, tensor cores) for bfloat16, ``"fma"``
    (csrc/grouped_mm.cu) for float32; a ValueError for anything else."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"K6 has no kernel for {dtype}: it takes float32 "
                     f"(fma) or bfloat16 (wgmma)")


def _pick_route(label, dtype, route):
    """``route`` if given ("fma" also takes bfloat16: the earlier kernel,
    kept as the wgmma kernel's yardstick), else the dtype's route."""
    want = grouped_bwd_route(dtype)
    route = route or want
    if route not in ("wgmma", "fma") or (route == "wgmma" and
                                         want != "wgmma"):
        raise ValueError(f"{label} route {route!r} does not take {dtype}")
    return route


def _check_wgmma_widths(label, **widths):
    """The wgmma kernels read rows by TMA, whose row pitch must be a
    multiple of 16 bytes: every width a multiple of 8 bf16 values."""
    bad = {k: v for k, v in widths.items() if v % 8}
    if bad:
        raise ValueError(f"{label} (wgmma route) needs {' and '.join(widths)} "
                         f"to be multiples of 8 (TMA's 16-byte rows), got "
                         f"{bad}")


def _count(fn, route, launched):
    fn.launches += int(launched)
    fn.launches_by_route[route] += int(launched)


def _gmm_dlhs_cuda(grad, rhs, group_sizes, route=None):
    """Launch K6's first half on the current stream: dlhs [M, K] = per
    group grad [M, N] @ rhs[e]^T (rhs [E, K, N]), in grad's dtype. The
    fma route is the K5 kernel reading rhs transposed."""
    route = _pick_route("K6 dlhs", grad.dtype, route)
    if route == "fma":
        out, launched = _grouped_mm_cuda("K6 dlhs", grad, rhs, group_sizes,
                                         True)
        _count(_gmm_dlhs_cuda, route, launched)
        return out
    if grad.dim() != 2 or rhs.dim() != 3 or rhs.shape[2] != grad.shape[1]:
        raise ValueError(f"K6 dlhs takes grad [M, N] and rhs [E, K, N], got "
                         f"{tuple(grad.shape)} and {tuple(rhs.shape)}")
    _check_kernel_inputs("K6 dlhs", grad, rhs, group_sizes, rhs.shape[0])
    (m, n), (n_groups, k) = grad.shape, rhs.shape[:2]
    _check_wgmma_widths("K6 dlhs", K=k, N=n)
    # Zeros: rows that no group covers stay 0, as in the plain version.
    out = torch.zeros((m, k), dtype=grad.dtype, device=grad.device)
    launched = m > 0 and k > 0 and n > 0
    if launched:
        _launch("K6 dlhs (wgmma)",
                _bind("grouped_dlhs_wgmma", 4, "grouped_mm_wgmma"), grad,
                rhs, _offsets(group_sizes), out, m, n, k, n_groups)
    _count(_gmm_dlhs_cuda, route, launched)
    return out


_gmm_dlhs_cuda.launches = 0
_gmm_dlhs_cuda.launches_by_route = {"wgmma": 0, "fma": 0}


def _tgmm_cuda(lhs, grad, group_sizes, route=None):
    """Launch K6's tgmm on the current stream (csrc/grouped_mm_wgmma.cu
    for bf16, csrc/grouped_mm.cu grouped_tgmm for f32). Same contract as
    :func:`_tgmm_reference`."""
    route = _pick_route("K6 tgmm", lhs.dtype, route)
    if lhs.dim() != 2 or grad.dim() != 2 or lhs.shape[0] != grad.shape[0]:
        raise ValueError(f"K6 tgmm takes lhs [M, K] and grad [M, N], got "
                         f"{tuple(lhs.shape)} and {tuple(grad.shape)}")
    n_groups = group_sizes.numel()
    _check_kernel_inputs("K6 tgmm", lhs, grad, group_sizes, n_groups)
    (m, kd), nd = lhs.shape, grad.shape[1]
    if route == "wgmma":
        _check_wgmma_widths("K6 tgmm", K=kd, N=nd)
    out = torch.empty((n_groups, kd, nd), dtype=lhs.dtype, device=lhs.device)
    if out.numel() == 0:
        return out
    if route == "fma":
        _launch("K6 tgmm (fma)", _bind("grouped_tgmm", 5), lhs, grad,
                _offsets(group_sizes), out, m, kd, nd, n_groups,
                int(lhs.dtype == torch.bfloat16))
    elif m == 0:  # every group empty: no rows to map
        out.zero_()
        return out
    else:
        _launch("K6 tgmm (wgmma)",
                _bind("grouped_tgmm_wgmma", 4, "grouped_mm_wgmma"), lhs,
                grad, _offsets(group_sizes), out, m, kd, nd, n_groups)
    _count(_tgmm_cuda, route, True)
    return out


_tgmm_cuda.launches = 0
_tgmm_cuda.launches_by_route = {"wgmma": 0, "fma": 0}


def _gmm_impl(lhs, rhs, group_sizes):
    return kernel_or_plain("grouped matmul", lhs, _gmm_cuda, _gmm_reference,
                           rhs, group_sizes)


def _gmm_backward_impl(lhs, rhs, group_sizes, grad):
    """K6: (dlhs [M, K] in lhs's dtype, drhs [E, K, N] in rhs's dtype)
    of out = gmm(lhs, rhs) under the cotangent ``grad``, megablox's
    decomposition."""
    grad = grad.contiguous()
    dlhs = kernel_or_plain("grouped matmul", grad, _gmm_dlhs_cuda,
                           _gmm_dlhs_reference, rhs, group_sizes)
    drhs = kernel_or_plain("grouped matmul", lhs, _tgmm_cuda,
                           _tgmm_reference, grad, group_sizes)
    return dlhs.to(lhs.dtype), drhs.to(rhs.dtype)


# ---- the dispatcher ops --------------------------------------------------


@torch.library.custom_op("hvd_torch::gmm", mutates_args=())
def _grouped_mm(lhs: torch.Tensor, rhs: torch.Tensor,
                group_sizes: torch.Tensor, name: str) -> torch.Tensor:
    """Ragged grouped matmul, differentiable through K6: rows of ``lhs``
    [M, K] are grouped contiguously per ``group_sizes`` [E] (int32);
    ``rhs`` [E, K, N]. ``name`` is the save-name a remat policy keeps it
    by (the TPU module's ``checkpoint_name``)."""
    return _gmm_impl(lhs, rhs, group_sizes)


def _gmm_setup(ctx, inputs, output):
    lhs, rhs, group_sizes, _ = inputs
    ctx.save_for_backward(lhs, rhs, group_sizes)


def _gmm_backward(ctx, grad):
    lhs, rhs, group_sizes = ctx.saved_tensors
    return (*_gmm_backward_impl(lhs, rhs, group_sizes, grad), None, None)


torch.library.register_autograd("hvd_torch::gmm", _gmm_backward,
                                setup_context=_gmm_setup)


def _unpermute(x, perm):
    """``x[perm]`` for a permutation ``perm``."""
    return x.index_select(0, perm)


def _unpermute_bwd(perm, g):
    """The cotangent of :func:`_unpermute` by the inverse gather:
    out[perm[i]] = g[i], i.e. out = g[argsort(perm)]; never a scatter."""
    return g.index_select(0, torch.argsort(perm))


@torch.library.custom_op("hvd_torch::gmm_unpermute", mutates_args=())
def _gmm_unpermute(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor,
                   perm: torch.Tensor) -> torch.Tensor:
    """``_unpermute(_grouped_mm(lhs, rhs, group_sizes), perm)`` as one op:
    the down projection (K5) and the return to slot order, whose output
    is the TPU module's ``moe_y_slots``. Backward: the inverse gather,
    then K6."""
    return _unpermute(_gmm_impl(lhs, rhs, group_sizes), perm)


def _gmm_unpermute_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _gmm_unpermute_backward(ctx, grad):
    lhs, rhs, group_sizes, perm = ctx.saved_tensors
    g_sorted = _unpermute_bwd(perm, grad)
    return (*_gmm_backward_impl(lhs, rhs, group_sizes, g_sorted), None,
            None)


torch.library.register_autograd("hvd_torch::gmm_unpermute",
                                _gmm_unpermute_backward,
                                setup_context=_gmm_unpermute_setup)


@torch.library.custom_op("hvd_torch::dispatch_gather", mutates_args=())
def _dispatch_gather(h: torch.Tensor, slot_token: torch.Tensor,
                     sorted_order: torch.Tensor, k: int) -> torch.Tensor:
    """Rows of ``h`` [S, D] replicated K ways and permuted into expert
    order in one gather: out[i] = h[slot_token[i]] ([S*K, D]), with
    ``slot_token = sorted_order // K``. Its output is the TPU module's
    ``moe_x_sorted``."""
    return h.index_select(0, slot_token)


def _dispatch_gather_setup(ctx, inputs, output):
    _, _, sorted_order, k = inputs
    ctx.k = k
    ctx.save_for_backward(sorted_order)


def _dispatch_gather_backward(ctx, g):
    # Back to (token, k) slot order by the inverse permutation, then the
    # K slots of each token summed: no duplicate-index scatter.
    (sorted_order,) = ctx.saved_tensors
    flat = _unpermute_bwd(sorted_order, g)
    return flat.reshape(-1, ctx.k, g.shape[-1]).sum(1), None, None, None


torch.library.register_autograd("hvd_torch::dispatch_gather",
                                _dispatch_gather_backward,
                                setup_context=_dispatch_gather_setup)


def grouped_moe_ffn(h, lp, c):
    """Dropless top-K routed expert FFN over ``h`` [B, T, D] with the
    layer params ``lp`` (router [D, E], moe_gate/moe_up [E, D, F],
    moe_down [E, F, D]). Returns (out [B, T, D], aux loss), with the TPU
    module's router, gate normalisation and Switch aux loss."""
    from horovod_tpu_torch.models.llama import moe_route

    b, t, d = h.shape
    n_experts, k = c.n_experts, c.n_experts_per_token
    s = b * t
    dt = c.compute_dtype
    hf = h.reshape(s, d)
    gate_vals, gate_idx, aux = moe_route(hf, lp["router"], k)  # [S, K]

    # Sort the S*K (token, k) slots by routed expert, stably. The group
    # sizes come from a compare-and-sum, not torch.bincount: on CUDA
    # bincount reads the input's max and min on the host.
    e_flat = gate_idx.reshape(s * k)
    order = torch.argsort(e_flat, stable=True)          # sorted slot -> slot
    experts = torch.arange(n_experts, device=e_flat.device,
                           dtype=e_flat.dtype)
    group_sizes = (e_flat[:, None] == experts).sum(0, dtype=torch.int32)

    x_sorted = _dispatch_gather(hf.to(dt), order // k, order, k)
    gate_pre = _grouped_mm(x_sorted, lp["moe_gate"].to(dt), group_sizes,
                           "moe_gate_act")
    up = _grouped_mm(x_sorted, lp["moe_up"].to(dt), group_sizes,
                     "moe_up_act")
    y_slots = _gmm_unpermute(F.silu(gate_pre) * up, lp["moe_down"].to(dt),
                             group_sizes, torch.argsort(order))  # [S*K, D]
    y = (y_slots.reshape(s, k, d) * gate_vals.to(dt)[..., None]).sum(1)
    return y.reshape(b, t, d), aux
