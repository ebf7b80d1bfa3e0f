"""The port's flash-attention backward against the JAX package.

The plain ``_flash_bwd_reference`` (what the backward runs for CPU
tensors, and K2/K3's yardstick on the card), followed by the f32 n_rep
sum, is held against the Pallas ``_bwd_dkv_kernel``/``_bwd_dq_kernel``
run in interpret mode on the same q, k, v, o, lse and do; the public
``flash_attention``'s autograd against ``jax.grad`` of JAX's at a T
that is not a power of two. Tolerances: f32 at 1e-5 relative to each
gradient's largest entry (the same f32 products summed in another
order); bf16 at 2e-2 (a bf16 rounding of p or ds may land differently).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as port

fa_mod = importlib.import_module("horovod_tpu.ops.flash_attention")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _interpret_mode():
    fa_mod._INTERPRET = True
    yield
    fa_mod._INTERPRET = False


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _torch(a, dtype):
    return torch.from_numpy(_np(a).copy()).to(getattr(torch, dtype))


def _close(got, want, dtype, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL[dtype], f"{what}: relative error {err}"


def _inputs(seed, b, h, hkv, t, d, layout="bhtd"):
    rng = np.random.default_rng(seed)
    if layout == "bhtd":
        shapes = [(b, h, t, d), (b, hkv, t, d), (b, hkv, t, d), (b, h, t, d)]
    else:
        shapes = [(b, t, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, t, h, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [32, 16])
def test_bwd_reference_matches_pallas_kernels(causal, n_rep, dtype, block):
    """block 32 = one block each way; block 16 = two, so the Pallas
    kernels stream several q and kv blocks (and skip causal ones)."""
    hkv = 2
    q, k, v, do = (jnp.asarray(a, dtype)
                   for a in _inputs(0, 2, hkv * n_rep, hkv, 32, 16))
    o, lse = fa_mod._flash_fwd_impl(q, k, v, None, causal, block, block)
    want = fa_mod._flash_bwd_impl(q, k, v, None, o, lse, do, causal, block,
                                  block)
    dq, dk_h, dv_h = port._flash_bwd_reference(
        *(_torch(a, dtype) for a in (q, k, v, o)),
        torch.from_numpy(np.array(lse)), _torch(do, dtype), causal)
    assert dk_h.shape == (2, hkv * n_rep, 32, 16)
    got = (dq,) + port._sum_kv_heads(dk_h, dv_h, hkv)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == getattr(torch, dtype), name
        _close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_public_flash_attention_grad_matches_jax(dtype):
    """T = 37: torch autograd through the port's op against jax.grad of
    the JAX public function, for a weighted sum of the output."""
    q, k, v, w = _inputs(1, 2, 4, 2, 37, 16, layout="bthd")

    def jloss(q, k, v):
        out = fa_mod.flash_attention(q, k, v, causal=True)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    tq, tk, tv = (_torch(a, dtype).requires_grad_(True) for a in (q, k, v))
    out = port.flash_attention(tq, tk, tv, causal=True)
    (out.float() * torch.from_numpy(w)).sum().backward()
    for name, g, ww in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                           want):
        _close(g, ww, dtype, name)


def test_cpu_backward_builds_and_launches_nothing(monkeypatch):
    """The backward takes the plain version only because the tensors
    lie on the CPU: nothing builds and no kernel counter moves."""
    def no_build(name):
        raise AssertionError(f"kernel {name} requested for CPU tensors")

    monkeypatch.setattr(port._build, "load", no_build)
    before = (port._flash_fwd_cuda.launches,
              port._flash_bwd_dkv_cuda.launches,
              port._flash_bwd_dq_cuda.launches)
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True)
                  for a in _inputs(2, 1, 4, 2, 9, 16, layout="bthd"))
    port.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert (port._flash_fwd_cuda.launches,
            port._flash_bwd_dkv_cuda.launches,
            port._flash_bwd_dq_cuda.launches) == before


def test_bwd_kernel_wrappers_reject_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 1, 8, 16))
    lse = torch.zeros((1, 2, 8, 1))
    with pytest.raises(ValueError, match="CUDA"):
        port._flash_bwd_dkv_cuda(q, k, v, do, lse, lse, True)
    with pytest.raises(ValueError, match="CUDA"):
        port._flash_bwd_dq_cuda(q, k, v, do, lse, lse, True)


def test_op_returns_lse_as_a_non_differentiable_residual():
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True)
                  for a in _inputs(4, 1, 2, 1, 8, 16))
    o, lse = port.flash_fwd(q, k, v, True)
    assert o.requires_grad and not lse.requires_grad
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, 8, 1)
