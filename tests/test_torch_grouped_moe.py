"""The port's grouped-MoE ops against the JAX package on the CPU.

The plain versions of K5 (``_gmm_reference``) and K6
(``_gmm_dlhs_reference``, ``_tgmm_reference``) against megablox ``gmm``,
``gmm(transpose_rhs=True)`` and ``tgmm`` in Pallas interpret mode (small
tilings, unaligned group boundaries, empty groups); the ``hvd_torch::gmm``
op's autograd against ``jax.grad`` of the TPU module's ``_grouped_mm``
(its one-hot fallback off the TPU); ``moe_route``; the inverse-gather
backwards; and ``grouped_moe_ffn``'s values, gradients and sort order.
Inputs are made with numpy from a seed and handed to both.

Tolerances, relative to the reference's largest entry: f32 1e-5 (the
same f32 products summed in another order); bf16 1e-2 (both sum in f32
and round once to bf16, so an element may differ by one bf16 ulp,
2^-8 of its size). An empty group's tgmm slice is exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.megablox.gmm import gmm, tgmm

from horovod_tpu.models import llama as jl
from horovod_tpu.ops import grouped_moe as jgm
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.ops import grouped_moe as gm

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Megablox needs M, K and N divisible by its tiles; the group
# boundaries need not be.
M, K, N, TILING = 40, 48, 48, (8, 16, 24)
LAYOUTS = {"ragged": [10, 0, 23, 7], "one-group": [0, 40, 0, 0],
           "empty-ends": [0, 17, 23, 0]}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _both(a, dtype):
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _rel(got, want):
    want = _np(want)
    return np.abs(_np(got) - want).max() / max(np.abs(want).max(), 1e-30)


def _operands(seed, dtype, sizes, m=M, k=K, n=N):
    rng = np.random.default_rng(seed)
    lhs = _both(rng.standard_normal((m, k)).astype(np.float32), dtype)
    rhs = _both((rng.standard_normal((len(sizes), k, n)) * k ** -0.5)
                .astype(np.float32), dtype)
    grad = _both(rng.standard_normal((m, n)).astype(np.float32), dtype)
    gs = np.asarray(sizes, np.int32)
    return lhs, rhs, grad, (jnp.asarray(gs), torch.from_numpy(gs))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_reference_matches_megablox(dtype, layout):
    (jl_, tl_), (jr, tr), _, (jgs, tgs) = _operands(0, dtype,
                                                   LAYOUTS[layout])
    want = gmm(jl_, jr, jgs, preferred_element_type=jl_.dtype,
               tiling=TILING, interpret=True)
    out = gm._gmm_reference(tl_, tr, tgs)
    assert out.dtype == tl_.dtype and tuple(out.shape) == (M, N)
    assert _rel(out, want) <= TOL[dtype]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dlhs_reference_matches_megablox_transposed(dtype, layout):
    _, (jr, tr), (jg, tg), (jgs, tgs) = _operands(1, dtype, LAYOUTS[layout])
    want = gmm(jg, jr, jgs, jg.dtype, (8, 24, 16), transpose_rhs=True,
               interpret=True)
    out = gm._gmm_dlhs_reference(tg, tr, tgs)
    assert out.dtype == tg.dtype and tuple(out.shape) == (M, K)
    assert _rel(out, want) <= TOL[dtype]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tgmm_reference_matches_megablox(dtype, layout):
    (jl_, tl_), _, (jg, tg), (jgs, tgs) = _operands(2, dtype,
                                                   LAYOUTS[layout])
    want = tgmm(jl_.swapaxes(0, 1), jg, jgs, jl_.dtype, TILING,
                interpret=True)
    out = gm._tgmm_reference(tl_, tg, tgs)
    assert out.dtype == tl_.dtype and tuple(out.shape) == (4, K, N)
    assert _rel(out, want) <= TOL[dtype]
    for e, size in enumerate(LAYOUTS[layout]):
        if size == 0:
            assert not out[e].any() and not np.asarray(want[e]).any()


def test_rows_past_the_groups_are_zero():
    _, (_, tr), _, _ = _operands(3, "float32", [1, 1, 1, 1])
    lhs = torch.ones(6, K)
    out = gm._gmm_reference(lhs, tr, torch.tensor([1, 0, 2, 0],
                                                  dtype=torch.int32))
    assert not out[3:].any() and out[:3].abs().sum() > 0


def test_grouped_mm_op_autograd_matches_jax_grad():
    (jl_, tl_), (jr, tr), (jg, tg), (jgs, tgs) = _operands(
        4, "float32", LAYOUTS["ragged"], m=37, k=24, n=20)

    def jax_loss(a, b):
        return jnp.sum(jgm._grouped_mm(a, b, jgs) * jg)

    want, (want_da, want_db) = jax.value_and_grad(jax_loss, (0, 1))(jl_, jr)
    a, b = tl_.requires_grad_(True), tr.requires_grad_(True)
    out = gm._grouped_mm(a, b, tgs, "moe_gate_act")
    da, db = torch.autograd.grad((out * tg).sum(), (a, b))
    assert float((out * tg).sum().detach()) == pytest.approx(float(want),
                                                           rel=1e-5)
    assert _rel(da, want_da) <= 1e-5
    assert _rel(db, want_db) <= 1e-5


def test_gmm_unpermute_op_matches_jax():
    """The fused down product + un-permute against JAX's _grouped_mm then
    _unpermute, values and gradients."""
    (jl_, tl_), (jr, tr), (jg, tg), (jgs, tgs) = _operands(
        5, "float32", LAYOUTS["ragged"])
    perm = np.random.default_rng(6).permutation(M).astype(np.int32)

    def jax_loss(a, b):
        y = jgm._unpermute(jgm._grouped_mm(a, b, jgs), jnp.asarray(perm), M)
        return jnp.sum(y * jg), y

    (_, want_y), (want_da, want_db) = jax.value_and_grad(
        jax_loss, (0, 1), has_aux=True)(jl_, jr)
    a, b = tl_.requires_grad_(True), tr.requires_grad_(True)
    y = gm._gmm_unpermute(a, b, tgs, torch.from_numpy(perm).long())
    da, db = torch.autograd.grad((y * tg).sum(), (a, b))
    assert _rel(y, want_y) <= 1e-5
    assert _rel(da, want_da) <= 1e-5
    assert _rel(db, want_db) <= 1e-5


def test_dispatch_gather_matches_jax():
    rng = np.random.default_rng(7)
    s, k, d = 6, 2, 8
    h = rng.standard_normal((s, d)).astype(np.float32)
    g = rng.standard_normal((s * k, d)).astype(np.float32)
    order = rng.permutation(s * k)
    want, vjp = jax.vjp(lambda x: jgm._dispatch_gather(
        x, jnp.asarray(order // k), jnp.asarray(order), k), jnp.asarray(h))
    (want_dh,) = vjp(jnp.asarray(g))
    th = torch.from_numpy(h).requires_grad_(True)
    t_order = torch.from_numpy(order)
    out = gm._dispatch_gather(th, t_order // k, t_order, k)
    (dh,) = torch.autograd.grad(out, th, torch.from_numpy(g))
    np.testing.assert_array_equal(_np(out), np.asarray(want))
    np.testing.assert_allclose(_np(dh), np.asarray(want_dh), rtol=1e-6,
                               atol=1e-6)


def _router_inputs(seed, shape=(2, 5, 64), e=4):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((shape[-1], e)) * shape[-1] ** -0.5).astype(
        np.float32)
    return h, w


def _top_k_margin(h, w, k):
    """The smallest gap between the K-th and (K+1)-th router probability:
    far above f32 noise means no expert can flip between frameworks."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(h) @ jnp.asarray(w), -1))
    srt = np.sort(probs, -1)[..., ::-1]
    return float((srt[..., k - 1] - srt[..., k]).min())


@pytest.mark.parametrize("k", [1, 2])
def test_moe_route_matches_jax(k):
    h, w = _router_inputs(8)
    assert _top_k_margin(h, w, k) > 1e-3
    want_v, want_i, want_aux = jl.moe_route(jnp.asarray(h), jnp.asarray(w),
                                            k)
    vals, idx, aux = tl.moe_route(torch.from_numpy(h), torch.from_numpy(w),
                                  k)
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_v), rtol=1e-6,
                               atol=1e-6)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


def _moe_layer(seed, c):
    rng = np.random.default_rng(seed)
    d, f, e = c.d_model, c.d_ff, c.n_experts

    def w(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(
            np.float32)

    return {"router": w((d, e), d), "moe_gate": w((e, d, f), d),
            "moe_up": w((e, d, f), d), "moe_down": w((e, f, d), f)}


def test_grouped_moe_ffn_values_grads_and_order_match_jax():
    jc = jl.LlamaConfig.tiny_moe(dtype="float32")
    tc = tl.LlamaConfig.tiny_moe(dtype="float32")
    lp = _moe_layer(9, jc)
    h = np.random.default_rng(10).standard_normal((2, 8, 64)).astype(
        np.float32)
    dy = np.random.default_rng(11).standard_normal((2, 8, 64)).astype(
        np.float32)
    assert _top_k_margin(h, lp["router"], 2) > 1e-3

    def jax_loss(h, lp):
        y, aux = jgm.grouped_moe_ffn(h, lp, jc)
        return jnp.sum(y * dy) + aux, (y, aux)

    (_, (want_y, want_aux)), (want_dh, want_dlp) = jax.value_and_grad(
        jax_loss, (0, 1), has_aux=True)(
        jnp.asarray(h), {k: jnp.asarray(v) for k, v in lp.items()})

    th = torch.from_numpy(h).requires_grad_(True)
    tlp = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in lp.items()}
    y, aux = gm.grouped_moe_ffn(th, tlp, tc)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux,
                                [th, *tlp.values()])
    assert _rel(y, want_y) <= 1e-5
    assert float(aux.detach()) == pytest.approx(float(want_aux), rel=1e-6)
    assert _rel(grads[0], want_dh) <= 1e-5
    for name, g in zip(tlp, grads[1:]):
        assert _rel(g, want_dlp[name]) <= 1e-5, name

    # The stable sort: the same slot order as jnp.argsort, so x_sorted
    # equals JAX's row for row.
    _, j_idx, _ = jl.moe_route(jnp.asarray(h.reshape(16, 64)),
                               jnp.asarray(lp["router"]), 2)
    j_order = np.asarray(jnp.argsort(j_idx.reshape(-1)))
    _, t_idx, _ = tl.moe_route(torch.from_numpy(h.reshape(16, 64)),
                               torch.from_numpy(lp["router"]), 2)
    t_order = torch.argsort(t_idx.reshape(-1), stable=True)
    np.testing.assert_array_equal(t_order.numpy(), j_order)
    x_sorted = gm._dispatch_gather(torch.from_numpy(h.reshape(16, 64)),
                                   t_order // 2, t_order, 2)
    np.testing.assert_array_equal(
        x_sorted.numpy(), np.asarray(jgm._dispatch_gather(
            jnp.asarray(h.reshape(16, 64)), jnp.asarray(j_order // 2),
            jnp.asarray(j_order), 2)))


def test_backward_runs_one_dlhs_and_one_tgmm(monkeypatch):
    calls = []
    for name in ("_gmm_reference", "_gmm_dlhs_reference",
                 "_tgmm_reference"):
        plain = getattr(gm, name)

        def counted(*args, _plain=plain, _name=name, **kw):
            calls.append(_name)
            return _plain(*args, **kw)

        monkeypatch.setattr(gm, name, counted)
    (_, tl_), (_, tr), _, (_, tgs) = _operands(12, "float32",
                                              LAYOUTS["ragged"])
    a, b = tl_.requires_grad_(True), tr.requires_grad_(True)
    out = gm._grouped_mm(a, b, tgs, "x")
    assert calls == ["_gmm_reference"]
    out.sum().backward()
    # The dlhs plain version reaches _gmm_reference transposed.
    assert calls == ["_gmm_reference", "_gmm_dlhs_reference",
                     "_gmm_reference", "_tgmm_reference"]
    assert a.grad.shape == a.shape and b.grad.shape == b.shape


def test_no_path_for_other_devices():
    lhs = torch.empty((4, 8), device="meta")
    rhs = torch.empty((2, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no path for meta"):
        gm._gmm_impl(lhs, rhs, torch.tensor([2, 2], dtype=torch.int32))
