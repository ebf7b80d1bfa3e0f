"""The MoE router's top-K order on exact ties, against the JAX package.

``lax.top_k`` puts the lower expert index first when two probabilities
are exactly equal; ``torch.topk`` promises no order on ties. The port's
``moe_route`` takes the first K columns of a stable descending sort, so
on a tie it picks, and ranks first, the same expert as JAX. Both MoE
paths go through it: the grouped dispatch (``grouped_moe_ffn``) and the
decode step's top-K weight gather (``_moe_ffn_topk``).

Inputs are made with numpy and built so that the ties are exact: two
identical router columns tie in every row, zero rows tie across all E
experts, and a router whose columns are exact multiples (2x, -1x) of one
column puts that tie at the K-th place in every row. Each test asserts
its ties before it compares. Tolerances are those of the untied tests:
router values 1e-6 (``test_torch_grouped_moe.py``), the FFN output 1e-5
of its largest entry and the aux loss 1e-6 relative (the same f32
arithmetic summed in another order), the decode FFN 1e-5
(``test_torch_moe_llama.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import generate as jg
from horovod_tpu.models import llama as jl
from horovod_tpu.ops import grouped_moe as jgm
from horovod_tpu_torch.models import generate as tg
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.ops import grouped_moe as gm

D_MODEL = 64


def _probs(h, w):
    """JAX's and the port's router probabilities, as numpy."""
    jp = np.asarray(jax.nn.softmax(jnp.asarray(h) @ jnp.asarray(w), -1))
    tp = torch.softmax(torch.from_numpy(h) @ torch.from_numpy(w), -1)
    return jp, tp.numpy()


def _pair_tied_router(seed, rows, e):
    """Columns 0 and 1 of the router equal (a tie in every row), and
    the first five rows of h zero (all E probabilities equal)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((rows, D_MODEL)).astype(np.float32)
    w = (rng.standard_normal((D_MODEL, e)) * D_MODEL ** -0.5).astype(
        np.float32)
    w[:, 1] = w[:, 0]
    h[:5] = 0.0
    return h, w


def _boundary_tied_router(seed, e=4):
    """Router [D, E] with columns (x, x, 2x, -x): with K = 2 the two
    equal columns tie at the second and third place in every row whose
    logit x is not 0, so the tie decides which expert is routed."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(D_MODEL) * D_MODEL ** -0.5).astype(np.float32)
    w = np.zeros((D_MODEL, e), np.float32)
    w[:, 0], w[:, 1], w[:, 2], w[:, 3] = x, x, 2 * x, -x
    return w


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("e", [4, 8, 64])
def test_moe_route_breaks_exact_ties_like_lax_top_k(e, k):
    h, w = _pair_tied_router(e, 64, e)
    for probs in _probs(h, w):
        assert (probs[:, 0] == probs[:, 1]).all()
        assert (probs[:5] == probs[:5, :1]).all()
    jp, _ = _probs(h, w)
    # The tie reaches the first K + 1 places somewhere, so it decides
    # an index that is compared below.
    rank = (jp > jp[:, :1]).sum(-1)
    assert (rank < k + 1).any()
    want_v, want_i, want_aux = jl.moe_route(jnp.asarray(h), jnp.asarray(w),
                                            k)
    vals, idx, aux = tl.moe_route(torch.from_numpy(h), torch.from_numpy(w),
                                  k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_v), rtol=1e-6,
                               atol=1e-6)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    # Every fully tied row routes to experts 0 .. K-1, in order.
    np.testing.assert_array_equal(idx.numpy()[:5],
                                  np.tile(np.arange(k), (5, 1)))


def _tied_layer(seed, c):
    rng = np.random.default_rng(seed)
    d, f, e = c.d_model, c.d_ff, c.n_experts

    def w(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(
            np.float32)

    return {"router": _boundary_tied_router(seed, e),
            "moe_gate": w((e, d, f), d), "moe_up": w((e, d, f), d),
            "moe_down": w((e, f, d), f)}


def _assert_boundary_tie(h, w):
    for probs in _probs(h.reshape(-1, D_MODEL), w):
        assert (probs[:, 0] == probs[:, 1]).all()
        top = np.sort(probs, -1)[:, ::-1]
        assert (top[:, 1] == top[:, 2]).all()


def test_grouped_moe_ffn_matches_jax_on_exact_ties():
    jc = jl.LlamaConfig.tiny_moe(dtype="float32")
    tc = tl.LlamaConfig.tiny_moe(dtype="float32")
    assert (jc.d_model, jc.n_experts, jc.n_experts_per_token) == (
        D_MODEL, 4, 2)
    lp = _tied_layer(12, jc)
    h = np.random.default_rng(13).standard_normal((2, 8, D_MODEL)).astype(
        np.float32)
    _assert_boundary_tie(h, lp["router"])
    want_y, want_aux = jgm.grouped_moe_ffn(
        jnp.asarray(h), {k: jnp.asarray(v) for k, v in lp.items()}, jc)
    y, aux = gm.grouped_moe_ffn(
        torch.from_numpy(h), {k: torch.from_numpy(v) for k, v in lp.items()},
        tc)
    want = np.asarray(want_y)
    err = np.abs(y.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    # Expert 1 loses every tie: its group is empty on both sides.
    _, idx, _ = tl.moe_route(torch.from_numpy(h.reshape(-1, D_MODEL)),
                             torch.from_numpy(lp["router"]), 2)
    assert not (idx == 1).any()


@pytest.mark.parametrize("seed", [14, 15])
def test_topk_decode_ffn_matches_jax_on_exact_ties(seed):
    """The decode step's top-K weight gather (b = 1: B*T*K < E)."""
    jc = jl.LlamaConfig.tiny_moe(dtype="float32")
    tc = tl.LlamaConfig.tiny_moe(dtype="float32")
    lp = _tied_layer(seed, jc)
    h = np.random.default_rng(seed + 100).standard_normal(
        (1, 1, D_MODEL)).astype(np.float32)
    _assert_boundary_tie(h, lp["router"])
    want = jg._moe_ffn_topk(jnp.asarray(h),
                            {k: jnp.asarray(v) for k, v in lp.items()}, jc)
    out = tg._moe_ffn_topk(torch.from_numpy(h),
                           {k: torch.from_numpy(v) for k, v in lp.items()},
                           tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
