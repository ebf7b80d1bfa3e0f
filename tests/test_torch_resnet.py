"""The port's ResNet and MLP (``models/{resnet,mlp}.py``) against JAX's.

JAX's ``resnet_init`` draws the params and batch-norm state (every leaf
then perturbed with seeded numpy noise, so that no block's last BN scale
is zero and the running statistics are not the initial ones); both move
to the port through numpy (``from_jax_params``, lists included). At
f32 compute, width 8, depths 18 and 50, on 16 x 16 and 32 x 32 images
(the stem's 7x7/2 pads (2, 3), the max-pool and the stride-2 3x3s (0,
1): "SAME" uneven) and 15 x 15 (the stem pads (3, 3)): the logits and
new running statistics in train and eval mode, ``resnet_loss`` and
every gradient. Tolerance: f32, the same products summed in another
order through up to 50 layers and batch norms: each output within 5e-5
of the largest magnitude of JAX's leaf (and of 1), relative.

The data-parallel step: 2 and 4 gloo ranks, one world each, under
``create_mesh(data=N)``, each rank's shard of an 8-image batch: the loss
(the same on every rank), every parameter's gradient and the new running
statistics equal JAX's unsharded step on the whole batch, within the same
tolerance, as ``__graft_entry__.py:513 _resnet_dp_step`` checks JAX's
GSPMD step against the unsharded one.
"""

import functools

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import convert, mlp, resnet
from horovod_tpu_torch.parallel._tree import tree_leaves, tree_unflatten
from tests.test_torch_mp import lazy_module, run_ranks

# The ranks import this module: JAX is bound lazily, for the oracles.
jax = lazy_module("jax")
jnp = lazy_module("jax.numpy")
jmlp = lazy_module("horovod_tpu.models.mlp")
jresnet = lazy_module("horovod_tpu.models.resnet")

TOL = 5e-5
CLASSES = 7


def _port_config(depth):
    return resnet.ResNetConfig(depth=depth, num_classes=CLASSES, width=8,
                               compute_dtype="float32")


def _config(depth):
    kw = dict(depth=depth, num_classes=CLASSES, width=8,
              compute_dtype="float32")
    return jresnet.ResNetConfig(**kw), _port_config(depth)


@functools.cache
def _jax_model(depth):
    """JAX's params and state (numpy), every leaf perturbed."""
    jcfg, _ = _config(depth)
    params, state = jresnet.resnet_init(jcfg, jax.random.PRNGKey(depth))
    rng = np.random.default_rng(depth)

    def noisy(a, positive=False):
        a = np.asarray(a, np.float32)
        n = rng.standard_normal(a.shape).astype(np.float32)
        return np.abs(a + 0.2 * n) + 0.5 if positive else a + 0.1 * n

    params = jax.tree.map(noisy, params)
    state = jax.tree_util.tree_map_with_path(
        lambda path, a: noisy(a, positive=path[-1].key == "var"), state)
    return params, state


def _batch(n, side, seed):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((n, side, side, 3)).astype(
                np.float32),
            "labels": rng.integers(0, CLASSES, n).astype(np.int32)}


def _torch(tree):
    return convert.from_jax_params(tree, device="cpu")


def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3g} > {TOL}"


def _leaves(tree):
    return jax.tree.leaves(tree)


@functools.cache
def _jax_step(depth, side):
    jcfg, _ = _config(depth)
    params, state = _jax_model(depth)
    batch = _batch(8, side, side)
    (loss, new_state), grads = jax.jit(jax.value_and_grad(
        lambda p, s, b: jresnet.resnet_loss(p, s, b, jcfg), has_aux=True))(
        params, state, batch)
    return loss, new_state, grads


@pytest.mark.parametrize("depth,side", [(18, 16), (18, 15), (50, 32),
                                        (50, 15)])
def test_forward_both_modes_matches_jax(depth, side):
    jcfg, tcfg = _config(depth)
    params, state = _jax_model(depth)
    x = _batch(4, side, side + 100)["images"]
    tp, ts = _torch(params), _torch(state)
    for train in (True, False):
        want, want_s = jax.jit(lambda p, s, x: jresnet.resnet_forward(
            p, s, x, jcfg, train=train))(params, state, x)
        got, got_s = resnet.resnet_forward(tp, ts, torch.from_numpy(x), tcfg,
                                           train=train, device="cpu")
        _close(got, want, f"logits (train={train})")
        flat_want = _leaves(want_s)
        flat_got = tree_leaves(got_s)
        assert len(flat_got) == len(flat_want)
        for i, (g, w) in enumerate(zip(flat_got, flat_want)):
            _close(g, w, f"state leaf {i} (train={train})")


@pytest.mark.parametrize("depth,side", [(18, 16), (50, 32), (50, 15)])
def test_loss_and_gradients_match_jax(depth, side):
    _, tcfg = _config(depth)
    params, state = _jax_model(depth)
    loss, new_state, grads = _jax_step(depth, side)
    tp, ts = _torch(params), _torch(state)
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(8, side, side).items()}
    got, got_s = resnet.resnet_loss(tp, ts, batch, tcfg, device="cpu")
    got_g = torch.autograd.grad(got, leaves)
    _close(got, loss, "loss")
    flat = _leaves(grads)
    assert len(flat) == len(got_g)
    for i, (g, w) in enumerate(zip(got_g, flat)):
        _close(g, w, f"gradient leaf {i}")
    for i, (g, w) in enumerate(zip(tree_leaves(got_s), _leaves(new_state))):
        _close(g, w, f"new state leaf {i}")


def test_init_matches_jax_structure_and_zero_scales():
    for depth in (18, 50):
        jcfg, tcfg = _config(depth)
        jp, js = jresnet.resnet_init(jcfg, jax.random.PRNGKey(0))
        tp, ts = resnet.resnet_init(
            tcfg, torch.Generator().manual_seed(0), device="cpu")
        for t, j in ((tp, jp), (ts, js)):
            assert jax.tree.structure(jax.tree.map(lambda a: 0, j)) == \
                jax.tree.structure(jax.tree.map(
                    lambda a: 0, jax.tree.map(np.asarray, _numpy(t))))
            for a, b in zip(tree_leaves(t), _leaves(j)):
                assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        last = "bn3" if tcfg.bottleneck else "bn2"
        for s in range(4):
            for block in tp[f"stage{s}"]:
                assert not block[last]["scale"].any()


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def test_from_jax_params_carries_lists_and_the_tree_helpers_take_them():
    params, state = _jax_model(18)
    tp = _torch(params)
    assert isinstance(tp["stage0"], list) and len(tp["stage0"]) == 2
    flat = tree_leaves(tp)
    for a, b in zip(flat, _leaves(params)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    back = tree_unflatten(tp, [t * 0 for t in flat])
    assert isinstance(back["stage1"], list)
    assert all(not t.any() for t in tree_leaves(back))


def test_mlp_forward_matches_jax():
    jp = jmlp.mlp_init(jax.random.PRNGKey(3), sizes=(20, 16, 12, 5))
    x = np.random.default_rng(4).standard_normal((6, 20)).astype(np.float32)
    want = jmlp.mlp_forward(jp, jnp.asarray(x))
    got = mlp.mlp_forward(_torch(jp), torch.from_numpy(x))
    _close(got, want, "mlp logits")
    tp = mlp.mlp_init(torch.Generator().manual_seed(0), (20, 16, 5),
                      device="cpu")
    assert [tuple(layer["w"].shape) for layer in tp] == [(20, 16), (16, 5)]


# ---- the data-parallel step -------------------------------------------------


def _dp_worker(params_np, state_np, batch, rank, size):
    from horovod_tpu_torch.parallel import mesh as mesh_mod

    tcfg = _port_config(18)
    mesh = mesh_mod.create_mesh(data=size, device="cpu")
    tp = convert.from_jax_params(params_np, device="cpu")
    ts = convert.from_jax_params(state_np, device="cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    step = len(batch["labels"]) // size
    lo = mesh.axis_index("data") * step
    shard = {k: torch.from_numpy(v[lo:lo + step]) for k, v in batch.items()}
    loss, new_state = resnet.resnet_loss(tp, ts, shard, tcfg, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss), [g.numpy() for g in grads],
            [s.numpy() for s in tree_leaves(new_state)])


@pytest.mark.parametrize("size", [2, 4])
def test_data_parallel_step_matches_unsharded_jax(size):
    params, state = _jax_model(18)
    loss, new_state, grads = _jax_step(18, 16)
    params_np = jax.tree.map(np.asarray, params)
    state_np = jax.tree.map(np.asarray, state)
    per_rank = run_ranks(functools.partial(
        _dp_worker, params_np, state_np, _batch(8, 16, 16)), size,
        timeout=180)
    want_g, want_s = _leaves(grads), _leaves(new_state)
    for rank in range(size):
        got_loss, got_g, got_s = per_rank[rank]
        _close(np.float32(got_loss), loss, f"rank {rank} loss")
        assert len(got_g) == len(want_g)
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            _close(g, w, f"rank {rank} gradient leaf {i}")
        for i, (g, w) in enumerate(zip(got_s, want_s)):
            _close(g, w, f"rank {rank} new state leaf {i}")
