"""``hvd.SyncBatchNorm`` of the port against the reference's, at 2 ranks.

Each rank feeds its half of one seeded global batch
``[8, 3, 5, 5]`` (f32) through ``SyncBatchNorm(3)`` of the reference
``horovod_tpu.torch`` and of ``horovod_tpu_torch.torch``
(``init(device="cpu")``) for two training steps (the running statistics
move twice), with a seeded cotangent; then once in eval mode. Forward
outputs, running mean and variance, and the gradients of input, weight
and bias match the reference's to rtol 1e-5, with two allreduces a
training step and none in eval mode. Both are also held against
``torch.nn.BatchNorm2d`` on the concatenated global batch (the weight
and bias gradients summed over ranks) to rtol 1e-4: SyncBatchNorm takes
the variance as E[x^2] - E[x]^2, BatchNorm2d in two passes.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_hvd_cache import open_lane, run_both

N, C, HW = 4, 3, 5
STEPS = 2


def _global(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _inputs(step):
    """The global batch and cotangent of a step (every rank makes the
    same; each takes its half)."""
    return (_global(10 + step, (2 * N, C, HW, HW)) * 2 + 0.5,
            _global(20 + step, (2 * N, C, HW, HW)))


def _affine():
    return _global(1, (C,)) + 1, _global(2, (C,))


def _run(bn, xs, gs, sl):
    """Training steps then one eval pass; what each produced."""
    out = {}
    weight, bias = _affine()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    for step in range(STEPS):
        x = xs[step][sl].clone().requires_grad_(True)
        bn.weight.grad = bn.bias.grad = None
        y = bn(x)
        (y * gs[step][sl]).sum().backward()
        out[f"{step}.y"] = y.detach().clone()
        out[f"{step}.dx"] = x.grad.clone()
        out[f"{step}.dw"] = bn.weight.grad.clone()
        out[f"{step}.db"] = bn.bias.grad.clone()
        out[f"{step}.mean"] = bn.running_mean.clone()
        out[f"{step}.var"] = bn.running_var.clone()
    bn.eval()
    with torch.no_grad():
        out["eval.y"] = bn(xs[0][sl]).clone()
    return {k: v.numpy() for k, v in out.items()}


def _sync_bn(rank, size, impl):
    hvd, _ = open_lane(impl)
    try:
        batches = [_inputs(step) for step in range(STEPS)]
        out = _run(hvd.SyncBatchNorm(C), [b[0] for b in batches],
                   [b[1] for b in batches], slice(rank * N, (rank + 1) * N))
        # One forward and one backward allreduce a step; none in eval.
        out["allreduces"] = np.array(
            hvd.metrics()["ops"]["allreduce"]["tensors"])
        return out
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def lanes():
    return run_both(_sync_bn, 2)


def test_matches_reference(lanes):
    ref, port = lanes
    for rank in range(2):
        assert set(port[rank]) == set(ref[rank])
        for key, want in ref[rank].items():
            np.testing.assert_allclose(port[rank][key], want, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{rank} {key}")
        assert port[rank]["allreduces"] == 2 * STEPS


def test_matches_batch_norm_on_the_global_batch(lanes):
    _, port = lanes
    batches = [_inputs(step) for step in range(STEPS)]
    want = _run(torch.nn.BatchNorm2d(C), [b[0] for b in batches],
                [b[1] for b in batches], slice(None))
    for step in range(STEPS):
        for key in ("y", "dx"):
            got = np.concatenate([out[f"{step}.{key}"] for out in port])
            np.testing.assert_allclose(got, want[f"{step}.{key}"],
                                       rtol=1e-4, atol=1e-5, err_msg=key)
        for key in ("dw", "db"):
            got = sum(out[f"{step}.{key}"] for out in port)
            np.testing.assert_allclose(got, want[f"{step}.{key}"],
                                       rtol=1e-4, atol=1e-4, err_msg=key)
        for key in ("mean", "var"):
            for out in port:
                np.testing.assert_allclose(out[f"{step}.{key}"],
                                           want[f"{step}.{key}"], rtol=1e-4,
                                           atol=1e-5, err_msg=key)
    eval_y = np.concatenate([out["eval.y"] for out in port])
    np.testing.assert_allclose(eval_y, want["eval.y"], rtol=1e-4, atol=1e-5)
