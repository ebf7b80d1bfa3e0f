"""Checkpoints of a carry on the card (``horovod_tpu_torch/checkpoint.py``).

Runs only where CUDA is available (``cuda_sm90`` marker, as the kernel
tests); elsewhere every test skips. An async ``CheckpointManager.save``
of a ``fused_adam`` carry on the card (bf16 params and moments, the
int32 0-d count), then at once an in-place apply on the card's Adam
kernel while the write may be in flight: the file holds the bits from
before the apply, bf16 stays bf16, and a restore onto a CUDA target puts
every leaf back on the card. A second save reuses the first one's
pinned buffers and holds the later bits. The one-shot ``save`` and
``restore`` of the same carry onto an f32 CUDA target cast each leaf.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda_sm90


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")
    return torch.device("cuda", 0)


def _carry(card):
    from horovod_tpu_torch.parallel.precision import fused_adam

    g = torch.Generator(device=card).manual_seed(0)
    params = {"w": torch.randn(1024, 512, generator=g, device=card)
              .bfloat16(),
              "b": torch.randn(4096, generator=g, device=card).bfloat16()}
    grads = {k: torch.randn(v.shape, generator=g, device=card).bfloat16()
             for k, v in params.items()}
    opt = fused_adam(1e-2)
    params, state = opt.apply(params, grads, opt.init(params))
    return opt, params, state, grads


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [t for v in tree for t in _leaves(v)]


def test_async_round_trip_with_an_in_place_apply(card, tmp_path):
    from horovod_tpu_torch import checkpoint as ckpt

    opt, params, state, grads = _carry(card)
    before = [t.clone() for t in _leaves((params, state))]
    mgr = ckpt.CheckpointManager(tmp_path / "c", max_to_keep=1)
    assert mgr.save(1, (params, state))
    params, state = opt.apply(params, grads, state)   # in place, at once
    after = [t.clone() for t in _leaves((params, state))]
    assert not torch.equal(after[0], before[0])
    mgr.wait()
    fresh = opt.init({k: torch.zeros_like(v) for k, v in params.items()})
    target = ({k: torch.zeros_like(v) for k, v in params.items()}, fresh)
    got = _leaves(mgr.restore(1, target=target))
    assert len(got) == len(before)
    for g, w in zip(got, before):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g, w)
    pinned = _leaves(mgr._last)
    assert all(t.is_pinned() for t in pinned)
    assert mgr.save(2, (params, state))
    assert all(a is b for a, b in zip(_leaves(mgr._last), pinned))
    opt.apply(params, grads, state)
    mgr.wait()
    assert mgr.all_steps() == [2]
    for g, w in zip(_leaves(mgr.restore(target=target)), after):
        assert torch.equal(g, w)


def test_one_shot_restore_casts_onto_the_target(card, tmp_path):
    from horovod_tpu_torch import checkpoint as ckpt

    _, params, state, _ = _carry(card)
    ckpt.save(tmp_path / "one", {"params": params, "opt": state,
                                 "tag": "run"})
    like = {k: torch.empty(0, dtype=torch.float32, device=card)
            for k in params}
    back = ckpt.restore(tmp_path / "one", target={"params": like})
    assert back["tag"] == "run"
    for k, v in params.items():
        assert back["params"][k].device.type == "cuda"
        assert back["params"][k].dtype == torch.float32
        assert torch.equal(back["params"][k], v.float())
    assert back["opt"].count.device.type == "cpu"
    assert int(back["opt"].count) == 1
