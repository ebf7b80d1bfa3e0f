"""The port's checkpoints (``horovod_tpu_torch/checkpoint.py``) against
the JAX package's (``horovod_tpu/checkpoint.py``).

Case for case with ``tests/single/test_checkpoint.py``: the one-shot
round trip, the manager's retention and steps, a missing step, the
sharded restore onto a mesh, and the elastic states' durable commits
(``TreeState``, the counterpart of ``JaxState``, and ``TorchState``).
The sharded case runs in one spawned gloo world of 4 ranks under
``fsdp=2 x tensor=2`` whose ranks import no JAX: every rank's restored
block is held to the block JAX's ``NamedSharding(mesh, P("fsdp",
"tensor"))`` puts on its device of the same index, onto the saved layout
and onto another one, and to a whole-leaf restore in this process.
Then an async save followed at once by an in-place ``fused_adam`` apply
restores the bits from before the apply, and ``encode_pytree`` marks
the same leaves as JAX's on bf16, 0-d and non-array leaves. Every
comparison is exact: a checkpoint moves bits.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch import checkpoint as ckpt
from tests.test_torch_mp import lazy_module, run_ranks

jax = lazy_module("jax")
jnp = lazy_module("jax.numpy")


def test_one_shot_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "step": np.int64(7)}
    ckpt.save(tmp_path / "one", state)
    back = ckpt.restore(tmp_path / "one")
    np.testing.assert_array_equal(back["params"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert int(back["step"]) == 7
    with pytest.raises(FileExistsError):
        ckpt.save(tmp_path / "one", state, force=False)


def test_manager_retention_and_steps(tmp_path):
    with ckpt.CheckpointManager(tmp_path / "mgr", max_to_keep=2) as mgr:
        for s in (1, 2, 3):
            mgr.save(s, {"x": torch.full((4,), float(s))}, wait=True)
        assert mgr.latest_step() == 3
        np.testing.assert_array_equal(mgr.restore()["x"].numpy(), 3.0)
        np.testing.assert_array_equal(mgr.restore(step=2)["x"].numpy(),
                                      2.0)
    assert sorted(os.listdir(tmp_path / "mgr")) == ["2.pt", "3.pt"]


def test_manager_restore_missing_raises(tmp_path):
    with ckpt.CheckpointManager(tmp_path / "empty") as mgr:
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore()


# ---- the sharded layout: one 4-rank world ------------------------------

def _arrays():
    """The saved leaves: JAX's test array, a seeded bf16 one (as f32
    numpy, exact in bf16) and a replicated one."""
    rng = np.random.default_rng(0)
    bf = torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32))
    return {"w": np.arange(24.0, dtype=np.float32).reshape(4, 6),
            "b": bf.bfloat16().float().numpy(),
            "r": rng.standard_normal(6).astype(np.float32)}


def _port_leaves():
    a = _arrays()
    return {"w": torch.from_numpy(a["w"]),
            "b": torch.from_numpy(a["b"]).bfloat16(),
            "r": torch.from_numpy(a["r"])}


SAVED = {"w": ("fsdp", "tensor"), "b": ("fsdp", "tensor"), "r": ()}
OTHER = {"w": ("tensor", None), "b": (None, ("fsdp", "tensor")),
         "r": ("fsdp",)}


def _specs(entries):
    from horovod_tpu_torch.parallel.sharding import P

    return {k: P(*e) for k, e in entries.items()}


def _sharded_world(rank, size, path):
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel.sharding import leaf_block

    mesh = mesh_mod.create_mesh(device="cpu", fsdp=2, tensor=2)
    full = _port_leaves()
    saved, other = _specs(SAVED), _specs(OTHER)
    blocks = {k: leaf_block(v, saved[k], mesh).clone()
              for k, v in full.items()}
    ckpt.save(path, {"params": blocks, "step": 3, "tag": "run"},
              mesh=mesh, specs={"params": saved})
    same = ckpt.restore(path, target={"params": blocks}, mesh=mesh,
                        specs={"params": saved})
    like = {k: leaf_block(v, other[k], mesh).float()
            for k, v in full.items()}
    moved = ckpt.restore(path, target={"params": like}, mesh=mesh,
                         specs={"params": other})
    f32 = lambda t: t.float().numpy()  # noqa: E731
    return {"jax": "jax" in sys.modules,
            "same": {k: (f32(v), str(v.dtype))
                     for k, v in same["params"].items()},
            "moved": {k: (f32(v), str(v.dtype))
                      for k, v in moved["params"].items()},
            "rest": (same["step"], same["tag"])}


def _jax_blocks(entries):
    """Device r's block of every leaf under ``NamedSharding(mesh,
    P(*entries[k]))`` on JAX's 4-device ``fsdp=2 x tensor=2`` mesh."""
    from jax.sharding import NamedSharding, PartitionSpec

    from horovod_tpu import parallel

    mesh = parallel.create_mesh(fsdp=2, tensor=2, devices=jax.devices()[:4])
    out = {}
    for k, a in _arrays().items():
        arr = jax.device_put(
            jnp.asarray(a, jnp.bfloat16 if k == "b" else jnp.float32),
            NamedSharding(mesh, PartitionSpec(*entries[k])))
        out[k] = {s.device.id: np.asarray(s.data.astype(jnp.float32))
                  for s in arr.addressable_shards}
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "sharded")
    return path, run_ranks(functools.partial(_sharded_world, path=path), 4,
                           timeout=240)


def test_sharded_restore_onto_mesh(sharded):
    path, ranks = sharded
    saved, other = _jax_blocks(SAVED), _jax_blocks(OTHER)
    for r, out in enumerate(ranks):
        assert not out["jax"], "a rank imported JAX"
        assert out["rest"] == (3, "run")
        for k in SAVED:
            got, dtype = out["same"][k]
            assert dtype == ("torch.bfloat16" if k == "b"
                             else "torch.float32")
            np.testing.assert_array_equal(got, saved[k][r], err_msg=k)
            got, dtype = out["moved"][k]
            assert dtype == "torch.float32"
            np.testing.assert_array_equal(got, other[k][r], err_msg=k)
    whole = ckpt.restore(path)
    for k, a in _arrays().items():
        assert whole["params"][k].dtype == _port_leaves()[k].dtype
        np.testing.assert_array_equal(whole["params"][k].float().numpy(),
                                      a, err_msg=k)
    assert (whole["step"], whole["tag"]) == (3, "run")


def test_sharded_save_writes_each_element_once(sharded):
    """Each stored box of a leaf is written once: by the rank at 0 along
    the axes its spec leaves replicated (rank 0 alone for ``r``)."""
    path, ranks = sharded
    written = {}
    for name in os.listdir(path):
        if name.startswith("blocks."):
            part = torch.load(os.path.join(path, name), weights_only=False)
            for key, boxes in part.items():
                written.setdefault(key, []).append(
                    (int(name.split(".")[1]),
                     sum(t.numel() for _, t in boxes)))
    tree = torch.load(os.path.join(path, "tree.pt"), weights_only=False)
    for k, a in _arrays().items():
        leaf = tree["params"][k]
        assert sum(n for _, n in written[leaf.key]) == a.size, k
    writers = sorted(r for r, _ in written[tree["params"]["r"].key])
    assert writers == [0]
    assert sorted(r for r, _ in written[tree["params"]["w"].key]) == \
        [0, 1, 2, 3]


# ---- the elastic states' durable commits --------------------------------

def test_elastic_state_durable_commit_and_resume(tmp_path):
    from horovod_tpu_torch.torch.elastic import TreeState

    s1 = TreeState(checkpoint_dir=tmp_path / "el",
                   params={"w": torch.zeros(3)}, epoch=0)
    s1.params = {"w": torch.full((3,), 5.0)}
    s1.epoch = 4
    s1.commit()
    s1._ckpt_mgr.wait()

    # Cold restart: a fresh state resumes the last durable commit.
    s2 = TreeState(checkpoint_dir=tmp_path / "el",
                   params={"w": torch.zeros(3)}, epoch=0)
    assert s2.resume() == 1
    np.testing.assert_array_equal(s2.params["w"].numpy(), 5.0)
    assert int(s2.epoch) == 4

    # In-memory rollback still works on top.
    s2.params = {"w": torch.full((3,), 9.0)}
    s2.restore()
    np.testing.assert_array_equal(s2.params["w"].numpy(), 5.0)


def test_restart_without_resume_keeps_committing(tmp_path):
    from horovod_tpu_torch.torch.elastic import TreeState

    s1 = TreeState(checkpoint_dir=tmp_path / "el", v=torch.zeros(()))
    s1.v = torch.tensor(1.0)
    s1.commit()
    s1._ckpt_mgr.wait()

    s2 = TreeState(checkpoint_dir=tmp_path / "el", v=torch.zeros(()))
    s2.v = torch.tensor(2.0)
    s2.commit()  # lands as step 2, not a skipped step 1
    s2._ckpt_mgr.wait()
    assert s2._ckpt_mgr.latest_step() == 2

    s3 = TreeState(checkpoint_dir=tmp_path / "el", v=torch.zeros(()))
    assert s3.resume() == 2
    assert float(s3.v) == 2.0


def test_elastic_state_with_non_array_values(tmp_path):
    from horovod_tpu_torch.torch.elastic import TreeState

    s1 = TreeState(checkpoint_dir=tmp_path / "el",
                   params={"w": torch.ones(2)},
                   run_name="exp-42", meta={"lr": 0.1, "tag": "warmup"})
    s1.commit()
    s1._ckpt_mgr.wait()

    s2 = TreeState(checkpoint_dir=tmp_path / "el",
                   params={"w": torch.zeros(2)}, run_name="", meta={})
    assert s2.resume() == 1
    assert s2.run_name == "exp-42"
    assert s2.meta["tag"] == "warmup"
    np.testing.assert_array_equal(s2.params["w"].numpy(), 1.0)


def test_torch_state_durable_commit_and_resume(tmp_path):
    from horovod_tpu_torch.torch.elastic import TorchState

    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    s1 = TorchState(model=model, optimizer=opt,
                    checkpoint_dir=tmp_path / "t", epoch=0)
    with torch.no_grad():
        model.weight.fill_(2.5)
    s1.epoch = 3
    s1.commit()
    s1._ckpt_mgr.wait()

    model2 = torch.nn.Linear(3, 2)
    opt2 = torch.optim.SGD(model2.parameters(), lr=0.1)
    s2 = TorchState(model=model2, optimizer=opt2,
                    checkpoint_dir=tmp_path / "t", epoch=0)
    assert s2.resume() == 1
    assert int(s2.epoch) == 3
    np.testing.assert_array_equal(model2.weight.detach().numpy(), 2.5)


# ---- async saves and the tree codec ------------------------------------

def test_async_save_then_in_place_apply_restores_pre_apply_bits(tmp_path):
    """The port's apply updates params and moments in place; an async
    save returns once its snapshot is on the host, so the apply right
    after it does not reach the file. The next save joins the write in
    flight, and a restore onto a target takes the target's dtype."""
    from horovod_tpu_torch.parallel.precision import fused_adam

    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.standard_normal((16, 8))
                                    .astype(np.float32)).bfloat16(),
              "b": torch.from_numpy(rng.standard_normal(8)
                                    .astype(np.float32))}
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    opt = fused_adam(1e-1)
    params, state = opt.apply(params, grads, opt.init(params))
    clone = lambda t: {k: v.clone() for k, v in t.items()}  # noqa: E731
    before = (clone(params), clone(state.mu), clone(state.nu),
              state.count.clone())
    mgr = ckpt.CheckpointManager(tmp_path / "async", max_to_keep=1)
    assert mgr.save(1, {"params": params, "opt": state})
    params, state = opt.apply(params, grads, state)
    assert not torch.equal(params["w"], before[0]["w"])
    mgr.wait()
    got = mgr.restore(1)
    assert type(got["opt"]).__name__ == "FusedAdamState"
    for k in params:
        for tree, want in zip((got["params"], got["opt"].mu,
                               got["opt"].nu), before[:3]):
            assert tree[k].dtype == want[k].dtype
            assert torch.equal(tree[k], want[k]), k
    assert torch.equal(got["opt"].count, before[3])
    assert got["opt"].count.dim() == 0
    assert mgr.save(2, {"params": params, "opt": state})
    opt.apply(params, grads, state)
    assert mgr.save(3, {"params": params, "opt": state})
    mgr.wait()
    assert mgr.all_steps() == [3]
    back = mgr.restore(target={"params": {k: torch.zeros(v.shape)
                                          for k, v in params.items()}})
    assert back["params"]["w"].dtype == torch.float32
    assert torch.equal(back["params"]["w"], params["w"].float())


class Thing:
    """A leaf that is no number: pickled by ``encode_pytree``."""

    def __eq__(self, other):
        return isinstance(other, Thing)


def test_encode_pytree_bf16_0d_and_objects():
    """The same leaves are marked as by JAX's ``encode_pytree``; bf16,
    0-d and integer tensors pass unchanged and decode to themselves."""
    from horovod_tpu import checkpoint as jckpt

    port = {"w": torch.arange(4.0).bfloat16(), "count": torch.tensor(
        5, dtype=torch.int32), "step": 7, "lr": 0.5, "name": "exp",
        "thing": Thing(), "none": None, "np": np.arange(3)}
    ref = {k: (jnp.asarray(v.float().numpy()) if isinstance(v, torch.Tensor)
               else v) for k, v in port.items()}
    enc, jenc = ckpt.encode_pytree(port), jckpt.encode_pytree(ref)
    marked = {k for k, v in enc.items() if isinstance(v, dict)}
    assert marked == {k for k, v in jenc.items() if isinstance(v, dict)}
    assert marked == {"name", "thing"}
    for k in marked:
        assert enc[k]["__hvd_pickle__"].dtype == torch.uint8
    assert enc["w"] is port["w"] and enc["count"] is port["count"]
    back = ckpt.decode_pytree(enc)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"],
                                                             port["w"])
    assert back["count"].dim() == 0 and back["count"].dtype == torch.int32
    assert back["name"] == "exp" and back["thing"] == Thing()
    assert back["none"] is None and back["step"] == 7
