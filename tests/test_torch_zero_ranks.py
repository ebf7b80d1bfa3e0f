"""ZeRO-1 on both lanes across gloo ranks, against the JAX package.

One port world and one reference world of 2 ranks, and again of 4, run
everything (``run_both``, started together); JAX's single-process
references run here.

The jit lane (``make_split_train_step(zero=...)``), fused and unfused
(``HOROVOD_JIT_FUSION``), 3 steps:

- ``tests/single/test_zero.py:217``'s MLP (numpy-seeded) at 2
  microbatches, ``fused_adam`` and ``fused_master_adam``, each rank on
  its share of the batch with a plain per-rank mean loss and no mesh,
  against JAX's ``make_split_train_step(zero=ZeroConfig(size=N))`` on
  the full batch;
- the tiny Llama with ``llama_loss(mesh=)`` under ``data=2`` (2 ranks)
  and ``data=2 x seq=2`` (4 ranks), against JAX's ZeRO step with
  ``ZeroConfig(size=2)`` on the full batch (Pallas in interpret mode).

Fused and unfused give the same bits; every rank holds the same params;
each rank's mu/nu (and master) are block r of JAX's state
(``from_jax_zero_state``; under the mesh r is the rank's ``data``
coordinate). Tolerances are ``tests/test_torch_train_step.py``'s: losses
1e-5 relative, params 1e-4 absolute at learning rate 1e-3; the moments
1e-5 of each leaf's largest entry (an f32 summation-order difference in
the gradient, carried by the moving averages).

The eager lane, against the reference's ``horovod_tpu.jax`` on its own
world with the same inputs (``tests/parallel/test_zero_eager.py:26``'s
shapes):

- ``DistributedFusedAdam(zero=True)``: params and state within the
  tolerances above of the reference's, ``overlap`` on and off bit-equal,
  per-rank state under 1.15/N of the replicated state, reducescatter and
  allgather with no allreduce in the metrics, the logical bytes within
  1% of ``horovod_tpu.telemetry.predict.zero_layout_bytes``; with
  ``Compression.bf16`` the same bits on every rank;
- ``zero=False`` and ``allreduce_gradients`` (f32 and bf16 leaves)
  against the reference's;
- ``make_fused_train_step`` on ``tests/parallel/test_fusion.py:30``'s
  MLP, each rank on its own rows: fused against unfused bitwise (losses
  and params), the losses against the reference's fused step;
- the lane's flat reducescatter books the ring reduce-scatter's bytes
  (``data_plane.ring_reducescatter_bytes``), as the reference core's
  counters do.
"""

import functools
import importlib

import numpy as np
import pytest

from tests.test_torch_hvd_cache import run_both
from tests.test_torch_mp import lazy_module

# The ranks import this module: JAX is bound lazily, for the oracles and
# the reference lane's ranks.
jax = lazy_module("jax")
jnp = lazy_module("jax.numpy")

LR = 1e-3
STEPS = 3
TIMEOUT = 240
EAGER_SHAPES = [(48, 16), (33,), (16, 8), (65,)]
FUSION_SHAPES = {"w1": (16, 32), "w2": (32, 16), "b2": (16,), "w3": (16, 4)}
RS_ROWS = (7, 33)     # rows that split unevenly over 2 and 4 ranks


# ---- problems (numpy-seeded, shared by every lane) -------------------

def _mlp_problem():
    rng = np.random.default_rng(11)
    params = {"w1": (rng.standard_normal((8, 16)) * 0.1).astype(np.float32),
              "b1": np.zeros((13,), np.float32),
              "w2": (rng.standard_normal((16, 4)) * 0.1).astype(np.float32)}
    batch = {"x": rng.standard_normal((8, 8)).astype(np.float32),
             "y": rng.standard_normal((8, 4)).astype(np.float32)}
    return params, batch


def _mlp_loss_jax(p, d):
    h = jnp.tanh(d["x"] @ p["w1"] + p["b1"][:16].sum())
    return jnp.mean((h @ p["w2"] - d["y"]) ** 2)


def _mlp_loss_torch(p, d):
    import torch

    h = torch.tanh(d["x"] @ p["w1"] + p["b1"][:16].sum())
    return torch.mean((h @ p["w2"] - d["y"]) ** 2)


def _rows(batch, rank, size):
    n = next(iter(batch.values())).shape[0] // size
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _llama_problem():
    from horovod_tpu.models import llama as jl

    jc = jl.LlamaConfig.tiny(dtype="float32", remat=False)
    jparams = jax.tree.map(np.asarray,
                           jl.llama_init(jc, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jc.vocab_size, (4, 16)).astype(np.int32)
    # No mask: a masked mean is not linear in the batch, and JAX's
    # microbatches (rows 0-1, 2-3) are not the mesh's (rows k and 2 + k).
    return jc, jparams, {"tokens": tokens,
                         "targets": np.roll(tokens, -1, 1)}


def _eager_inputs(rank):
    rng = np.random.default_rng([21, rank])
    params = {f"p{i}": np.full(s, 0.05 * (i + 1), np.float32)
              for i, s in enumerate(EAGER_SHAPES)}
    grads = {f"p{i}": rng.standard_normal(s).astype(np.float32)
             for i, s in enumerate(EAGER_SHAPES)}
    return params, grads


def _fusion_problem():
    rng = np.random.default_rng(31)
    params = {k: (np.zeros(s, np.float32) if len(s) == 1 else
                  (rng.standard_normal(s) * 0.1).astype(np.float32))
              for k, s in FUSION_SHAPES.items()}
    batch = {"x": rng.standard_normal((8, 16)).astype(np.float32),
             "y": rng.standard_normal((8, 4)).astype(np.float32)}
    return params, batch


def _fusion_loss(p, d, tanh, mean):
    h = tanh(d["x"] @ p["w1"])
    h = tanh(h @ p["w2"] + p["b2"])
    return mean((h @ p["w3"] - d["y"]) ** 2)


def _np(tree):
    """A tree of tensors -> numpy (bf16 as its uint16 bits)."""
    import torch

    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_np(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


# ---- the port's world ------------------------------------------------

def _jit_lane(loss_fn, opt_fn, params, batch, zero, microbatches):
    """Fused and unfused runs of the ZeRO split step: per schedule the
    losses, params and state."""
    from horovod_tpu_torch.parallel import fusion, train_step

    out = {}
    for fused in (True, False):
        fusion.set_jit_fusion(fused)
        try:
            ts = train_step.make_split_train_step(
                loss_fn, opt_fn(), microbatches=microbatches, zero=zero)
            carry = ts.init({k: v.clone() if not isinstance(v, dict) else
                             {a: b.clone() for a, b in v.items()}
                             for k, v in params.items()})
            losses = []
            for _ in range(STEPS):
                loss, carry = ts.step(carry, batch)
                losses.append(float(loss))
        finally:
            fusion.set_jit_fusion(None)
        out[fused] = {"losses": losses, "params": _np(carry[0]),
                      "state": {f: _np(getattr(carry[1], f))
                                for f in carry[1]._fields}}
    return out


def _port_jit(rank, size):
    import torch

    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.models.convert import from_jax_params
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import precision
    from horovod_tpu_torch.parallel.zero import ZeroConfig

    out = {}
    params, batch = _mlp_problem()
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    local = {k: torch.from_numpy(v) for k, v in
             _rows(batch, rank, size).items()}
    for kind, opt_fn, bucket in (
            ("adam", lambda: precision.fused_adam(LR), 128),
            ("master", lambda: precision.fused_master_adam(
                LR, compute_dtype=torch.float32), 1 << 20)):
        out[f"mlp.{kind}"] = _jit_lane(
            _mlp_loss_torch, opt_fn, tparams, local,
            ZeroConfig(size=size, bucket_bytes=bucket), 2)

    jc, jparams, lbatch = _llama_problem()
    mesh = mesh_mod.create_mesh(data=2, seq=size // 2, device="cpu")
    cfg = tl.LlamaConfig.tiny(dtype="float32", remat="attn+gate")
    out["llama"] = _jit_lane(
        lambda p, d: tl.llama_loss(p, d, cfg, mesh=mesh),
        lambda: precision.fused_adam(LR),
        from_jax_params(jparams, device="cpu"), mesh.shard_batch(lbatch),
        ZeroConfig(mesh=mesh, bucket_bytes=1 << 14), 2)
    out["coords"] = dict(mesh.coords)
    return out


def _port_eager(hvd, rank, size):
    import torch

    from horovod_tpu_torch.parallel import fusion, precision
    from horovod_tpu_torch.parallel.zero import optimizer_state_bytes

    def tensors(tree):
        return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}

    out = {}
    params, grads = _eager_inputs(rank)
    for name, kw in (("overlap", {}), ("phased", {"overlap": False}),
                     ("bf16", {"compression": hvd.Compression.bf16})):
        opt = hvd.DistributedFusedAdam(LR, zero=True, bucket_bytes=2048,
                                       **kw)
        p = tensors(params)
        state = opt.init(p)
        hvd.metrics_reset()
        for _ in range(STEPS):
            p, state = opt.apply(p, tensors(grads), state)
        snap = hvd.metrics()
        out[f"zero.{name}"] = {"params": _np(p), "mu": _np(state["mu"]),
                               "nu": _np(state["nu"]),
                               "bytes": optimizer_state_bytes(state),
                               "ops": snap["ops"]}
    rep = precision.fused_adam(LR)
    out["replicated_bytes"] = optimizer_state_bytes(
        rep.init(tensors(params)))
    opt = hvd.DistributedFusedAdam(LR)
    p = tensors(params)
    state = opt.init(p)
    for _ in range(STEPS):
        p, state = opt.apply(p, tensors(grads), state)
    out["replicated"] = _np(p)
    mixed = dict(tensors(grads), h=torch.from_numpy(
        grads["p1"] * 3).to(torch.bfloat16))
    out["allreduce_gradients"] = _np(hvd.allreduce_gradients(mixed))

    fparams, fbatch = _fusion_problem()
    local = {k: torch.from_numpy(v) for k, v in
             _rows(fbatch, rank, size).items()}
    init, step, finish = hvd.make_fused_train_step(
        lambda p, d: _fusion_loss(p, d, torch.tanh, torch.mean), LR,
        bucket_bytes=2048)
    for fused in (True, False):
        fusion.set_jit_fusion(fused)
        try:
            carry = init(tensors(fparams))
            losses, lagging = [], []
            for _ in range(STEPS + 1):
                loss, carry = step(carry, local)
                losses.append(float(loss))
                lagging.append(carry[2] is not None)
            p, carry = finish(carry)
        finally:
            fusion.set_jit_fusion(None)
        out[f"fused_step.{fused}"] = {"losses": losses, "params": _np(p),
                                      "lagging": lagging,
                                      "drained": carry[2] is None}
    return out


def _rs_wire(hvd_or_lane, rank, impl):
    """A reducescatter's ``wire`` tx/rx bytes on this rank."""
    x = np.random.default_rng([41, rank]).standard_normal(
        RS_ROWS).astype(np.float32)
    if impl == "ref":
        import horovod_tpu.jax as hvd
        from horovod_tpu.common.basics import HorovodBasics

        b = HorovodBasics()
        w0 = b.metrics_snapshot()["wire"]
        hvd.reducescatter(jnp.asarray(x), name="rs.wire", op=hvd.Sum)
        w1 = b.metrics_snapshot()["wire"]
    else:
        import torch

        hvd = hvd_or_lane
        w0 = hvd.metrics()["wire"]
        hvd.reducescatter(torch.from_numpy(x), name="rs.wire", op=hvd.Sum)
        w1 = hvd.metrics()["wire"]
    return {k: w1[k] - w0[k] for k in ("tx_bytes", "rx_bytes")}


def _ref_eager(rank, size):
    import horovod_tpu.jax as hvd
    from horovod_tpu.parallel import fusion

    def arrays(tree):
        return {k: jnp.asarray(v) for k, v in tree.items()}

    out = {}
    params, grads = _eager_inputs(rank)
    opt = hvd.DistributedFusedAdam(LR, zero=True, bucket_bytes=2048)
    p = arrays(params)
    state = opt.init(p)
    for _ in range(STEPS):
        p, state = opt.apply(p, arrays(grads), state)
    out["zero"] = {"params": jax.tree.map(np.asarray, p),
                   "mu": [np.asarray(m) for m in state["mu"]],
                   "nu": [np.asarray(m) for m in state["nu"]]}
    opt = hvd.DistributedFusedAdam(LR)
    p = arrays(params)
    state = opt.init(p)
    for _ in range(STEPS):
        p, state = opt.apply(p, arrays(grads), state)
    out["replicated"] = jax.tree.map(np.asarray, p)
    mixed = dict(arrays(grads), h=jnp.asarray(grads["p1"] * 3,
                                              jnp.bfloat16))
    out["allreduce_gradients"] = {
        k: (np.asarray(v).view(np.uint16) if v.dtype == jnp.bfloat16
            else np.asarray(v))
        for k, v in hvd.allreduce_gradients(mixed).items()}

    fparams, fbatch = _fusion_problem()
    local = arrays(_rows(fbatch, rank, size))
    init, step, finish = hvd.make_fused_train_step(
        lambda p, d: _fusion_loss(p, d, jnp.tanh, jnp.mean), LR,
        bucket_bytes=2048)
    fusion.set_jit_fusion(True)
    try:
        carry = init(arrays(fparams))
        losses = []
        for _ in range(STEPS + 1):
            loss, carry = step(carry, local)
            losses.append(float(loss))
        p, _ = finish(carry)
    finally:
        fusion.set_jit_fusion(None)
    out["fused_step"] = {"losses": losses,
                         "params": jax.tree.map(np.asarray, p)}
    return out


def _world(rank, size, impl):
    if impl == "ref":
        import horovod_tpu.jax as hvd

        hvd.init()
        try:
            out = _ref_eager(rank, size)
            out["rs_wire"] = _rs_wire(None, rank, "ref")
            return out
        finally:
            hvd.shutdown()
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    try:
        out = {"jit": _port_jit(rank, size),
               "eager": _port_eager(hvd, rank, size)}
        out["rs_wire"] = _rs_wire(hvd, rank, "port")
        return out
    finally:
        hvd.shutdown()


# ---- JAX's references (single process) --------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mlp(kind, size):
    from horovod_tpu.parallel.zero import ZeroConfig
    from horovod_tpu.parallel.precision import fused_adam, fused_master_adam
    from horovod_tpu.parallel.train_step import make_split_train_step

    params, batch = _mlp_problem()
    opt, bucket = ((fused_adam(LR), 128) if kind == "adam" else
                   (fused_master_adam(LR, compute_dtype=jnp.float32),
                    1 << 20))
    ts = make_split_train_step(_mlp_loss_jax, opt, microbatches=2,
                               zero=ZeroConfig(size=size,
                                               bucket_bytes=bucket))
    carry = ts.init(jax.tree.map(jnp.asarray, params))
    batch = jax.tree.map(jnp.asarray, batch)
    losses = []
    for _ in range(STEPS):
        loss, carry = ts.step(carry, batch)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, carry)


@functools.lru_cache(maxsize=None)
def _jax_llama():
    from horovod_tpu.models import llama as jl
    from horovod_tpu.parallel.zero import ZeroConfig
    from horovod_tpu.parallel.precision import fused_adam
    from horovod_tpu.parallel.train_step import make_split_train_step

    fa_mod = importlib.import_module("horovod_tpu.ops.flash_attention")
    jc, jparams, batch = _llama_problem()
    fa_mod._INTERPRET = True
    try:
        ts = make_split_train_step(
            lambda p, d: jl.llama_loss(p, d, jc), fused_adam(LR),
            microbatches=2,
            zero=ZeroConfig(size=2, bucket_bytes=1 << 14))
        carry = ts.init(jax.tree.map(jnp.asarray, jparams))
        batch = jax.tree.map(jnp.asarray, batch)
        losses = []
        for _ in range(STEPS):
            loss, carry = ts.step(carry, batch)
            losses.append(float(loss))
    finally:
        fa_mod._INTERPRET = False
    return losses, jax.tree.map(np.asarray, carry)


@pytest.fixture(scope="module")
def worlds():
    return {size: run_both(_world, size, timeout=TIMEOUT)
            for size in (2, 4)}


# ---- checks ----------------------------------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, (dict, list, tuple)):
        items = sorted(tree.items()) if isinstance(tree, dict) else \
            enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_same_bits(a, b, what):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k].view(np.uint8),
                                      fb[k].view(np.uint8),
                                      err_msg=f"{what} {k}")


def _assert_params_close(got, want, what):
    fg, fw = _flat(got), _flat(want)
    assert fg.keys() == fw.keys()
    for k in fg:
        np.testing.assert_allclose(fg[k], fw[k], rtol=0, atol=1e-4,
                                   err_msg=f"{what} {k}")


def _assert_moments_close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{what} bucket {i}")


def _check_jit(ranks, jax_losses, jax_carry, zero_rank, mean_loss):
    from horovod_tpu_torch.models.convert import from_jax_zero_state

    size = max(zero_rank) + 1
    first = ranks[0]
    for r, run in enumerate(ranks):
        # The knob changes the schedule, never the bits.
        _assert_same_bits(run[True]["params"], run[False]["params"],
                          f"rank {r} fused/unfused params")
        _assert_same_bits(run[True]["state"], run[False]["state"],
                          f"rank {r} fused/unfused state")
        assert run[True]["losses"] == run[False]["losses"]
        _assert_same_bits(run[True]["params"], first[True]["params"],
                          f"rank {r} against rank 0")
    losses = np.mean([run[True]["losses"] for run in ranks], axis=0) \
        if mean_loss else ranks[0][True]["losses"]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    _assert_params_close(first[True]["params"], jax_carry[0], "params")
    jstate = jax_carry[1]
    for r, run in enumerate(ranks):
        block = from_jax_zero_state(jstate, zero_rank[r], size,
                                    device="cpu")
        state = run[True]["state"]
        assert state["count"].tolist() == [STEPS]
        for f in block._fields[1:]:
            want = [t.numpy() for t in getattr(block, f)]
            if f == "master":
                _assert_params_close(
                    {str(i): g for i, g in enumerate(state[f])},
                    {str(i): w for i, w in enumerate(want)}, f"master {r}")
            else:
                _assert_moments_close(state[f], want, f"rank {r} {f}")


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("kind", ["adam", "master"])
def test_jit_lane_matches_jax_zero_step(worlds, size, kind):
    ranks = [p["jit"][f"mlp.{kind}"] for p in worlds[size][1]]
    losses, carry = _jax_mlp(kind, size)
    _check_jit(ranks, losses, carry, list(range(size)), mean_loss=True)


@pytest.mark.parametrize("size", [2, 4])
def test_llama_under_a_mesh_matches_jax_zero_step(worlds, size):
    port = worlds[size][1]
    losses, carry = _jax_llama()
    _check_jit([p["jit"]["llama"] for p in port], losses, carry,
               [p["jit"]["coords"]["data"] for p in port], mean_loss=False)


@pytest.mark.parametrize("size", [2, 4])
def test_eager_zero_matches_the_reference(worlds, size):
    from horovod_tpu.parallel.zero import zero_bucket_layout
    from horovod_tpu.telemetry.predict import zero_layout_bytes

    ref, port = worlds[size]
    params, _ = _eager_inputs(0)
    layout = zero_bucket_layout([jnp.asarray(v) for v in params.values()],
                                size, 2048)
    predicted = zero_layout_bytes(layout) * STEPS
    for r in range(size):
        e = port[r]["eager"]
        z, want = e["zero.overlap"], ref[r]["zero"]
        # Overlap is a schedule: the same bits.
        _assert_same_bits(z["params"], e["zero.phased"]["params"],
                          "overlap/phased")
        _assert_same_bits(z["params"], port[0]["eager"]["zero.overlap"]
                          ["params"], f"rank {r} against rank 0")
        _assert_params_close(z["params"], want["params"], "zero params")
        _assert_moments_close(z["mu"], want["mu"], "mu")
        _assert_moments_close(z["nu"], want["nu"], "nu")
        assert z["bytes"] < e["replicated_bytes"] / size * 1.15
        ops = z["ops"]
        assert ops.get("allreduce", {}).get("tensors", 0) == 0
        assert ops["reducescatter"]["tensors"] == \
            ops["allgather"]["tensors"] == len(layout.buckets) * STEPS
        moved = ops["reducescatter"]["bytes"] + ops["allgather"]["bytes"]
        assert abs(moved / predicted - 1.0) < 0.01, (moved, predicted)
        _assert_params_close(e["replicated"], ref[r]["replicated"],
                             "zero=False")
        _assert_params_close(z["params"], e["replicated"],
                             "zero against zero=False")
        got, want = e["allreduce_gradients"], ref[r]["allreduce_gradients"]
        _assert_params_close({k: v for k, v in got.items() if k != "h"},
                             {k: v for k, v in want.items() if k != "h"},
                             "allreduce_gradients")
        # bf16 at 2 ranks is one exact rounding of a two-term sum.
        if size == 2:
            np.testing.assert_array_equal(got["h"], want["h"])


@pytest.mark.parametrize("size", [2, 4])
def test_eager_bf16_compression_same_bits_on_every_rank(worlds, size):
    port = worlds[size][1]
    for r in range(size):
        _assert_same_bits(port[r]["eager"]["zero.bf16"]["params"],
                          port[0]["eager"]["zero.bf16"]["params"],
                          f"rank {r}")


@pytest.mark.parametrize("size", [2, 4])
def test_fused_train_step_matches_unfused_and_the_reference(worlds, size):
    ref, port = worlds[size]
    for r in range(size):
        f = port[r]["eager"]["fused_step.True"]
        u = port[r]["eager"]["fused_step.False"]
        assert f["losses"] == u["losses"]
        _assert_same_bits(f["params"], u["params"], "fused/unfused")
        assert f["lagging"] == [True] * (STEPS + 1) and f["drained"]
        assert u["lagging"] == [False] * (STEPS + 1)
        np.testing.assert_allclose(f["losses"],
                                   ref[r]["fused_step"]["losses"],
                                   rtol=1e-5)
        _assert_params_close(f["params"], ref[r]["fused_step"]["params"],
                             "fused step")


@pytest.mark.parametrize("size", [2, 4])
def test_reducescatter_books_the_ring_reduce_scatter(worlds, size):
    from horovod_tpu_torch.common.data_plane import (
        ring_allreduce_bytes,
        ring_reducescatter_bytes,
    )
    from horovod_tpu_torch.ops.wire_codec import Segments

    ref, port = worlds[size]
    seg = Segments.rows(RS_ROWS[0], RS_ROWS[1], size)
    counts = [4 * seg.count(j) for j in range(size)]
    for r in range(size):
        got = port[r]["rs_wire"]
        want = ring_reducescatter_bytes(counts, r)
        assert (got["tx_bytes"], got["rx_bytes"]) == want
        assert got["tx_bytes"] < ring_allreduce_bytes(counts, r)[0]
        assert got == ref[r]["rs_wire"]
