"""The port's resharding planner and its executors, against the JAX
package's ``horovod_tpu/parallel/reshard.py``.

- The planner (numpy only, copied): on hypothesis-drawn shapes, rank
  counts 1-6, dtypes and layouts of all three kinds (``from_rows`` ones
  with 0-row ranks included), the port's ``plan_redistribute`` equals
  JAX's (the steps, each rank's tx/rx bytes, ``expected_collectives``)
  and its ``simulate_plan`` gives JAX's blocks; ``src -> dst -> src`` is
  the identity; the ring byte helpers agree.
- The executors on one world of 4 gloo ranks: ``execute_plan`` for
  every step kind (f32, bf16 and int64 rows), ``reshard_rows`` from
  uneven holdings with empty ranks, and ``redistribute`` between
  ``(mesh, spec)`` layouts (with replicas and a block order that is not
  the rank order), each equal to ``simulate_plan`` (or the full array's
  slice) bit for bit, on the input's device and dtype; a zero-copy plan
  returns the same tensor.
- ``alltoallv_splits``: each destination's block joined from the
  segments the plan's alltoallv sends it equals ``simulate_plan``.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import horovod_tpu_torch.parallel.reshard as tr
from tests.test_torch_mp import lazy_module, run_ranks

# The ranks import this module: JAX is bound lazily, for the oracles.
jr = lazy_module("horovod_tpu.parallel.reshard")

N_RANKS = 4
ROWS = 14


# ---- the planner against JAX's ----------------------------------------

def _as(mod, layout):
    """``layout`` (either package's) as ``mod``'s Layout."""
    return mod.Layout(layout.kind, layout.nranks, tuple(layout.rows))


@st.composite
def _layout(draw, n_rows, nranks, kinds):
    kind = draw(st.sampled_from(kinds))
    if kind == "replicated":
        return tr.Layout.replicated(nranks)
    if kind == "partial":
        return tr.Layout.partial(nranks)
    if kind == "even":
        return tr.Layout.sharded(n_rows, nranks)
    cuts = sorted(draw(st.lists(st.integers(0, n_rows), min_size=nranks - 1,
                                max_size=nranks - 1)))
    edges = [0] + cuts + [n_rows]
    return tr.rows_layout([b - a for a, b in zip(edges, edges[1:])])


@st.composite
def _case(draw):
    nranks = draw(st.integers(1, 6))
    n_rows = draw(st.integers(0, 17))
    tail = draw(st.sampled_from([(), (2,), (3, 2)]))
    dtype = draw(st.sampled_from([np.float32, np.float64, np.int8]))
    src = draw(_layout(n_rows, nranks,
                       ["replicated", "partial", "even", "rows"]))
    dst = draw(_layout(n_rows, nranks, ["replicated", "even", "rows"]))
    compressed = draw(st.booleans())
    return (n_rows,) + tail, dtype, src, dst, compressed


def _locals(shape, dtype, layout, seed):
    rng = np.random.default_rng(seed)
    full = (rng.standard_normal(shape) * 50).astype(dtype)
    if layout.kind == "replicated":
        return full, [full.copy() for _ in range(layout.nranks)]
    if layout.kind == "partial":
        parts = [(rng.standard_normal(shape) * 50).astype(dtype)
                 for _ in range(layout.nranks)]
        return np.sum(parts, axis=0), parts
    return full, [full[s:s + c].copy() for s, c in layout.rows]


def _same_plan(got, want):
    assert [(s.op, s.detail, s.wire_tx, s.wire_rx) for s in got.steps] == \
        [(s.op, s.detail, s.wire_tx, s.wire_rx) for s in want.steps]
    assert got.shape == want.shape and got.itemsize == want.itemsize
    assert got.zero_copy == want.zero_copy
    assert got.describe() == want.describe()
    assert got.expected_collectives() == want.expected_collectives()
    assert got.wire_tx_bytes() == want.wire_tx_bytes()
    assert got.wire_rx_bytes() == want.wire_rx_bytes()


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_case(), st.integers(0, 2 ** 31))
def test_plan_and_simulation_equal_jax(case, seed):
    shape, dtype, src, dst, compressed = case
    got = tr.plan_redistribute(shape, dtype, src, dst, compressed)
    want = jr.plan_redistribute(shape, dtype, _as(jr, src), _as(jr, dst),
                                compressed)
    _same_plan(got, want)
    full, blocks = _locals(shape, dtype, src, seed)
    out = tr.simulate_plan(got, blocks)
    for a, b in zip(out, jr.simulate_plan(want, blocks)):
        np.testing.assert_array_equal(a, b)
    if dst.kind == "replicated":
        for a in out:
            np.testing.assert_array_equal(a, full)
    else:
        for a, (s, c) in zip(out, dst.rows):
            np.testing.assert_array_equal(a, full[s:s + c])
    if src.kind != "partial":
        back = tr.simulate_plan(tr.plan_redistribute(shape, dtype, dst, src),
                                out)
        for a, b in zip(back, blocks):
            np.testing.assert_array_equal(a, b)


@settings(max_examples=100, deadline=None)
@given(_case())
def test_alltoallv_splits_rebuild_the_destination(case):
    shape, dtype, src, dst, _ = case
    if src.kind != "sharded" or dst.kind != "sharded":
        src = tr.Layout.sharded(shape[0], src.nranks)
        dst = tr.rows_layout(list(reversed([c for _, c in src.rows])))
    plan = tr.plan_redistribute(shape, dtype, src, dst)
    _, blocks = _locals(shape, dtype, src, 3)
    want = tr.simulate_plan(plan, blocks)
    if plan.zero_copy:
        return
    pieces = []
    for r, b in enumerate(blocks):
        splits = tr.alltoallv_splits(plan, 0, r, b.shape[0])
        pieces.append(np.split(b, np.cumsum(splits)[:-1]))
    for d in range(dst.nranks):
        got = np.concatenate([pieces[r][d] for r in range(src.nranks)])
        np.testing.assert_array_equal(got, want[d])


def test_planner_rules_and_errors_match_jax():
    for mod in (tr, jr):
        sh, rep = mod.Layout.sharded(ROWS, 4), mod.Layout.replicated(4)
        uneven = mod.Layout.from_rows([(0, 1), (1, 5), (6, 0), (6, 8)])
        ops = [[s.op for s in mod.plan_redistribute(
            (ROWS, 3), np.float32, a, b).steps]
            for a, b in [(sh, sh), (rep, sh), (sh, rep), (sh, uneven),
                         (mod.Layout.partial(4), uneven)]]
        assert ops == [[], ["slice"], ["allgatherv"], ["alltoallv"],
                       ["reducescatter", "alltoallv"]]
        assert mod.even_row_layout(ROWS, 4) == sh
        with pytest.raises(ValueError, match="contiguous"):
            mod.Layout.from_rows([(0, 4), (5, 3)])
        with pytest.raises(ValueError, match="same world"):
            mod.plan_redistribute((8,), np.float32, mod.Layout.sharded(8, 2),
                                  mod.Layout.sharded(8, 4))
        with pytest.raises(ValueError, match="partial"):
            mod.plan_redistribute((ROWS,), np.float32, sh,
                                  mod.Layout.partial(4))


@pytest.mark.parametrize("compressed", [False, True])
def test_ring_byte_helpers_equal_jax(compressed):
    for size in (1, 2, 3, 4, 6, 8):
        for rank in range(size):
            for count in (0, 1, 7, 1000, 4099):
                for itemsize in (2, 4):
                    assert tr.flat_allreduce_wire_bytes(
                        count, itemsize, size, rank, compressed) == \
                        jr.flat_allreduce_wire_bytes(
                            count, itemsize, size, rank, compressed)
                    for local in (1, 2, size):
                        if size % local:
                            continue
                        assert tr.hier_wire_bytes(
                            count, itemsize, size, local, rank,
                            compress_cross=compressed) == jr.hier_wire_bytes(
                            count, itemsize, size, local, rank,
                            compress_cross=compressed)


# ---- the executors on 4 gloo ranks -------------------------------------

PLAN_CASES = [
    # (name, src, dst, dtype)
    ("allgatherv", ("even",), ("replicated",), "float32"),
    ("alltoallv", ("rows", [5, 0, 7, 2]), ("even",), "float32"),
    ("alltoallv.bf16", ("even",), ("rows", [0, 9, 0, 5]), "bfloat16"),
    ("slice", ("replicated",), ("rows", [3, 3, 0, 8]), "int64"),
    ("allreduce", ("partial",), ("replicated",), "float32"),
    ("reducescatter", ("partial",), ("even",), "float32"),
    ("reducescatter+alltoallv", ("partial",), ("rows", [1, 6, 0, 7]),
     "float32"),
    ("zero_copy", ("even",), ("even",), "float32"),
]
HELD = [4, 0, 9, 1]                       # reshard_rows' holdings
MESHES = [
    # (mesh axes, src spec, dst spec)
    ({"data": 4}, ("data",), ()),
    ({"data": 4}, (), ("data",)),
    ({"data": 2, "tensor": 2}, ("data",), (("data", "tensor"),)),
    ({"data": 2, "tensor": 2}, (("tensor", "data"),), ("data",)),
    ({"data": 2, "tensor": 2}, ("tensor",), ()),
]


def _layout_of(desc, n):
    if desc[0] == "even":
        return tr.Layout.sharded(ROWS, n)
    if desc[0] == "rows":
        return tr.rows_layout(desc[1])
    return getattr(tr.Layout, desc[0])(n)


def _np_input(dtype, seed, shape=(ROWS, 3)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 8).round().astype(
        np.float32 if dtype == "bfloat16" else dtype)


def _torch(a, dtype):
    import torch

    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _bits(t):
    import torch

    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy()
    return t.numpy().copy()


def _world(rank, size):
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel.sharding import P

    hvd.init(device="cpu")
    out = {"plans": {}, "meshes": []}
    try:
        for name, sdesc, ddesc, dtype in PLAN_CASES:
            src, dst = _layout_of(sdesc, size), _layout_of(ddesc, size)
            plan = tr.plan_redistribute((ROWS, 3), np.float32, src, dst)
            full = _torch(_np_input(dtype, 1), dtype)
            if src.kind == "replicated":
                local = full
            elif src.kind == "partial":
                local = _torch(_np_input(dtype, 10 + rank), dtype)
            else:
                s, c = src.range_of(rank)
                local = full[s:s + c].clone()
            got = tr.execute_plan(plan, local, name=f"t.{name}")
            out["plans"][name] = {"bits": _bits(got), "dtype": str(got.dtype),
                                  "device": str(got.device),
                                  "same": got is local}
        full = _torch(_np_input("float32", 2), "float32")
        start = sum(HELD[:rank])
        got = tr.reshard_rows(full[start:start + HELD[rank]].clone(), HELD,
                              name="t.reshard_rows")
        out["reshard_rows"] = _bits(got)
        for i, (axes, sspec, dspec) in enumerate(MESHES):
            mesh = mesh_mod.create_mesh(device="cpu", **axes)
            src, dst = (mesh, P(*sspec)), (mesh, P(*dspec))
            full = _torch(_np_input("float32", 3, (8, 2)), "float32")
            local = _block(full, mesh, sspec)
            got = hvd.redistribute(local, src, dst, name=f"t.mesh.{i}")
            out["meshes"].append({
                "bits": _bits(got), "want": _bits(_block(full, mesh, dspec)),
                "same": hvd.redistribute(local, src, src) is local})
        return out
    finally:
        hvd.shutdown()


def _block(full, mesh, spec):
    from horovod_tpu_torch.parallel.sharding import P, leaf_block

    return leaf_block(full, P(*spec), mesh).clone()


@pytest.fixture(scope="module")
def world():
    return run_ranks(_world, N_RANKS, timeout=180)


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_execute_plan_equals_simulate_plan(world, case):
    name, sdesc, ddesc, dtype = case
    src, dst = _layout_of(sdesc, N_RANKS), _layout_of(ddesc, N_RANKS)
    plan = tr.plan_redistribute((ROWS, 3), np.float32, src, dst)
    full = _bits(_torch(_np_input(dtype, 1), dtype))
    if src.kind == "replicated":
        blocks = [full] * N_RANKS
    elif src.kind == "partial":
        # Integer-valued addends: every summation order is exact.
        blocks = [_np_input(dtype, 10 + r) for r in range(N_RANKS)]
    else:
        blocks = [full[s:s + c] for s, c in src.rows]
    want = tr.simulate_plan(plan, blocks)
    for r in range(N_RANKS):
        got = world[r]["plans"][name]
        np.testing.assert_array_equal(got["bits"], want[r],
                                      err_msg=f"{name} rank {r}")
        assert got["device"] == "cpu"
        assert got["dtype"] == ("torch.bfloat16" if dtype == "bfloat16"
                                else f"torch.{dtype}")
        assert got["same"] == plan.zero_copy


def test_reshard_rows_equals_simulate_plan(world):
    full = _np_input("float32", 2)
    src = tr.rows_layout(HELD)
    plan = tr.plan_redistribute(full.shape, full.dtype, src,
                                tr.Layout.sharded(ROWS, N_RANKS))
    want = tr.simulate_plan(plan, [full[s:s + c] for s, c in src.rows])
    assert [s.op for s in plan.steps] == ["alltoallv"]
    for r in range(N_RANKS):
        np.testing.assert_array_equal(world[r]["reshard_rows"], want[r])


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=[f"{a}:{s}->{d}" for a, s, d in MESHES])
def test_redistribute_between_mesh_layouts(world, i):
    for r in range(N_RANKS):
        got = world[r]["meshes"][i]
        np.testing.assert_array_equal(got["bits"], got["want"],
                                      err_msg=f"rank {r}")
        assert got["same"]


def test_layout_from_spec_matches_jax_layout_from_sharding():
    """The row layout of a spec over the port's mesh, as JAX's
    ``layout_from_sharding`` gives it over JAX's (a stand-in mesh with
    the same axis sizes: the function reads ``mesh.shape`` only)."""
    import types

    from horovod_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh
    from horovod_tpu_torch.parallel.sharding import P

    shape = {a: 1 for a in AXIS_ORDER}
    shape.update(data=2, tensor=3)
    mesh = Mesh(shape, 0, "cpu", {}, None)
    for spec in [(), ("data",), ("tensor",), (("data", "tensor"),),
                 (None,)]:
        got = tr.layout_from_spec(mesh, P(*spec), (12, 5))
        sharding = types.SimpleNamespace(
            spec=spec, mesh=types.SimpleNamespace(shape=shape))
        want = jr.layout_from_sharding(sharding, (12, 5))
        assert (got.kind, got.nranks, got.rows) == \
            (want.kind, want.nranks, want.rows)
    with pytest.raises(ValueError, match="later axis"):
        tr.layout_from_spec(mesh, P(None, "data"), (12, 4))


def test_reshard_smoke_runs_on_gloo():
    """``python -m horovod_tpu_torch.torch.reshard_smoke --cpu``: four
    gloo ranks as two slices, exit 0 with every rank's OK line."""
    import subprocess
    import sys

    from tests.test_torch_mp import REPO_ROOT

    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.torch.reshard_smoke",
         "--cpu"], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert out.stdout.splitlines()[0] == "reshard_smoke: 4 ranks on gloo (CPU)"
    assert out.stdout.count("RESHARD_SMOKE_OK") == 4
    assert "('4->3', True)" in out.stdout and "('3->4', True)" in out.stdout
