"""hvdlint on the port (``horovod_tpu_torch/analysis``): the seeded-bug
fixtures of ``tests/single/test_analysis_lint.py``, each with a torch
counterpart that must fire the same check ids as the JAX package's lint
on its own fixture, in the same test.

Each port fixture runs once for every rank of a ``fake``
``torch.distributed`` world (``data=2 x pipe=2``, one CPU process), so a
divergence shows when the rank or the rank's inputs take a different
path: a data-dependent branch is given different data on the ranks
(``args(mesh)``), a rank-dependent one the same. C4 has no counterpart:
eager PyTorch donates no buffers.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax import lax

from horovod_tpu import analysis as jlint
from horovod_tpu_torch import analysis
from horovod_tpu_torch.analysis.pytest_plugin import (  # noqa: F401
    hvdlint,
)
from horovod_tpu_torch.parallel import ops

_ENV = [("data", 2), ("pipe", 2)]


@pytest.fixture(autouse=True)
def _no_world():
    """The lint joins a fake world of its own; a size-1 world an earlier
    test of this process left behind is closed first. The programs are
    tiny: torch runs them on one thread (the suite's workers share the
    cores), restored after."""
    if dist.is_initialized() and dist.get_world_size() == 1:
        dist.destroy_process_group()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
    assert not dist.is_initialized()


def _ids(diags):
    return [d.id for d in diags]


def _data(mesh):
    return mesh.axis_group("data")


# ---- the fake backend the recorder stands on ---------------------------------

def test_fake_backend_holds_a_world_in_one_process():
    """torch's ``fake`` backend (an internal module, pinned here): one
    process joins a world of 8 as rank 3, and ``new_group`` of 4 ranks
    works; its collectives write nothing (the recorder fills them)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=3, world_size=8, store=FakeStore())
    try:
        g = dist.new_group([0, 1, 2, 3])
        assert dist.get_world_size() == 8 and dist.get_rank() == 3
        assert dist.get_process_group_ranks(g) == [0, 1, 2, 3]
        assert dist.get_rank(g) == 3
        x = torch.ones(4)
        dist.all_reduce(x, group=g)
        assert torch.equal(x, torch.ones(4))
    finally:
        dist.destroy_process_group()


def test_recorder_fills_fake_outputs_as_if_every_rank_held_this_ones():
    from horovod_tpu_torch.analysis.extract import fake_world, record

    def prog(mesh, x):
        s = ops.psum(x, _data(mesh))
        r = ops.reduce_scatter(x, _data(mesh))
        g = ops.all_gather(x, _data(mesh))
        return s, r, g

    x = torch.arange(4.0)
    with fake_world(_ENV, 1) as mesh:
        colls, _, (s, r, g) = record(prog, (mesh, x), mesh=mesh)
    assert torch.equal(s, 2 * x)
    assert torch.equal(r, 2 * x[2:])        # rank 1's block of the sum
    assert torch.equal(g, torch.cat([x, x]))
    assert [(c.prim, c.axes, c.nelems, c.shape, c.dtype) for c in colls] == [
        ("psum", ("data",), 4, (4,), "float32"),
        ("psum_scatter", ("data",), 4, (4,), "float32"),
        ("all_gather", ("data",), 4, (4,), "float32")]


class _Queued:
    """A request the stand-in lane took: done at once, with ``result``."""
    cuda_event = None

    def __init__(self, result):
        self.result = result

    def wait(self):
        return self.result


class _Lane:
    """The lane's enqueue side, for rank 0 of a 2-rank set: what
    ``torch/mpi_ops.py`` calls between the caller and the lane thread."""
    rank = 0

    def members_of(self, process_set_id):
        return [0, 1]

    def next_group_id(self):
        return 0

    def enqueue(self, req, inp=None, out=None):
        return _Queued(inp if out is None else out)

    def enqueue_many(self, items):
        return [_Queued(torch.cat([inp, inp])) for _, inp, _ in items]


def test_eager_lane_requests_are_recorded_where_they_are_enqueued(
        monkeypatch):
    """The eager lane runs its collectives on its own thread, out of the
    recorder's sight: they are recorded as the caller enqueues them
    (``torch/mpi_ops.py OBSERVERS``), over the process set's ranks, with
    the caller's line as their source; the observer is gone after."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.analysis.extract import record
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.torch import mpi_ops

    monkeypatch.setattr(basics, "lane", _Lane)

    def prog(x):
        s = hvd.allreduce_async(x, op=hvd.Max).synchronize()
        return s, hvd.allgather(x), hvd.broadcast(x, 0)

    colls, _, (_, g, _) = record(prog, (torch.ones(3),))
    assert [(c.prim, c.ranks, c.nelems, c.reduce_op,
             c.source.rpartition("/")[2].partition(":")[0])
            for c in colls] == [
        ("pmax", (0, 1), 3, "max", "test_torch_analysis_lint.py"),
        ("all_gather", (0, 1), 3, "", "test_torch_analysis_lint.py"),
        ("psum", (0, 1), 3, "sum", "test_torch_analysis_lint.py")]
    assert g.shape == (6,) and mpi_ops.OBSERVERS == []


# ---- C1 ------------------------------------------------------------------------

def test_c1_cond_branches_with_divergent_collectives():
    def jprog(x):
        return lax.cond(x.sum() > 0,
                        lambda y: lax.psum(y, "data"),
                        lambda y: y * 2.0, x)

    assert _ids(jlint.lint(jprog, (jnp.ones(4),), axis_env=_ENV)) == ["C1"]

    def prog(mesh, x):
        if x.sum() > 0:
            return ops.psum(x, _data(mesh))
        return x * 2.0

    def args(mesh):    # the data differs by rank: data coordinate 1 < 0
        sign = 1.0 if mesh.axis_index("data") == 0 else -1.0
        return (mesh, torch.full((4,), sign))

    diags = analysis.lint(prog, args, axis_env=_ENV)
    assert _ids(diags) == ["C1"]
    assert diags[0].severity == analysis.ERROR
    assert "test_torch_analysis_lint" in diags[0].source
    assert "inputs differ" in diags[0].message


def test_c1_rank_dependent_switch_is_called_out():
    def jprog(x):
        return lax.switch(lax.axis_index("data") % 2,
                          [lambda y: lax.psum(y, "data"),
                           lambda y: y], x)

    [jd] = jlint.lint(jprog, (jnp.ones(4),), axis_env=_ENV)
    assert jd.id == "C1" and "axis_index" in jd.message

    def prog(mesh, x):
        if mesh.axis_index("data") % 2 == 0:
            return ops.psum(x, _data(mesh))
        return x

    diags = analysis.lint(prog, lambda mesh: (mesh, torch.ones(4)),
                          axis_env=_ENV)
    assert _ids(diags) == ["C1"]


def test_c1_same_inputs_blames_the_rank():
    """With the same inputs on every rank (a tuple ``args``), a
    divergence can only come from the rank: the message says so."""
    def prog(x):
        if dist.get_rank() % 2 == 0:
            dist.all_reduce(x)
        return x

    diags = analysis.lint(prog, (torch.ones(4),), axis_env=_ENV)
    assert _ids(diags) == ["C1"]
    assert "axis_index" in diags[0].message


def test_c1_taint_survives_scan_outputs():
    def jprog(x):
        def step(c, _):
            return c + lax.axis_index("data"), None
        acc, _ = lax.scan(step, jnp.int32(0), jnp.arange(3))
        return lax.switch(acc % 2,
                          [lambda y: lax.psum(y, "data"),
                           lambda y: y], x)

    assert _ids(jlint.lint(jprog, (jnp.ones(4),), axis_env=_ENV)) == ["C1"]

    def prog(mesh, x):
        acc = 0
        for _ in range(3):
            acc += mesh.axis_index("data")
        if acc % 2 == 0:
            return ops.psum(x, _data(mesh))
        return x

    diags = analysis.lint(prog, lambda mesh: (mesh, torch.ones(4)),
                          axis_env=_ENV)
    assert _ids(diags) == ["C1"]


def test_c1_unmatched_point_to_point():
    """A send with no receive on the peer (rank 0 of each pipe pair
    sends twice, its peer receives once) is a C1."""
    def prog(mesh, x):
        g = mesh.axis_group("pipe")
        peer = dist.get_process_group_ranks(g)[1 - mesh.axis_index("pipe")]
        n = 2 if mesh.axis_index("pipe") == 0 else 1
        for _ in range(n):
            op = dist.isend if mesh.axis_index("pipe") == 0 else dist.irecv
            for w in dist.batch_isend_irecv([dist.P2POp(op, x, peer, g)]):
                w.wait()
            x = x + 1
        return x

    diags = analysis.lint(prog, lambda mesh: (mesh, torch.ones(4)),
                          axis_env=_ENV)
    assert _ids(diags) == ["C1"]
    assert "receive" in diags[0].message


# ---- C2 ------------------------------------------------------------------------

def test_c2_psum_over_undeclared_axis():
    """The JAX test of this fixture is red at jax 0.9 (its ``source`` is
    empty); the port is held to that test's whole expectation, the real
    source included."""
    def jprog(x):
        return lax.psum(x, "rank")  # not a mesh axis

    assert _ids(jlint.lint(jprog, (jnp.ones(4),), axis_env=_ENV)) == ["C2"]

    def prog(group, x):
        dist.all_reduce(x, group=group)   # a group no mesh axis spans
        return x

    def args(mesh):
        odd = [dist.new_group([0, 3]), dist.new_group([1, 2])]
        return (odd[mesh.rank in (1, 2)], torch.ones(4))

    diags = analysis.lint(prog, args, axis_env=_ENV)
    assert _ids(diags) == ["C2"]
    assert "rank" in diags[0].message
    assert "test_torch_analysis_lint" in diags[0].source


def test_c2_fires_with_no_declared_axes_at_all():
    d = jlint.lint(lambda x: lax.psum(x, "typo_axis"), (jnp.ones(4),))
    assert _ids(d) == ["C2"]
    assert jlint.lint(lambda x: x * 2.0, (jnp.ones(4),)) == []

    def prog(x):
        dist.all_reduce(x)
        return x

    assert _ids(analysis.lint(prog, (torch.ones(4),))) == ["C2"]
    assert analysis.lint(lambda x: x * 2.0, (torch.ones(4),)) == []


def test_c2_group_of_the_wrong_size():
    """A group named by a declared axis but of another size than the
    axis declares (a mesh built for other sizes) is a C2."""
    def prog(mesh, x):
        return ops.psum(x, _data(mesh))

    diags = analysis.lint(prog, lambda mesh: (mesh, torch.ones(4)),
                          axis_env=[("data", 4)], ranks=(0,))
    assert diags == []
    from horovod_tpu_torch.analysis import checks

    ex = analysis.extract(prog, lambda mesh: (mesh, torch.ones(4)),
                          axis_env=[("data", 4)], ranks=(0,))
    got = checks.check_axis_validity(
        ex, {"mesh_axes": ["data"], "axis_sizes": {"data": 8}})
    assert _ids(got) == ["C2"] and "declares 8" in got[0].message


# ---- C3 ------------------------------------------------------------------------

def test_c3_fp32_allreduce_of_bf16():
    def jprog(x):
        return lax.psum(x.astype(jnp.float32), "data")

    assert _ids(jlint.lint(jprog, (jnp.ones(64, jnp.bfloat16),),
                           axis_env=_ENV)) == ["C3"]

    def prog(mesh, x):
        return ops.psum(x.float(), _data(mesh))   # stays f32

    diags = analysis.lint(
        prog, lambda mesh: (mesh, torch.ones(64, dtype=torch.bfloat16)),
        axis_env=_ENV)
    assert _ids(diags) == ["C3"]
    assert diags[0].severity == analysis.WARNING
    assert "bfloat16" in diags[0].message


def test_c3_exempts_f32_accumulate_roundtrip():
    def jprog(x):
        return lax.psum(x.astype(jnp.float32), "data").astype(jnp.bfloat16)

    assert jlint.lint(jprog, (jnp.ones(64, jnp.bfloat16),),
                      axis_env=_ENV) == []

    def prog(mesh, x):
        return ops.psum(x.float(), _data(mesh)).to(torch.bfloat16)

    def scatter(mesh, x):
        return ops.reduce_scatter(x.float(), _data(mesh)).to(torch.bfloat16)

    def args(mesh):
        return (mesh, torch.ones(64, dtype=torch.bfloat16))

    assert analysis.lint(prog, args, axis_env=_ENV) == []
    # The scatter's round trip is exempt as well (its C6: no gather).
    assert _ids(analysis.lint(scatter, args, axis_env=_ENV)) == ["C6"]


def test_c3_reshape_before_the_cast_back_is_a_use():
    """As JAX's walker reads a reduction's direct users, a reshape of the
    f32 result is a use at f32 (C3), and a reshape of the upcast operand
    hides the upcast (quiet, as a reshape producer is in JAX)."""
    def jused(x):
        return lax.psum(x.astype(jnp.float32), "data").reshape(8, 8) \
            .astype(jnp.bfloat16)

    assert _ids(jlint.lint(jused, (jnp.ones(64, jnp.bfloat16),),
                           axis_env=_ENV)) == ["C3"]

    def used(mesh, x):
        return ops.psum(x.float(), _data(mesh)).reshape(8, 8).to(
            torch.bfloat16)

    def hidden(mesh, x):
        return ops.psum(x.float().reshape(8, 8), _data(mesh))

    def args(mesh):
        return (mesh, torch.ones(64, dtype=torch.bfloat16))

    assert _ids(analysis.lint(used, args, axis_env=_ENV)) == ["C3"]
    assert analysis.lint(hidden, args, axis_env=_ENV) == []


# ---- C5 ------------------------------------------------------------------------

def test_c5_schedule_sequence_mismatch():
    def jprog(x):
        def step(c, _):
            return lax.ppermute(c, "pipe", [(0, 1), (1, 0)]), None
        c, _ = lax.scan(step, x, jnp.arange(4))  # 4 hops...
        return lax.psum(c, "pipe")

    expect = [("ppermute", ("pipe",))] * 3 + [("psum", ("pipe",))]
    assert _ids(jlint.lint(jprog, (jnp.ones(4),), axis_env=[("pipe", 2)],
                           expect_collectives=expect)) == ["C5"]

    def prog(mesh, x):
        g = mesh.axis_group("pipe")
        for _ in range(4):                       # 4 hops...
            (x,) = ops.ppermute_ring((x,), g)
        return ops.psum(x, g)

    diags = analysis.lint(prog, lambda mesh: (mesh, torch.ones(4)),
                          axis_env=[("pipe", 2)], expect_collectives=expect)
    assert _ids(diags) == ["C5"]
    assert "deviates" in diags[0].message
    assert analysis.lint(prog, lambda mesh: (mesh, torch.ones(4)),
                         axis_env=[("pipe", 2)], expect_collectives=[
                             ("ppermute", ("pipe",))] * 4 + [
                             ("psum", ("pipe",))]) == []


# ---- C6 ------------------------------------------------------------------------

def test_c6_unpaired_reduce_scatter():
    def jprog(x):
        return lax.psum_scatter(x, "data", scatter_dimension=0, tiled=True)

    assert _ids(jlint.lint(jprog, (jnp.ones(8),), axis_env=_ENV)) == ["C6"]

    def prog(mesh, x):
        return ops.reduce_scatter(x, _data(mesh))

    diags = analysis.lint(prog, lambda mesh: (mesh, torch.ones(8)),
                          axis_env=_ENV)
    assert _ids(diags) == ["C6"]
    assert diags[0].severity == analysis.ERROR
    assert "unpaired" in diags[0].message


def test_c6_clean_when_scatter_pairs_with_gather():
    def jpaired(x):
        s = lax.psum_scatter(x, "data", scatter_dimension=0, tiled=True)
        return lax.all_gather(s - 0.1 * s, "data", axis=0, tiled=True)

    def jcross(x):
        s = lax.psum_scatter(x, "data", scatter_dimension=0, tiled=True)
        return lax.all_gather(s, "pipe", axis=0, tiled=True)

    assert jlint.lint(jpaired, (jnp.ones(8),), axis_env=_ENV) == []
    assert _ids(jlint.lint(jcross, (jnp.ones(8),), axis_env=_ENV)) == ["C6"]

    def paired(mesh, x):
        s = ops.reduce_scatter(x, _data(mesh))
        return ops.all_gather(s - 0.1 * s, _data(mesh))

    def cross_axis(mesh, x):
        s = ops.reduce_scatter(x, _data(mesh))
        return ops.all_gather(s, mesh.axis_group("pipe"))

    def args(mesh):
        return (mesh, torch.ones(8))

    assert analysis.lint(paired, args, axis_env=_ENV) == []
    assert _ids(analysis.lint(cross_axis, args, axis_env=_ENV)) == ["C6"]


def test_c6_gather_before_scatter_does_not_mask():
    def jprog(x):
        g = lax.all_gather(x, "data", axis=0, tiled=True)
        return lax.psum_scatter(g, "data", scatter_dimension=0, tiled=True)

    assert _ids(jlint.lint(jprog, (jnp.ones(8),), axis_env=_ENV)) == ["C6"]

    def prog(mesh, x):
        g = ops.all_gather(x, _data(mesh))
        return ops.reduce_scatter(g, _data(mesh))

    diags = analysis.lint(prog, lambda mesh: (mesh, torch.ones(8)),
                          axis_env=_ENV)
    assert _ids(diags) == ["C6"]
    assert "unpaired" in diags[0].message


def test_c6_counts_through_loops():
    def jprog(x):
        def step(c, _):
            return lax.psum_scatter(c, "data", scatter_dimension=0,
                                    tiled=True).repeat(2), None
        c, _ = lax.scan(step, x, jnp.arange(3))
        return lax.all_gather(c[:4], "data", axis=0, tiled=True)

    assert _ids(jlint.lint(jprog, (jnp.ones(8),), axis_env=_ENV)) == ["C6"]

    def prog(mesh, x):
        for _ in range(3):
            x = ops.reduce_scatter(x, _data(mesh)).repeat(2)
        return ops.all_gather(x[:4], _data(mesh))

    diags = analysis.lint(prog, lambda mesh: (mesh, torch.ones(8)),
                          axis_env=_ENV)
    assert _ids(diags) == ["C6"]
    assert "3 reduce-scatter(s)" in diags[0].message
    assert "only 1 subsequent allgather(s)" in diags[0].message


# ---- C7 ------------------------------------------------------------------------

def _jbunched(x, w):
    a = x @ w
    b = jnp.tanh(a) @ w
    s1 = lax.psum_scatter(a.reshape(-1), "data", scatter_dimension=0,
                          tiled=True)
    s2 = lax.psum_scatter(b.reshape(-1), "data", scatter_dimension=0,
                          tiled=True)
    return (lax.all_gather(s1, "data", axis=0, tiled=True),
            lax.all_gather(s2, "data", axis=0, tiled=True))


def _bunched(mesh, x, w):
    """Backward-shaped fixture: ALL the arithmetic, then every bucket's
    reduce-scatter bunched at the tail."""
    g = _data(mesh)
    a = x @ w
    b = torch.tanh(a) @ w
    s1 = ops.reduce_scatter(a.reshape(-1), g)
    s2 = ops.reduce_scatter(b.reshape(-1), g)
    return ops.all_gather(s1, g), ops.all_gather(s2, g)


def _xw(mesh, n=8):
    return (mesh, torch.ones((n, n)), torch.ones((n, n)))


def test_c7_tail_bunched_scatters_fire():
    x, w = jnp.ones((8, 8)), jnp.ones((8, 8))
    assert _ids(jlint.lint(_jbunched, (x, w), axis_env=_ENV)) == ["C7"]
    diags = analysis.lint(_bunched, _xw, axis_env=_ENV)
    assert _ids(diags) == ["C7"]
    assert diags[0].severity == analysis.ERROR
    assert "bunched" in diags[0].message
    assert "HOROVOD_JIT_FUSION" in diags[0].hint


def test_c7_quiet_on_interleaved_schedule():
    def jinterleaved(x, w):
        a = x @ w
        s1 = lax.psum_scatter(a.reshape(-1), "data", scatter_dimension=0,
                              tiled=True)
        b = jnp.tanh(a) @ w
        s2 = lax.psum_scatter(b.reshape(-1), "data", scatter_dimension=0,
                              tiled=True)
        return (lax.all_gather(s1, "data", axis=0, tiled=True),
                lax.all_gather(s2, "data", axis=0, tiled=True))

    x, w = jnp.ones((8, 8)), jnp.ones((8, 8))
    assert jlint.lint(jinterleaved, (x, w), axis_env=_ENV) == []

    def interleaved(mesh, x, w):
        g = _data(mesh)
        a = x @ w
        s1 = ops.reduce_scatter(a.reshape(-1), g)
        b = torch.tanh(a) @ w
        s2 = ops.reduce_scatter(b.reshape(-1), g)
        return ops.all_gather(s1, g), ops.all_gather(s2, g)

    assert analysis.lint(interleaved, _xw, axis_env=_ENV) == []


def test_c7_quiet_on_the_backward_hooks_schedule():
    """The port's counterpart of JAX's reorder pass: the same two
    matmuls' gradients, each bucket's reduce-scatter started from the
    backward's hook the moment the bucket is complete
    (``parallel.fusion.value_and_grad_bucketed``), lints clean, while
    the same step scattering after the whole backward fires C7 (JAX:
    ``interleave_collectives`` flips the bunched fixture's verdict)."""
    from horovod_tpu.parallel.fusion import (
        _jcore,
        interleave_collectives,
    )
    from horovod_tpu_torch.parallel import fusion
    from horovod_tpu_torch.parallel.zero import zero_bucket_layout

    x, w = jnp.ones((16, 16)), jnp.ones((16, 16))
    closed = jax.make_jaxpr(_jbunched, axis_env=[("data", 2)])(x, w)
    fixed = _jcore.jaxpr_as_fun(interleave_collectives(closed))
    assert jlint.lint(fixed, (x, w), axis_env=_ENV) == []

    def loss(p, b):
        return (torch.tanh(b @ p["w1"]) @ p["w2"]).sum()

    def args(mesh):
        return (mesh, {"w1": torch.ones((16, 16)), "w2": torch.ones((16, 16))},
                torch.ones((16, 16)))

    def step(mesh, params, b, hooks):
        g = _data(mesh)
        layout = zero_bucket_layout([params["w1"], params["w2"]], 2, 1024)
        shards = {}

        def on_ready(i, leaves):
            shards[i] = ops.reduce_scatter(layout.pack_bucket(leaves, i), g)

        if hooks:
            fusion.value_and_grad_bucketed(loss, params, b, 1, layout,
                                           on_ready)
        else:
            from horovod_tpu_torch.parallel.train_step import (
                _value_and_grad,
            )

            _, grads = _value_and_grad(loss, params, b, 1)
            leaves = [grads["w1"], grads["w2"]]
            for i in range(len(layout.buckets)):
                on_ready(i, leaves)
        return [ops.all_gather(shards[i], g) for i in sorted(shards)]

    assert analysis.lint(lambda m, p, b: step(m, p, b, True), args,
                         axis_env=_ENV) == []
    assert _ids(analysis.lint(lambda m, p, b: step(m, p, b, False), args,
                              axis_env=_ENV)) == ["C7"]


def test_c7_quiet_on_eager_lane_and_single_bucket():
    def eager_shaped(mesh, x, w):
        return torch.tanh(x @ w) @ w

    def single(mesh, x, w):
        a = torch.tanh(x @ w) @ w
        s = ops.reduce_scatter(a.reshape(-1), _data(mesh))
        return ops.all_gather(s, _data(mesh))

    def pure_wire(mesh, x, w):
        g = _data(mesh)
        x = x.reshape(-1)
        s1 = ops.reduce_scatter(x, g)
        g1 = ops.all_gather(s1, g)
        s2 = ops.reduce_scatter(g1, g)
        return ops.all_gather(s2, g)

    for fn in (eager_shaped, single, pure_wire):
        assert analysis.lint(fn, _xw, axis_env=_ENV) == [], fn.__name__


# ---- C8 ------------------------------------------------------------------------

def test_c8_collective_in_rank_dependent_while_fires():
    def jprog(x):
        def cond(c):
            i, _ = c
            return i < lax.axis_index("data") + 1

        def body(c):
            i, y = c
            return i + 1, lax.psum(y, "data")

        _, out = lax.while_loop(cond, body, (jnp.int32(0), x))
        return out

    assert _ids(jlint.lint(jprog, (jnp.ones(4),), axis_env=_ENV)) == ["C8"]

    def prog(mesh, x):
        i = 0
        while i < mesh.axis_index("data") + 1:
            x = ops.psum(x, _data(mesh))
            i += 1
        return x

    diags = analysis.lint(prog, lambda mesh: (mesh, torch.ones(4)),
                          axis_env=_ENV)
    assert _ids(diags) == ["C8"]
    assert diags[0].severity == analysis.ERROR
    assert "axis_index" in diags[0].message
    assert "psum" in diags[0].message


def test_c8_taint_reaches_trip_count_through_carry():
    def jprog(x):
        n = lax.axis_index("data") + 1
        return lax.fori_loop(0, n, lambda _, y: lax.psum(y, "data"), x)

    assert _ids(jlint.lint(jprog, (jnp.ones(4),), axis_env=_ENV)) == ["C8"]

    def prog(mesh, x):
        n = torch.tensor(mesh.axis_index("data")) + 1   # a tensor bound
        for _ in range(int(n)):
            x = ops.psum(x, _data(mesh))
        return x

    diags = analysis.lint(prog, lambda mesh: (mesh, torch.ones(4)),
                          axis_env=_ENV)
    assert _ids(diags) == ["C8"]


def test_c8_quiet_fixtures():
    def static_while(mesh, x):
        i = 0
        while i < 3:
            x = ops.psum(x, _data(mesh))
            i += 1
        return x

    def tainted_no_collective(mesh, x):
        for _ in range(mesh.axis_index("data") + 1):
            x = x * 2.0
        return x

    def two_collective_body(mesh, x):
        for _ in range(3):
            x = ops.psum(x, _data(mesh))
            x = ops.psum(x, mesh.axis_group("pipe"))
        return x

    for fn in (static_while, tainted_no_collective, two_collective_body):
        assert analysis.lint(fn, lambda mesh: (mesh, torch.ones(4)),
                             axis_env=_ENV) == [], fn.__name__


def test_c8_repeated_block_of_two_collectives():
    """A loop body of two collectives, run a rank-dependent number of
    times, is a repeat count (C8), not a different sequence (C1)."""
    def prog(mesh, x):
        for _ in range(mesh.axis_index("data") + 1):
            x = ops.psum(x, mesh.group)
            x = ops.psum(x.reshape(2, 2), mesh.group).reshape(-1)
        return x

    diags = analysis.lint(prog, lambda mesh: (mesh, torch.ones(4)),
                          axis_env=_ENV)
    assert _ids(diags) == ["C8"]


# ---- the allowlist, the fixture, the surface --------------------------------

def test_allowlist_suppresses_by_id_and_path():
    def prog(mesh, x):
        return ops.psum(x.float(), _data(mesh))

    def args(mesh):
        return (mesh, torch.ones(8, dtype=torch.bfloat16))

    assert analysis.lint(prog, args, axis_env=_ENV, allow=("C3",)) == []
    [d] = analysis.lint(prog, args, axis_env=_ENV)
    assert analysis.lint(prog, args, axis_env=_ENV,
                         allow=(f"C3:{d.path}",)) == []


def test_hvdlint_fixture_returns_warnings_and_fails_on_errors(hvdlint):
    def warn(mesh, x):
        return ops.psum(x.float(), _data(mesh))

    diags = hvdlint(warn, lambda mesh: (mesh, torch.ones(
        8, dtype=torch.bfloat16)), axis_env=_ENV)
    assert _ids(diags) == ["C3"]
    with pytest.raises(pytest.fail.Exception, match="C6"):
        hvdlint(lambda mesh, x: ops.reduce_scatter(x, _data(mesh)),
                lambda mesh: (mesh, torch.ones(8)), axis_env=_ENV)


def test_severities_and_names_against_the_jax_package():
    """The same ids at the same severities, C4 (donation) left out:
    eager PyTorch donates no buffers. A lint outside a world it cannot
    replace refuses rather than guessing."""
    from horovod_tpu.analysis.diagnostics import SEVERITIES as JAX_SEV

    assert analysis.SEVERITIES == {k: v for k, v in JAX_SEV.items()
                                   if k != "C4"}
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process of its own|"
                                               "a process that has not"):
            analysis.lint(lambda x: x, (torch.ones(1),))
    finally:
        dist.destroy_process_group()
