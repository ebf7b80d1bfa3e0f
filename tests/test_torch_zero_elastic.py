"""ZeRO carries under ``hvd.elastic.TreeState`` across re-formations, on
gloo ranks.

A ZeRO carry holds only its own rank's block of the optimizer state.
The split step's (``make_split_train_step(zero=ZeroConfig())``, the
world's size) and the eager lane's (``DistributedFusedAdam(zero=True)``)
carries:

- **A reset that loses no rank** (2 ranks; an injected
  ``HorovodInternalError`` after a commit, the state restored and the
  world re-initialized in place at the next epoch): the run equals one
  that never reset, bit for bit (losses, params, every block). Before
  the port re-laid blocks out, ``sync`` handed every rank rank 0's
  block, and this failed.
- **Shrink and grow** (3 -> 2 -> 3): a voluntary ``shrink([2],
  state=)`` hands the victim's rows over before it leaves; the victim
  knocks at the parole door, the survivors' commit lets it in, and
  ``sync`` re-lays the blocks out over 3. After each move every rank's
  blocks equal the gathered state re-sliced for the new world
  (``models/convert.py resize_zero_states``, through the leaves, here on
  the host), and the next steps' losses and state equal those of a run
  started at the new size from that state.
- **Lost rows**: a shrink without ``state=`` takes the victim's rows
  with it. With ``checkpoint_dir`` (every rank writes its block of each
  commit) ``sync`` reads them back and the blocks equal the re-sliced
  commit; without it ``sync`` raises ``HorovodStateLostError`` naming
  the lost rows, and ``hvd.elastic.run`` does not retry it. A cold
  restart at one rank from the three ranks' commit (``resume`` takes
  rank 0's block file, ``sync`` the others') holds the re-sliced commit.
- Under a mesh, a re-formation raises ``HorovodReformationError``: the
  mesh's axes are fixed (ROADMAP.md, "Not queued").
"""

import os
import tempfile
import threading

import numpy as np
import pytest

from tests.test_torch_mp import free_port, run_ranks

LR = 1e-2
BUCKET = 96            # bytes: several buckets, padded differently at 2/3
ROWS = 12              # batch rows: an equal share at 2 and 3 ranks


def _problem():
    rng = np.random.default_rng(11)
    params = {"w1": (rng.standard_normal((8, 16)) * 0.3).astype(np.float32),
              "b1": (rng.standard_normal(13) * 0.1).astype(np.float32),
              "w2": (rng.standard_normal((16, 4)) * 0.3).astype(np.float32)}
    batch = {"x": rng.standard_normal((ROWS, 8)).astype(np.float32),
             "y": rng.standard_normal((ROWS, 4)).astype(np.float32)}
    return params, batch


def _loss(p, d):
    import torch

    h = torch.tanh(d["x"] @ p["w1"] + p["b1"][:16].sum())
    return torch.mean((h @ p["w2"] - d["y"]) ** 2)


def _local(batch, step):
    """This rank's rows of the step's batch (the batch rolled a row a
    step, so that steps differ)."""
    import torch

    from horovod_tpu_torch.common import basics

    rank, size = basics.rank(), basics.size()
    n = ROWS // size
    return {k: torch.from_numpy(np.roll(v, step, 0)[rank * n:(rank + 1) * n]
                                .copy()) for k, v in batch.items()}


def _params():
    import torch

    return {k: torch.from_numpy(v.copy()) for k, v in _problem()[0].items()}


class _Lanes:
    """The two ZeRO lanes over one TreeState: the split step with
    ``fused_master_adam`` (master, mu, nu blocks) and the eager lane's
    ``DistributedFusedAdam(zero=True)`` (mu, nu)."""

    def __init__(self, lanes=("split", "eager")):
        import torch

        import horovod_tpu_torch.torch as hvd
        from horovod_tpu_torch.parallel import precision, train_step
        from horovod_tpu_torch.parallel.zero import ZeroConfig

        self.lanes = lanes
        self.ts = train_step.make_split_train_step(
            _loss, precision.fused_master_adam(
                LR, compute_dtype=torch.float32),
            zero=ZeroConfig(bucket_bytes=BUCKET))
        self.opt = hvd.DistributedFusedAdam(LR, zero=True,
                                            bucket_bytes=BUCKET)

    def init(self):
        trees = {}
        if "split" in self.lanes:
            trees["split"] = self.ts.init(_params())
        if "eager" in self.lanes:
            p = _params()
            trees["eager"] = (p, self.opt.init(p))
        return trees

    def step(self, state, step):
        import torch

        _, batch = _problem()
        losses = {}
        if "split" in self.lanes:
            loss, state.split = self.ts.step(state.split, _local(batch, step))
            losses["split"] = float(loss)
        if "eager" in self.lanes:
            p, s = state.eager
            grads = {k: v.detach().clone().requires_grad_(True)
                     for k, v in p.items()}
            loss = _loss(grads, _local(batch, step))
            loss.backward()
            with torch.no_grad():
                p, s = self.opt.apply(p, {k: v.grad for k, v in
                                          grads.items()}, s)
            state.eager = (p, s)
            losses["eager"] = float(loss.detach())
        return losses


def _host(tree):
    """A tree's tensors as numpy (the ZeRO layout records dropped)."""
    import torch

    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items() if k != "zero_layout"}
    if isinstance(tree, (tuple, list)):
        return [_host(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy().copy()
    return tree


def _snapshot(state):
    out = {}
    if hasattr(state, "split"):
        params, opt = state.split
        out["split"] = {"params": _host(params),
                        **{f: _host(getattr(opt, f)) for f in opt._fields}}
    if hasattr(state, "eager"):
        params, s = state.eager
        out["eager"] = {"params": _host(params), **_host(s)}
    return out


# ---- the fault: a reset that loses no rank -----------------------------

RESET_STEPS = 5
FAULT_STEP = 3          # after step 1's commit: steps 2-3 replayed


def _train(fault):
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    lanes = _Lanes()
    state = hvd.elastic.TreeState(step=0, losses=[], **lanes.init())
    fired = []

    def mean(losses):
        # The ranks' mean: the same history on every rank (the history
        # is state, taken from rank 0 by sync).
        return {k: float(hvd.allreduce(torch.tensor(v), name=f"t.loss.{k}"))
                for k, v in sorted(losses.items())}

    @hvd.elastic.run
    def train(state):
        while state.step < RESET_STEPS:
            state.losses = state.losses + [mean(lanes.step(state,
                                                           state.step))]
            state.step += 1
            if state.step == 2:
                state.commit()
            if fault and state.step == FAULT_STEP + 1 and not fired:
                fired.append(1)
                raise hvd.HorovodInternalError("injected after a commit")

    train(state)
    return {"losses": state.losses, "state": _snapshot(state),
            "epoch": basics.epoch(), "fired": bool(fired)}


def _reset_world(rank, size):
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    try:
        return {"reset": _train(True), "plain": _train(False)}
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def worlds():
    """The three worlds of this file, started together."""
    with tempfile.TemporaryDirectory() as ckpt:
        env = {"HOROVOD_REJOIN_PORT": str(free_port()),
               "ZERO_ELASTIC_CKPT": ckpt}
        jobs = {"reset": (_reset_world, 2, None),
                "elastic": (_elastic_world, 3, env),
                "mesh": (_mesh_world, 2, None)}
        out, errors = {}, []

        def one(key, fn, size, env):
            try:
                out[key] = run_ranks(fn, size, timeout=240, env=env)
            except BaseException as e:  # noqa: BLE001: re-raised below
                errors.append(e)

        threads = [threading.Thread(target=one, args=(k, *job))
                   for k, job in jobs.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


@pytest.fixture(scope="module")
def reset_world(worlds):
    return worlds["reset"]


def _same(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8),
                                      err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("lane", ["split", "eager"])
def test_reset_without_loss_equals_a_run_that_never_reset(reset_world, lane):
    for r, out in enumerate(reset_world):
        got, want = out["reset"], out["plain"]
        assert got["fired"] and got["epoch"] == 1
        assert [x[lane] for x in got["losses"]] == \
            [x[lane] for x in want["losses"]], f"rank {r}"
        _same(got["state"][lane], want["state"][lane], f"rank {r} {lane}")
    # Every rank holds its own block: the blocks differ across ranks.
    a, b = (o["reset"]["state"][lane]["mu"] for o in reset_world)
    assert any(x.shape != y.shape or not np.array_equal(x, y)
               for x, y in zip(a, b))


# ---- shrink, grow and lost rows (3 -> 2 -> 3 -> 2 -> 1) -----------------

def _gather_blocks(state, name):
    """Every rank's blocks of both lanes (CPU copies), a list by rank."""
    from horovod_tpu_torch.common import elastic as ce

    return ce._allgather_object(_blocks(state), name=name)


def _blocks(state):
    import torch

    def cpu(st):
        if isinstance(st, dict):
            return {k: ([t.detach().cpu() for t in v] if isinstance(v, list)
                        else v.detach().cpu() if torch.is_tensor(v) else v)
                    for k, v in st.items()}
        return type(st)(*[tuple(t.detach().cpu() for t in v)
                          if isinstance(v, tuple) else v.detach().cpu()
                          for v in st])

    out = {}
    if hasattr(state, "split"):
        out["split"] = cpu(state.split[1])
    if hasattr(state, "eager"):
        out["eager"] = cpu(state.eager[1])
    return out


def _leaves():
    import torch

    from horovod_tpu_torch.parallel.zero import LeafSpec

    return [LeafSpec(tuple(v.shape), torch.float32)
            for _, v in sorted(_problem()[0].items())]


def _oracle(blocks_by_rank, size):
    """The gathered blocks re-sliced for ``size`` ranks, by lane."""
    from horovod_tpu_torch.models.convert import resize_zero_states

    return {lane: resize_zero_states([b[lane] for b in blocks_by_rank],
                                     _leaves(), size, BUCKET)
            for lane in blocks_by_rank[0]}


def _matches(state, oracle):
    """Whether this rank's blocks equal the oracle's for its rank."""
    import torch

    from horovod_tpu_torch.common import basics

    mine = _blocks(state)
    for lane, want in oracle.items():
        w = want[basics.rank()]
        for f in ("master", "mu", "nu"):
            got = getattr(mine[lane], f, None) if lane == "split" else \
                mine[lane].get(f)
            exp = getattr(w, f, None) if lane == "split" else w.get(f)
            if got is None and exp is None:
                continue
            if len(got) != len(exp) or not all(
                    torch.equal(a, b) for a, b in zip(got, exp)):
                return False
    return True


def _clone_run(lanes_factory, state, oracle, steps, first_step):
    """Losses and blocks of a run started at this size from ``state``'s
    params and the oracle's blocks (a fresh program and carry)."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    lanes = lanes_factory()
    trees = lanes.init()
    r = basics.rank()
    split_p, _ = state.split
    p, opt = trees["split"]
    for k in p:
        p[k].copy_(split_p[k])
    w = oracle["split"][r]
    opt = opt._replace(count=w.count.clone(), master=tuple(
        t.clone() for t in w.master), mu=tuple(t.clone() for t in w.mu),
        nu=tuple(t.clone() for t in w.nu))
    ep, es = state.eager
    p2, s2 = trees["eager"]
    for k in p2:
        p2[k].copy_(ep[k])
    we = oracle["eager"][r]
    s2 = dict(s2, count=we["count"].clone(),
              mu=[t.clone() for t in we["mu"]],
              nu=[t.clone() for t in we["nu"]])
    clone = hvd.elastic.TreeState(split=(p, opt), eager=(p2, s2))
    losses = [lanes.step(clone, first_step + i) for i in range(steps)]
    return losses, _snapshot(clone)


def _elastic_world(rank, size):
    import time

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import elastic as ce

    ckpt = os.environ["ZERO_ELASTIC_CKPT"]
    out = {"rank": rank}
    hvd.init(device="cpu")
    lanes = _Lanes()
    state = hvd.elastic.TreeState(checkpoint_dir=ckpt, step=0,
                                  **lanes.init())
    for i in range(2):
        lanes.step(state, i)
    state.step = 2
    state.commit()
    # -- shrink 3 -> 2, the victim's rows handed over -------------------
    before = _gather_blocks(state, "t.before_shrink")
    if not hvd.elastic.shrink([2], state=state):
        # The victim: back through the parole door, a fresh carry.
        hvd.elastic.rejoin(device="cpu")
        lanes = _Lanes()
        state = hvd.elastic.TreeState(checkpoint_dir=ckpt, step=0,
                                      **lanes.init())
        out["joined_at"] = hvd.rank()
        state.sync()
    else:
        oracle = _oracle(before, 2)
        out["shrunk"] = {"size": hvd.size(),
                         "matches": _matches(state, oracle)}
        want = _clone_run(_Lanes, state, oracle, 2, state.step)
        got = [lanes.step(state, state.step + i) for i in range(2)]
        out["shrunk"].update(losses=got, clone_losses=want[0],
                             state=_snapshot(state), clone=want[1])
        state.step += 2
        before = _gather_blocks(state, "t.before_grow")
        # -- grow 2 -> 3 through the door -------------------------------
        if rank == 0:
            door = ce._ensure_door()
            t0 = time.monotonic()
            while door.pending_count() == 0:
                assert time.monotonic() - t0 < 60, "no joiner knocked"
                time.sleep(0.05)
        try:
            state.commit()
            raise AssertionError("the commit let no joiner in")
        except hvd.HostsUpdatedInterrupt:
            hvd.elastic.reset()
            state.on_reset()
        state.sync()
    # -- all three: the grown world -------------------------------------
    out["grown"] = {"size": hvd.size(), "rank": hvd.rank(),
                    "step": state.step}
    olds = ce._allgather_object(before if rank != 2 else None,
                                name="t.old_blocks")
    oracle = _oracle(olds[0], 3)
    out["grown"]["matches"] = _matches(state, oracle)
    want = _clone_run(_Lanes, state, oracle, 2, state.step)
    got = [lanes.step(state, state.step + i) for i in range(2)]
    out["grown"].update(losses=got, clone_losses=want[0],
                        state=_snapshot(state), clone=want[1])
    state.step += 2
    # -- lost rows: a shrink without state=, read back from disk --------
    state.commit()
    before = _gather_blocks(state, "t.before_loss")
    if not hvd.elastic.shrink([2]):
        return out
    state.sync()
    out["from_disk"] = _matches(state, _oracle(before, 2))
    # ... and without checkpoint_dir: the typed error, not retried.
    bare = hvd.elastic.TreeState(split=state.split, eager=state.eager)
    if not hvd.elastic.shrink([1]):
        return out

    @hvd.elastic.run
    def train(st):
        out["ran"] = True

    try:
        train(bare)
    except hvd.HorovodStateLostError as e:
        out["lost"] = {"message": str(e), "lost": e.lost}
    # A cold restart at size 1 from the 3-rank commit: resume() takes this
    # rank's block file, sync() the others' from the disk.
    fresh = _Lanes()
    cold = hvd.elastic.TreeState(checkpoint_dir=ckpt, step=0, **fresh.init())
    out["resumed_step"] = cold.resume()
    cold.sync()
    out["resumed"] = _matches(cold, _oracle(before, 1))
    hvd.shutdown()
    return out


@pytest.fixture(scope="module")
def elastic_world(worlds):
    return worlds["elastic"]


def _same_losses_and_state(phase, r):
    assert phase["losses"] == phase["clone_losses"], f"rank {r}"
    _same(phase["state"], phase["clone"], f"rank {r}")


def test_shrink_hands_the_rows_over(elastic_world):
    for r in (0, 1):
        shrunk = elastic_world[r]["shrunk"]
        assert shrunk["size"] == 2 and shrunk["matches"], f"rank {r}"
        _same_losses_and_state(shrunk, r)


def test_rejoin_relays_the_blocks_out_over_the_grown_world(elastic_world):
    assert elastic_world[2]["joined_at"] == 2
    for r in range(3):
        grown = elastic_world[r]["grown"]
        assert (grown["size"], grown["rank"], grown["step"]) == (3, r, 4)
        assert grown["matches"], f"rank {r}"
        _same_losses_and_state(grown, r)


def test_lost_rows_come_back_from_the_commit_files(elastic_world):
    for r in (0, 1):
        assert elastic_world[r]["from_disk"], f"rank {r}"


def test_resume_at_another_size_reads_every_block(elastic_world):
    out = elastic_world[0]
    assert out["resumed_step"] >= 3 and out["resumed"]


def test_lost_rows_raise_the_typed_error(elastic_world):
    lost = elastic_world[0]["lost"]
    assert "ran" not in elastic_world[0]
    assert "blocks [1] of 2" in lost["message"]
    # The first state met (the split step's) names the flat rows of
    # block 1 in each bucket that has any.
    assert set(lost["lost"]) == {0} and lost["lost"][0]
    for bucket, rows in lost["lost"][0].items():
        assert rows and all(lo < hi for lo, hi in rows), (bucket, rows)


def _mesh_world(rank, size):
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import precision, train_step
    from horovod_tpu_torch.parallel.zero import ZeroConfig

    hvd.init(device="cpu")
    mesh = mesh_mod.create_mesh(data=2, device="cpu")
    ts = train_step.make_split_train_step(
        _loss, precision.fused_adam(LR),
        zero=ZeroConfig(mesh=mesh, bucket_bytes=BUCKET))
    carry = ts.init(_params())
    carry = ts.step(carry, _local(_problem()[1], 0))[1]
    state = hvd.elastic.TreeState(carry=carry)
    hvd.elastic.reset()          # the same world, the next epoch
    state.sync()                 # the blocks stay: the same world
    try:
        ts.step(state.carry, _local(_problem()[1], 1))
    except hvd.HorovodReformationError as e:
        msg = str(e)
    hvd.shutdown()
    return {"message": msg, "kept": torch.equal(state.carry[1].mu[0],
                                                carry[1].mu[0])}


def test_mesh_carry_raises_naming_a9b_on_reformation(worlds):
    """The error names why: the mesh's axes are fixed, and ZeRO under a
    mesh across a re-formation (once A9b) is not queued."""
    for out in worlds["mesh"]:
        assert "the axes are fixed" in out["message"]
        assert "Not queued" in out["message"] and out["kept"]
