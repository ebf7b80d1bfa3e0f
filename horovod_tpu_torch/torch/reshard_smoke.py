"""Four-rank resharding smoke of the port.

    python -m horovod_tpu_torch.torch.reshard_smoke [--cpu]

The port's copy of ``horovod_tpu/jax/reshard_smoke.py``: four ranks as
two slices of two (``HOROVOD_CROSS_PLANE=hier``), on the cards (NCCL, a
card a rank) when four are visible, else, with ``--cpu``, on gloo; it
prints which. It proves:

- **hierarchical train-step parity**: an eager data-parallel SGD loop
  (an Average allreduce a step) under the hierarchical split lands
  exactly on the locally replayed trajectory (integer-valued gradients,
  so no summation order can differ), and each step's cross-plane bytes
  are ``parallel.reshard.hier_wire_bytes``' to the byte, at most about
  1/2 of what the flat ring pushes through the slice boundary;
- **checkpoint resharding**: a 4-way row-sharded tensor moved to the
  serve layout (2 uneven shards, the other ranks empty), then to every
  rank, then back, by ``execute_plan``, each step equal to
  ``simulate_plan`` bit for bit and back to the start;
- **ZeRO across re-formations**: the split step's ZeRO carry under
  ``hvd.elastic.TreeState`` over 4 ranks, a voluntary ``shrink([3],
  state=)`` to 3 (the victim hands its rows over), two steps, then the
  victim back through the parole door and ``sync`` to 4: after each
  move every rank's blocks equal the gathered blocks re-sliced for the
  new world (``models/convert.py resize_zero_states``), bit for bit.

The reference reconciles measured wire bytes of every plan; NCCL and
gloo report none for alltoall and allgather, so the port's plans are
held to the JAX package's ``plan_redistribute`` byte for byte in
``tests/test_torch_reshard.py`` instead.
"""

import os
import socket
import subprocess
import sys

STEPS = 4
DIM = 8192 + 37
LOCAL = 2
SIZE = 4
ROWS = 37
BUCKET = 96


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _hier_parity(hvd, torch, device):
    import numpy as np

    from horovod_tpu_torch.parallel.reshard import (
        flat_allreduce_wire_bytes,
        hier_wire_bytes,
    )

    rank, size = hvd.rank(), hvd.size()
    grid = torch.arange(DIM, dtype=torch.float32, device=device) % 9 - 4
    params = np.zeros(DIM, np.float64)
    replay = np.zeros(DIM, np.float64)
    w0 = hvd.metrics()["wire"]
    for step in range(STEPS):
        mean = hvd.allreduce(grid * float(rank + 1 + step),
                             name=f"train.{step}", op=hvd.Average)
        params -= 0.1 * mean.double().cpu().numpy()
        replay -= 0.1 * (grid.double().cpu().numpy()
                         * (sum(range(1, size + 1)) / size + step))
    w1 = hvd.metrics()["wire"]
    np.testing.assert_array_equal(params, replay)
    pred = hier_wire_bytes(DIM, 4, size, LOCAL, rank)
    cross = w1["cross_tx_bytes"] - w0["cross_tx_bytes"]
    total = w1["tx_bytes"] - w0["tx_bytes"]
    assert cross == STEPS * pred["cross"], (cross, STEPS * pred["cross"])
    assert total == STEPS * (pred["cross"] + pred["intra"]), \
        (total, STEPS * (pred["cross"] + pred["intra"]))
    flat = sum(flat_allreduce_wire_bytes(DIM, 4, size, r)
               for r in range(size))
    world_cross = sum(hier_wire_bytes(DIM, 4, size, LOCAL, r)["cross"]
                      for r in range(size))
    ratio = world_cross / flat
    assert ratio <= 1.0 / LOCAL + 0.05, ratio
    return {"cross_ratio": round(ratio, 4), "train_cross_bytes": cross}


def _checkpoint_round_trip(hvd, torch, device):
    from horovod_tpu_torch.parallel.reshard import (
        Layout,
        execute_plan,
        plan_redistribute,
        simulate_plan,
    )

    rank, size = hvd.rank(), hvd.size()
    full = torch.arange(ROWS * 4, dtype=torch.float32).reshape(ROWS, 4)
    train = Layout.sharded(ROWS, size)
    serve = Layout.from_rows([(0, 20), (20, 17), (37, 0), (37, 0)])
    s, c = train.rows[rank]
    local = full[s:s + c].to(device)
    sim = [full[a:a + n].numpy() for a, n in train.rows]
    planned = 0
    for src, dst, tag in ((train, serve, "to-serve"),
                          (serve, Layout.replicated(size), "rep"),
                          (Layout.replicated(size), train, "back")):
        plan = plan_redistribute(tuple(full.shape), full.numpy().dtype, src,
                                 dst)
        local = execute_plan(plan, local, name=f"ckpt.{tag}")
        sim = simulate_plan(plan, sim)
        assert local.device == torch.device(device), local.device
        assert (local.cpu().numpy() == sim[rank]).all(), tag
        planned += plan.wire_tx_bytes(rank)
    assert torch.equal(local.cpu(), full[s:s + c])
    return {"reshard_planned_tx_bytes": planned}


def _loss(torch):
    def loss(p, d):
        h = torch.tanh(d["x"] @ p["w1"] + p["b1"][:16].sum())
        return torch.mean((h @ p["w2"] - d["y"]) ** 2)

    return loss


def _problem(torch, device):
    g = torch.Generator().manual_seed(11)
    params = {"w1": torch.randn(8, 16, generator=g) * 0.3,
              "b1": torch.randn(13, generator=g) * 0.1,
              "w2": torch.randn(16, 4, generator=g) * 0.3}
    batch = {"x": torch.randn(12, 8, generator=g),
             "y": torch.randn(12, 4, generator=g)}
    return ({k: v.to(device) for k, v in params.items()},
            {k: v.to(device) for k, v in batch.items()})


def _rows(hvd, batch):
    n = 12 // hvd.size()
    r = hvd.rank()
    return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


def _blocks(carry):
    opt = carry[1]
    return type(opt)(*[tuple(t.detach().cpu() for t in v)
                       if isinstance(v, tuple) else v.detach().cpu()
                       for v in opt])


def _check_relaid(hvd, torch, state, before, leaves):
    from horovod_tpu_torch.models.convert import resize_zero_states

    want = resize_zero_states(before, leaves, hvd.size(), BUCKET)[
        hvd.rank()]
    got = _blocks(state.carry)
    for f in ("mu", "nu"):
        a, b = getattr(got, f), getattr(want, f)
        assert len(a) == len(b) and all(
            torch.equal(x, y) for x, y in zip(a, b)), f
    return True


def _zero_round_trip(hvd, torch, device, rank0):
    """4 -> 3 -> 4 ranks with a ZeRO carry; ``rank0`` is this process's
    first rank."""
    import time

    from horovod_tpu_torch.common import elastic as ce
    from horovod_tpu_torch.parallel import precision, train_step
    from horovod_tpu_torch.parallel.zero import LeafSpec, ZeroConfig

    def build():
        ts = train_step.make_split_train_step(
            _loss(torch), precision.fused_adam(1e-2),
            zero=ZeroConfig(bucket_bytes=BUCKET))
        params, batch = _problem(torch, device)
        return ts, hvd.elastic.TreeState(carry=ts.init(params), step=0), \
            batch

    ts, state, batch = build()
    leaves = [LeafSpec(tuple(v.shape), v.dtype)
              for _, v in sorted(state.carry[0].items())]
    for _ in range(2):
        state.carry = ts.step(state.carry, _rows(hvd, batch))[1]
    state.commit()
    before = ce._allgather_object(_blocks(state.carry), name="t.before")
    moves = []
    if not hvd.elastic.shrink([3], state=state):
        hvd.elastic.rejoin(device=None if device != "cpu" else "cpu")
        ts, state, batch = build()
        state.sync()
        before = None
    else:
        moves.append(("4->3", _check_relaid(hvd, torch, state, before,
                                            leaves)))
        for _ in range(2):
            state.carry = ts.step(state.carry, _rows(hvd, batch))[1]
        before = ce._allgather_object(_blocks(state.carry), name="t.grow")
        if hvd.rank() == 0:
            door, t0 = ce._ensure_door(), time.monotonic()
            while door.pending_count() == 0:
                assert time.monotonic() - t0 < 120, "no joiner knocked"
                time.sleep(0.05)
        try:
            state.commit()
            raise AssertionError("the commit let no joiner in")
        except hvd.HostsUpdatedInterrupt:
            hvd.elastic.reset()
            state.on_reset()
        state.sync()
    before = ce._allgather_object(before, name="t.old")[0]
    moves.append(("3->4", _check_relaid(hvd, torch, state, before, leaves)))
    loss = float(ts.step(state.carry, _rows(hvd, batch))[0])
    assert loss == loss, "a non-finite loss after the moves"
    return {"zero_moves": moves, "first_rank": rank0}


def worker(device_kind):
    import torch

    import horovod_tpu_torch.torch as hvd

    rank0 = int(os.environ["HOROVOD_RANK"])
    if device_kind == "cpu":
        hvd.init(device="cpu")
        device = "cpu"
    else:
        hvd.init()                 # on cuda:{HOROVOD_ELASTIC_SLOT}
        device = f"cuda:{rank0}"
    out = {}
    out.update(_hier_parity(hvd, torch, device))
    out.update(_checkpoint_round_trip(hvd, torch, device))
    out.update(_zero_round_trip(hvd, torch, device, rank0))
    print(f"RESHARD_SMOKE_OK rank={hvd.rank()} " + " ".join(
        f"{k}={v}" for k, v in out.items()), flush=True)
    hvd.shutdown()
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return worker(argv[1])
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if "--cpu" in argv:
        kind = "cpu"
    elif cards >= SIZE:
        kind = "cuda"
    else:
        print(f"reshard_smoke: {cards} CUDA device(s) visible, {SIZE} "
              "needed (use --cpu for gloo)", file=sys.stderr)
        return 2
    print(f"reshard_smoke: {SIZE} ranks on "
          f"{'gloo (CPU)' if kind == 'cpu' else 'NCCL, a card a rank'}",
          flush=True)
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for rank in range(SIZE):
        env = dict(os.environ,
                   HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(SIZE),
                   HOROVOD_LOCAL_RANK=str(rank % LOCAL),
                   HOROVOD_LOCAL_SIZE=str(LOCAL),
                   HOROVOD_CROSS_RANK=str(rank // LOCAL),
                   HOROVOD_CROSS_SIZE=str(SIZE // LOCAL),
                   HOROVOD_CROSS_PLANE="hier",
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port),
                   HOROVOD_START_TIMEOUT="300",
                   # The card is the rank's; the local rank (the slice
                   # position) only shapes the hierarchical split.
                   HOROVOD_ELASTIC_SLOT=str(rank),
                   HOROVOD_REJOIN_PORT=str(_free_port()) if rank == 0
                   else "",
                   PYTHONPATH=repo + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(env)
    door = procs[0]["HOROVOD_REJOIN_PORT"]
    running = []
    for env in procs:
        env["HOROVOD_REJOIN_PORT"] = door
        running.append(subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.torch.reshard_smoke",
             "--worker", kind], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=repo))
    failed = False
    for rank, p in enumerate(running):
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\nTIMEOUT"
        ok = p.returncode == 0 and "RESHARD_SMOKE_OK" in out
        print(out.strip())
        if not ok:
            print(f"rank {rank} FAILED (rc={p.returncode})")
            failed = True
    if failed:
        return 1
    print(f"reshard_smoke: OK ({SIZE} ranks as 2 slices: hierarchical train "
          "parity with exact cross-plane bytes, checkpoint reshard round "
          "trip, ZeRO carry 4 -> 3 -> 4 bit-equal to the re-sliced state)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
