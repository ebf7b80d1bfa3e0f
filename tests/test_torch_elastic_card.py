"""A survivor keeps its card under the elastic driver.

The driver numbers a host's workers by spawn age at every epoch, so a
survivor's ``local_rank`` can change: on a host with two slots, A in
slot 0 and B in slot 1, A dies and C is respawned into slot 0; at the
new epoch B is the oldest and gets local rank 0. B's state stays on the
card it ran on (``TreeState.restore`` puts each tensor back where it was
committed from), so the lane must open there too: the card is the spawn
slot (``HOROVOD_ELASTIC_SLOT``, ``basics.card_index``), which a worker
keeps for its life, not the epoch's local rank.

On the CPU: the port's ``ElasticDriver`` over fake workers (each
registers with the rendezvous and waits for its exit), the assignments
it publishes before and after the older worker's death, and the card
each worker resolves from its spawn environment. On two or more cards
(``cuda_sm90``): the same kill under ``horovodrun-torch`` and the
elastic driver, a ``TreeState`` committed and restored on the card, NCCL
allreduces after the re-formation; it skips below two cards.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.runner.elastic import driver as drv
from horovod_tpu_torch.runner.elastic.discovery import FixedHosts
from horovod_tpu_torch.runner.elastic.rendezvous import RendezvousClient
from tests.test_torch_mp import REPO_ROOT


def _wait(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.02)


class _FakeFleet:
    """``_execute_worker`` for a driver: each worker registers with the
    rendezvous and runs until it is told to exit (or is killed)."""

    def __init__(self, driver):
        self.driver = driver
        self.lock = threading.Lock()
        self.workers = {}     # worker_id -> dict(env, worker, exit, rc)

    def __call__(self, worker, env):
        rec = dict(env=env, worker=worker, exit=threading.Event(), rc=0)
        with self.lock:
            self.workers[worker.worker_id] = rec
        RendezvousClient(env["HOROVOD_RDZV_ADDR"],
                         env["HOROVOD_RDZV_PORT"]).register(
            worker.worker_id, worker.host, worker.local_index, None)
        while not (rec["exit"].is_set() or worker.kill_event.is_set()
                   or self.driver._shutdown.is_set()):
            time.sleep(0.02)
        return rec["rc"]

    def by_slot(self, slot):
        with self.lock:
            live = [r for r in self.workers.values()
                    if r["worker"].local_index == slot
                    and not r["exit"].is_set()]
        assert len(live) == 1, live
        return live[0]

    def assignment(self, rec, epoch):
        env = rec["env"]
        return RendezvousClient(env["HOROVOD_RDZV_ADDR"],
                                env["HOROVOD_RDZV_PORT"]).poll_assignment(
            rec["worker"].worker_id, 30, min_epoch=epoch)


def _card(env, asg, monkeypatch):
    """The card ``hvd.init`` opens for a worker spawned with ``env`` under
    assignment ``asg``."""
    with monkeypatch.context() as m:
        if "HOROVOD_ELASTIC_SLOT" in env:
            m.setenv("HOROVOD_ELASTIC_SLOT", env["HOROVOD_ELASTIC_SLOT"])
        else:
            m.delenv("HOROVOD_ELASTIC_SLOT", raising=False)
        return basics.card_index(asg["local_rank"])


def test_survivor_keeps_its_card_when_the_older_worker_dies(monkeypatch):
    d = drv.ElasticDriver(FixedHosts({"localhost": 2}), ["unused"],
                          min_np=2, max_np=2, poll_interval=0.1,
                          start_timeout=30)
    fleet = _FakeFleet(d)
    monkeypatch.setattr(d, "_execute_worker", fleet)
    d.start()
    try:
        _wait(lambda: d.rendezvous.epoch >= 1, what="epoch 1")
        a, b = fleet.by_slot(0), fleet.by_slot(1)
        a1, b1 = fleet.assignment(a, 1), fleet.assignment(b, 1)
        assert (a1["rank"], a1["local_rank"]) == (0, 0)
        assert (b1["rank"], b1["local_rank"]) == (1, 1)
        cards = {"A": _card(a["env"], a1, monkeypatch),
                 "B": _card(b["env"], b1, monkeypatch)}
        assert cards == {"A": 0, "B": 1}

        a["rc"] = 1                      # the older worker fails
        a["exit"].set()
        _wait(lambda: d.rendezvous.epoch >= 2, what="epoch 2")
        c = fleet.by_slot(0)
        assert c["worker"].worker_id != a["worker"].worker_id
        b2, c2 = fleet.assignment(b, 2), fleet.assignment(c, 2)
        # The reference's layout: the survivor is rank 0 and, the oldest
        # on its host, local rank 0; local_rank == rank % local_size.
        assert (b2["rank"], b2["local_rank"]) == (0, 0)
        assert (c2["rank"], c2["local_rank"]) == (1, 1)
        for asg in (b2, c2):
            assert asg["local_rank"] == asg["rank"] % asg["local_size"]
        # The card is the slot: B stays on the card its state is on, and
        # C takes the card A left.
        assert _card(b["env"], b2, monkeypatch) == cards["B"] == 1
        assert _card(c["env"], c2, monkeypatch) == cards["A"] == 0
        assert c["env"]["HOROVOD_ELASTIC_SLOT"] == "0"
        assert b["env"]["HOROVOD_ELASTIC_SLOT"] == "1"
    finally:
        d.stop()


def test_without_a_slot_the_card_is_the_local_rank(monkeypatch):
    """The static launcher (``--local-cards``) and the reference's driver
    set no slot: the card stays ``cuda:{local_rank}``."""
    monkeypatch.delenv("HOROVOD_ELASTIC_SLOT", raising=False)
    assert basics.card_index(3) == 3
    monkeypatch.setenv("HOROVOD_ELASTIC_SLOT", "")
    assert basics.card_index(2) == 2
    monkeypatch.setenv("HOROVOD_ELASTIC_SLOT", "1")
    assert basics.card_index(0) == 1


# ---- on two cards ----------------------------------------------------------

_WORKER = """
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
import horovod_tpu_torch.torch as hvd

out = {out!r}
hvd.init()
slot = int(os.environ["HOROVOD_ELASTIC_SLOT"])
torch.manual_seed(0)
carry = {{"w": torch.randn(1 << 20, device="cuda")}}
state = hvd.elastic.TreeState(carry=carry, step=0)


@hvd.elastic.run
def train(state):
    while state.step < 6:
        if state.step == 3 and slot == 0:
            try:
                fd = os.open(os.path.join(out, "fault.lock"),
                             os.O_CREAT | os.O_EXCL)
                os.close(fd)
                os._exit(17)
            except FileExistsError:
                pass
        w = state.carry["w"]
        g = hvd.allreduce(torch.full_like(w, float(state.step + 1)),
                          name="g", op=hvd.Average)
        w.sub_(0.01 * g)
        state.step += 1
        state.commit()


train(state)
w = state.carry["w"]
with open(os.path.join(out, f"slot{{slot}}.json"), "w") as f:
    json.dump({{"slot": slot, "rank": hvd.rank(),
               "local_rank": hvd.local_rank(),
               "current": torch.cuda.current_device(),
               "state_card": w.device.index, "step": int(state.step),
               "sum": float(w.double().sum())}}, f)
hvd.shutdown()
"""


@pytest.mark.cuda_sm90
def test_survivor_keeps_its_card_on_two_cards(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=REPO_ROOT, out=str(tmp_path)))
    hosts = tmp_path / "hosts.sh"
    hosts.write_text("#!/bin/sh\necho localhost:2\n")
    hosts.chmod(0o755)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(PYTHONPATH=REPO_ROOT, CUDA_VISIBLE_DEVICES="0,1")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "--min-np", "2", "--max-np", "2", "--host-discovery-script",
         str(hosts), "--elastic-poll-interval", "0.5", sys.executable,
         str(worker)], capture_output=True, text=True, timeout=300,
        env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert (tmp_path / "fault.lock").exists()
    got = {s: json.loads((tmp_path / f"slot{s}.json").read_text())
           for s in (0, 1)}
    survivor, respawn = got[1], got[0]
    # The survivor is rank 0 and local rank 0 after the respawn, and
    # stays on card 1 with its restored state; the respawn is on card 0.
    assert (survivor["rank"], survivor["local_rank"]) == (0, 0)
    assert survivor["current"] == survivor["state_card"] == 1
    assert (respawn["rank"], respawn["local_rank"]) == (1, 1)
    assert respawn["current"] == respawn["state_card"] == 0
    assert survivor["step"] == respawn["step"] == 6
    assert survivor["sum"] == respawn["sum"]
