"""The port's bare-mpirun bootstrap against the reference's.

- The launcher gate: ``_under_mpi_launcher`` gives the reference's
  verdict on the same environments (``-np 1`` and ``SLURM_PROCID``
  alone do not count).
- mpi4py is imported only behind the gate, with ``rc.initialize`` off
  and ``MPI.Init()`` called explicitly.
- On a 3-rank file-mailbox MPI world (three threads, each its own
  communicator; two "hosts", ranks 0-1 and rank 2), the port's
  ``maybe_bootstrap_from_mpi`` writes the same identity variables and
  endpoint as the reference's, rank 0's ``(ip, port)`` reaching every
  rank by ``comm.bcast``; a launcher's ``HOROVOD_RANK`` and a world of
  one leave the environment alone.
- ``hvd.init`` bootstraps without a launcher, and
  ``HOROVOD_CONTROLLER=mpi`` raises naming ROADMAP.md L9b.

``tests/fake_mpi.py`` has no ``bcast``, so this file has its own fake,
whose ``bcast`` rides ``isend``/``recv`` on the same kind of mailbox.
"""

import os
import pickle
import sys
import threading
import time
import types

import pytest

from horovod_tpu.common import mpi_bootstrap as ref_boot
from horovod_tpu_torch.common import mpi_bootstrap as boot

GATE_CASES = [
    ({}, False),
    ({"OMPI_COMM_WORLD_SIZE": "4"}, True),
    ({"OMPI_COMM_WORLD_SIZE": "1"}, False),
    ({"PMI_SIZE": "2"}, True),
    ({"PMI_SIZE": "x"}, False),
    ({"MV2_COMM_WORLD_SIZE": "8"}, True),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "4"}, False),
    ({"PMIX_RANK": "0"}, False),
    ({"PMIX_RANK": "0", "SLURM_STEP_NUM_TASKS": "3"}, True),
    ({"PMIX_RANK": "0", "SLURM_NTASKS": "1"}, False),
    ({"PMIX_RANK": "1", "SLURM_NTASKS": "2"}, True),
]


@pytest.mark.parametrize("environ,want", GATE_CASES)
def test_launcher_gate_matches_reference(environ, want):
    assert boot._under_mpi_launcher(environ) == want
    assert ref_boot._under_mpi_launcher(environ) == want


def test_routable_ip_is_ipv4():
    ip = boot._routable_ip()
    assert ip == ref_boot._routable_ip()
    parts = ip.split(".")
    assert len(parts) == 4 or ip == __import__("socket").gethostname()


# ---- mpi4py only behind the gate ------------------------------------------

FAKE_PACKAGE = '''\
import os
class rc:
    initialize = True
'''

FAKE_MPI = '''\
import os
import mpi4py
log = []
log.append(("import", mpi4py.rc.initialize))
_init = [False]
def Is_initialized():
    return _init[0]
def Is_finalized():
    return False
def Init():
    log.append(("Init",))
    _init[0] = True
def Finalize():
    pass
class _W:
    def Get_size(self):
        return 1
COMM_WORLD = _W()
'''


@pytest.fixture
def fake_mpi4py_on_path(tmp_path, monkeypatch):
    pkg = tmp_path / "mpi4py"
    pkg.mkdir()
    (pkg / "__init__.py").write_text(FAKE_PACKAGE)
    (pkg / "MPI.py").write_text(FAKE_MPI)
    monkeypatch.syspath_prepend(str(tmp_path))
    for name in ("mpi4py", "mpi4py.MPI"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    yield
    for name in ("mpi4py", "mpi4py.MPI"):
        sys.modules.pop(name, None)


def test_mpi4py_is_imported_only_behind_the_gate(fake_mpi4py_on_path):
    assert boot._mpi_world({}) is None
    assert boot.maybe_bootstrap_from_mpi({}) is False
    assert "mpi4py" not in sys.modules
    world = boot._mpi_world({"OMPI_COMM_WORLD_SIZE": "2"})
    assert world is not None
    MPI, comm = world
    # Imported with MPI_Init off, then initialized explicitly.
    assert MPI.log == [("import", False), ("Init",)]
    assert comm is MPI.COMM_WORLD
    # A world of one has nothing to bootstrap.
    env = {"OMPI_COMM_WORLD_SIZE": "2"}
    assert boot.maybe_bootstrap_from_mpi(env) is False
    assert env == {"OMPI_COMM_WORLD_SIZE": "2"}


# ---- a 3-rank file-mailbox world ------------------------------------------

HOSTS = ("a", "a", "b")     # rank -> host: two ranks on a, one on b


class _Sub:
    def __init__(self, rank, size):
        self._rank, self._size = rank, size

    def Get_rank(self):
        return self._rank

    def Get_size(self):
        return self._size


class _Comm:
    """One rank's COMM_WORLD: point-to-point as atomic file renames in a
    shared directory (the ``tests/fake_mpi.py`` scheme), ``bcast`` on
    top of them, the splits from ``HOSTS``."""

    def __init__(self, directory, rank, size):
        self.dir, self.rank, self.size = directory, rank, size
        self._send_seq, self._recv_seq = {}, {}

    def Get_rank(self):
        return self.rank

    def Get_size(self):
        return self.size

    def _split(self, color):
        members = [r for r in range(self.size) if color(r) == color(
            self.rank)]
        return _Sub(members.index(self.rank), len(members))

    def Split_type(self, kind, key=0):
        return self._split(lambda r: HOSTS[r])

    def Split(self, color=0, key=0):
        local = [HOSTS[:r].count(HOSTS[r]) for r in range(self.size)]
        return self._split(lambda r: local[r]) if color == local[
            self.rank] else None

    def _path(self, src, dst, tag, seq):
        return os.path.join(self.dir, f"m_{src}_{dst}_{tag}_{seq:08d}")

    def isend(self, data, dest, tag=0):
        seq = self._send_seq.get((dest, tag), 0)
        self._send_seq[(dest, tag)] = seq + 1
        final = self._path(self.rank, dest, tag, seq)
        with open(final + ".tmp", "wb") as f:
            pickle.dump(data, f)
        os.replace(final + ".tmp", final)

    def recv(self, source, tag=0):
        seq = self._recv_seq.get((source, tag), 0)
        self._recv_seq[(source, tag)] = seq + 1
        path = self._path(source, self.rank, tag, seq)
        deadline = time.time() + 30
        while not os.path.exists(path):
            assert time.time() < deadline, f"fake recv timed out: {path}"
            time.sleep(0.002)
        with open(path, "rb") as f:
            data = pickle.load(f)
        os.remove(path)
        return data

    def bcast(self, obj, root=0):
        if self.rank == root:
            for r in range(self.size):
                if r != root:
                    self.isend(obj, r, tag=7)
            return obj
        return self.recv(root, tag=7)


class _ThreadWorld:
    """An ``mpi4py`` stand-in whose ``MPI.COMM_WORLD`` is the calling
    thread's communicator."""

    COMM_TYPE_SHARED = 1

    def __init__(self):
        self.local = threading.local()

    @property
    def COMM_WORLD(self):
        return self.local.comm

    def Is_initialized(self):
        return True

    def Is_finalized(self):
        return False


def _bootstrap_world(tmp_path, fn, environs, monkeypatch):
    """Run ``fn(environ)`` on 3 threads, one rank each; returns
    (results, the environs afterwards)."""
    mpi = _ThreadWorld()
    monkeypatch.setitem(sys.modules, "mpi4py",
                        types.SimpleNamespace(MPI=mpi))
    box = tmp_path / f"box{len(list(tmp_path.iterdir()))}"
    box.mkdir()
    results, errors = [None] * 3, []

    def rank(r):
        mpi.local.comm = _Comm(str(box), r, 3)
        try:
            results[r] = fn(environs[r])
        except Exception as e:  # noqa: BLE001
            errors.append((r, e))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    return results, environs


IDENTITY = [
    # rank, size, local_rank, local_size, cross_rank, cross_size
    ("0", "3", "0", "2", "0", "2"),
    ("1", "3", "1", "2", "0", "1"),
    ("2", "3", "0", "1", "1", "2"),
]
_KEYS = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
         "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE")


@pytest.mark.parametrize("port", ["29777", None])
def test_bootstrap_matches_reference_on_three_ranks(tmp_path, monkeypatch,
                                                    port):
    def environs():
        base = {"OMPI_COMM_WORLD_SIZE": "3"}
        return [dict(base, **({"HOROVOD_CONTROLLER_PORT": port}
                              if port and r == 0 else {}))
                for r in range(3)]

    got, port_env = _bootstrap_world(
        tmp_path, boot.maybe_bootstrap_from_mpi, environs(), monkeypatch)
    want, ref_env = _bootstrap_world(
        tmp_path, ref_boot.maybe_bootstrap_from_mpi, environs(), monkeypatch)
    assert got == want == [True] * 3
    ip = boot._routable_ip()
    for r in range(3):
        assert tuple(port_env[r][k] for k in _KEYS) == IDENTITY[r]
        assert port_env[r]["HOROVOD_CONTROLLER_ADDR"] == ip
        # Rank 0's port reached every rank.
        assert port_env[r]["HOROVOD_CONTROLLER_PORT"] == \
            port_env[0]["HOROVOD_CONTROLLER_PORT"]
        if port:
            assert port_env[r] == ref_env[r]
        else:
            drop = lambda e: {k: v for k, v in e.items()  # noqa: E731
                              if k != "HOROVOD_CONTROLLER_PORT"}
            assert drop(port_env[r]) == drop(ref_env[r])
            assert 0 < int(port_env[r]["HOROVOD_CONTROLLER_PORT"]) < 65536


def test_bootstrap_leaves_a_launched_job_alone(tmp_path, monkeypatch):
    envs = [{"OMPI_COMM_WORLD_SIZE": "3", "HOROVOD_RANK": str(r)}
            for r in range(3)]
    before = [dict(e) for e in envs]
    got, after = _bootstrap_world(tmp_path, boot.maybe_bootstrap_from_mpi,
                                  envs, monkeypatch)
    assert got == [False] * 3 and after == before


# ---- hvd.init ------------------------------------------------------------

def test_init_bootstraps_without_a_launcher(monkeypatch):
    import horovod_tpu_torch.torch as hvd

    calls = []

    def fake_bootstrap(environ=os.environ):
        calls.append("HOROVOD_RANK" in environ)
        return False

    for k in ("HOROVOD_RANK", "HOROVOD_RDZV_ADDR", "HOROVOD_CONTROLLER",
              "HOROVOD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(boot, "maybe_bootstrap_from_mpi", fake_bootstrap)
    hvd.init(device="cpu")
    try:
        assert calls == [False] and hvd.size() == 1
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("value", ["mpi", "MPI"])
def test_mpi_controller_raises_naming_l9b(value, monkeypatch):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    monkeypatch.delenv("HOROVOD_RDZV_ADDR", raising=False)
    monkeypatch.setenv("HOROVOD_CONTROLLER", value)
    with pytest.raises(NotImplementedError, match="L9b"):
        hvd.init(device="cpu")
    assert not basics.is_initialized()
    monkeypatch.setenv("HOROVOD_CONTROLLER", "gloo")
    boot.check_controller()
