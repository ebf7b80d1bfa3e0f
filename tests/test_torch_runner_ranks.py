"""The port's launcher with real ranks on gloo, against the reference's.

- ``python -m horovod_tpu_torch.runner.launch -np 2`` and the
  reference's launcher run the same worker of the port: each rank's
  ``HOROVOD_*`` environment is the same under both, apart from the
  controller port, and an exact allreduce gives the analytic sum.
- A rank that exits 3 while its peer blocks (a collective that never
  returns, as a peer's NCCL kernel would not, and a child of its own)
  ends the job: the launcher returns 1 within ``_TEARDOWN_S`` of the
  exit, and no process of the job is left alive.
- ``runner.run(fn, np=2)`` returns the results in rank order; the
  store's later waits keep their 600 s bound.
- ``HOROVOD_START_TIMEOUT=5`` with a peer that never starts: ``init``
  raises a ``TimeoutError`` naming the wait within ~15 s, not after
  the 600 s it used to take.
- A launcher sent SIGTERM takes its ranks down with it.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from tests.test_torch_mp import REPO_ROOT, free_port

_TEARDOWN_S = 10     # a failed rank's exit to the launcher's return

WORKER = textwrap.dedent("""\
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import torch
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    x = torch.full((5,), float(hvd.rank() + 1))
    got = hvd.allreduce(x, name="sum", op=hvd.Sum).tolist()
    env = {{k: v for k, v in os.environ.items()
           if k.startswith(("HOROVOD_", "OMPI_COMM_WORLD_"))}}
    with open(os.path.join({out!r}, f"rank{{hvd.rank()}}.json"), "w") as f:
        json.dump({{"env": env, "sum": got, "size": hvd.size()}}, f)
    hvd.shutdown()
""")


def _launch(module, argv, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, JAX_PLATFORMS="cpu")
    for k in list(env):
        if k.startswith("HOROVOD_"):
            del env[k]
    return subprocess.run([sys.executable, "-m", module, *argv],
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=cwd)


def test_launch_gives_the_references_environment(tmp_path):
    outs = {}
    for impl, module in (("port", "horovod_tpu_torch.runner.launch"),
                         ("ref", "horovod_tpu.runner.launch")):
        out = tmp_path / impl
        out.mkdir()
        worker = tmp_path / f"{impl}_worker.py"
        worker.write_text(WORKER.format(repo=REPO_ROOT, out=str(out)))
        proc = _launch(module, ["-np", "2", "--cycle-time-ms", "2",
                                "--network-interface", "lo",
                                sys.executable, str(worker)], tmp_path)
        assert proc.returncode == 0, (impl, proc.stdout, proc.stderr)
        outs[impl] = [json.loads((out / f"rank{r}.json").read_text())
                      for r in range(2)]
    ports = set()
    for r in range(2):
        port, ref = outs["port"][r], outs["ref"][r]
        assert port["sum"] == ref["sum"] == [3.0] * 5
        assert port["size"] == 2
        ports.add(port["env"].pop("HOROVOD_CONTROLLER_PORT"))
        ref["env"].pop("HOROVOD_CONTROLLER_PORT")
        assert port["env"] == ref["env"]
        assert port["env"]["HOROVOD_RANK"] == str(r)
        assert port["env"]["HOROVOD_CYCLE_TIME"] == "2.0"
        assert port["env"]["HOROVOD_GLOO_IFACE"] == "lo"
        assert port["env"]["HOROVOD_START_TIMEOUT"] == "60"
    assert len(ports) == 1       # one controller endpoint for the job


FAILING = textwrap.dedent("""\
    import os, subprocess, sys, time
    sys.path.insert(0, {repo!r})
    import torch
    import horovod_tpu_torch.torch as hvd

    out = {out!r}
    hvd.init(device="cpu")
    rank = hvd.rank()
    if rank == 1:
        time.sleep(1.0)
        with open(os.path.join(out, "exit.time"), "w") as f:
            f.write(repr(time.time()))
        os._exit(3)
    # Rank 0: a child of its own, then a collective its peer never
    # joins; whatever the lane does with the loss, it blocks on, as a
    # rank whose NCCL kernel never returns would.
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(600)"])
    with open(os.path.join(out, "pids"), "w") as f:
        f.write(f"{{os.getpid()}} {{child.pid}}")
    try:
        hvd.allreduce(torch.ones(4), name="never", op=hvd.Sum)
    except Exception:
        pass
    time.sleep(600)
""")


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # A zombie is not alive: it only waits for its parent to reap it.
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def test_a_failed_rank_ends_the_job(tmp_path):
    worker = tmp_path / "failing.py"
    worker.write_text(FAILING.format(repo=REPO_ROOT, out=str(tmp_path)))
    proc = _launch("horovod_tpu_torch.runner.launch",
                   ["-np", "2", sys.executable, str(worker)], tmp_path,
                   timeout=120)
    ended = time.time()
    assert proc.returncode == 1, (proc.stdout, proc.stderr)
    assert "ranks failed" in proc.stderr and "(1, 3)" in proc.stderr
    exit_time = float((tmp_path / "exit.time").read_text())
    assert ended - exit_time < _TEARDOWN_S, ended - exit_time
    pids = [int(p) for p in (tmp_path / "pids").read_text().split()]
    deadline = time.monotonic() + 5
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not [p for p in pids if _alive(p)], "a process of the job lives"


def _run_fn(scale):
    """Module-level (picklable) fn for runner.run: an exact allreduce,
    and the bound the store's later waits keep."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    hvd.init(device="cpu")
    try:
        out = hvd.allreduce(torch.full((3,), float(hvd.rank() + 1)),
                            op=hvd.Sum)
        return (hvd.rank(), float(out[0]) * scale,
                basics._store[1].timeout.total_seconds())
    finally:
        hvd.shutdown()


def test_run_returns_results_in_rank_order():
    from horovod_tpu_torch import runner

    before = os.environ.get("HOROVOD_RANK")
    got = runner.run(_run_fn, args=(10.0,), np=2, timeout=120,
                     env={"HOROVOD_START_TIMEOUT": "30"})
    assert got == [(0, 30.0, 600.0), (1, 30.0, 600.0)]
    assert os.environ.get("HOROVOD_RANK") == before


def test_start_timeout_bounds_a_missing_peer(tmp_path):
    code = textwrap.dedent(f"""\
        import sys, time
        sys.path.insert(0, {REPO_ROOT!r})
        import horovod_tpu_torch.torch as hvd
        t0 = time.monotonic()
        try:
            hvd.init(device="cpu")
        except TimeoutError as e:
            print("TIMEOUT", round(time.monotonic() - t0, 2), e)
            sys.exit(0)
        sys.exit(1)
    """)
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, HOROVOD_RANK="0",
               HOROVOD_SIZE="2", HOROVOD_CONTROLLER_ADDR="127.0.0.1",
               HOROVOD_CONTROLLER_PORT=str(free_port()),
               HOROVOD_START_TIMEOUT="5")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, env=env)
    took = time.monotonic() - t0
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("TIMEOUT"))
    assert "HOROVOD_START_TIMEOUT (5 s) ran out" in line
    assert "waited for all 2 ranks to connect" in line
    waited = float(line.split()[1])
    assert 4.5 <= waited < 15 and took < 30, (waited, took)


@pytest.mark.parametrize("value,seconds", [(None, 60.0), ("7", 7.0),
                                           ("2.5", 2.5)])
def test_start_timeout_default(value, seconds, monkeypatch):
    from horovod_tpu_torch.common import basics

    if value is None:
        monkeypatch.delenv("HOROVOD_START_TIMEOUT", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_START_TIMEOUT", value)
    assert basics._start_timeout().total_seconds() == seconds
    assert basics._TIMEOUT.total_seconds() == 600


def test_sigterm_to_the_launcher_takes_the_ranks_down(tmp_path):
    """A launcher that is itself terminated leaves no rank behind."""
    sleeper = tmp_path / "sleeper.py"
    sleeper.write_text(textwrap.dedent(f"""\
        import os, time
        rank = os.environ["HOROVOD_RANK"]
        with open(os.path.join({str(tmp_path)!r}, "pid" + rank), "w") as f:
            f.write(str(os.getpid()))
        time.sleep(600)
    """))
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
         sys.executable, str(sleeper)], env=env, cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while not all((tmp_path / f"pid{r}").exists() for r in range(2)):
            assert time.monotonic() < deadline, "the ranks never started"
            time.sleep(0.1)
        pids = [int((tmp_path / f"pid{r}").read_text()) for r in range(2)]
        proc.terminate()
        assert proc.wait(timeout=30) == 128 + 15
    finally:
        if proc.poll() is None:
            proc.kill()
    deadline = time.monotonic() + 5
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not [p for p in pids if _alive(p)]
