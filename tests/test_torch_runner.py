"""The port's launcher against the reference's, in one process.

Each case of ``tests/single/test_runner.py`` runs over the reference's
function and the port's, or compares their outputs on the same inputs:
host parsing and the rank layout, ``parse_args`` with
``env_from_args`` (the ``HOROVOD_*`` environment), the config file (the
port's flat reader against ``yaml.safe_load`` on the same files),
``_ssh_wrap``, the ``mpirun`` and ``jsrun`` command lines,
``detect_mpi_flavor``, ``LSFUtils``, ``run_controller``, the NIC
discovery round trip across the two packages' services and the dropped
message with a bad HMAC. Then the port's own surface: ``_slot_env``
and the launched slots' environment with and without ``--local-cards``
(no ``CUDA_VISIBLE_DEVICES`` of a rank's own, ever), ``--local-cards``
on a machine with no card (raises), and ``--check-build``'s rows.
"""

import dataclasses
import os
import socket
import textwrap

import pytest
import torch
import yaml

from horovod_tpu.runner import launch as ref_launch
from horovod_tpu.runner import util as ref_util
from horovod_tpu_torch.runner import launch, util

IMPLS = {"ref": (ref_launch, ref_util), "port": (launch, util)}
impls = pytest.mark.parametrize("impl", sorted(IMPLS))


def _rows(items):
    return [dataclasses.astuple(x) for x in items]


# ---- hosts and the rank layout ------------------------------------------

@impls
def test_parse_hosts(impl):
    _, u = IMPLS[impl]
    assert _rows(u.parse_hosts("a:2,b:4,c")) == [("a", 2), ("b", 4),
                                                  ("c", 1)]
    assert _rows(u.parse_hosts(" x:3 ,, y ")) == \
        _rows(ref_util.parse_hosts(" x:3 ,, y "))


@impls
def test_parse_hostfile(impl, tmp_path):
    _, u = IMPLS[impl]
    f = tmp_path / "hosts"
    f.write_text(textwrap.dedent("""\
        # comment
        node1 slots=4
        node2:2   # trailing
        node3
    """))
    assert _rows(u.parse_hostfile(str(f))) == [
        ("node1", 4), ("node2", 2), ("node3", 1)]


@pytest.mark.parametrize("hosts,np", [("a:2,b:2", 3), ("a:2,b:2", 4),
                                      ("a:4", 1), ("a:1,b:3,c:2", 5),
                                      ("localhost:8", 8)])
def test_host_assignments_match_reference(hosts, np):
    got = _rows(util.get_host_assignments(util.parse_hosts(hosts), np))
    want = _rows(ref_util.get_host_assignments(ref_util.parse_hosts(hosts),
                                               np))
    assert got == want
    with pytest.raises(ValueError):
        util.get_host_assignments(util.parse_hosts("a:1"), 2)


def test_host_assignments_layout():
    slots = util.get_host_assignments(util.parse_hosts("a:2,b:2"), 3)
    assert [(s.hostname, s.rank, s.local_rank, s.cross_rank)
            for s in slots] == [("a", 0, 0, 0), ("a", 1, 1, 0),
                                ("b", 2, 0, 1)]
    assert all(s.cross_size == 2 for s in slots)
    assert slots[2].local_size == 1


@impls
def test_local_hosts_and_controller_addr(impl):
    _, u = IMPLS[impl]
    assert u.is_local_host("localhost") and u.is_local_host("127.0.0.1")
    assert u.is_local_host(socket.gethostname())
    assert not u.is_local_host("node-that-is-not-here")
    assert u.resolvable_addr_for(u.parse_hosts("localhost:2")) == \
        "127.0.0.1"
    assert 0 < u.free_port() < 65536


# ---- parse_args and the HOROVOD_* environment ----------------------------

ARGVS = {
    "knobs": ["-np", "2", "--fusion-threshold-mb", "32", "--cycle-time-ms",
              "5", "--timeline-filename", "/tmp/t.json", "--no-stall-check",
              "--log-level", "DEBUG", "python", "train.py"],
    "all": ["-np", "4", "-H", "a:2,b:2", "--fusion-threshold-mb", "0.5",
            "--cycle-time-ms", "2.5", "--cache-capacity", "0",
            "--timeline-filename", "tl.json", "--timeline-mark-cycles",
            "--stall-check-warning-time-seconds", "30", "--log-level",
            "INFO", "--autotune", "--autotune-log-file", "at.csv",
            "--hierarchical-allreduce", "--cross-plane", "hier",
            "--network-interface", "eth0,eth1", "--", "python", "t.py",
            "--flag"],
    "none": ["-np", "1", "python", "x.py"],
    "elastic": ["--min-np", "2", "--max-np", "4", "--host-discovery-script",
                "./d.sh", "--slots", "2", "python", "x.py"],
    "mpi": ["-np", "2", "--mpi", "--mpi-args", "-mca btl tcp", "--",
            "python", "t.py"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_env_from_args_matches_reference(case, monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS", "7")
    port = launch.parse_args(ARGVS[case])
    ref = ref_launch.parse_args(ARGVS[case])
    assert launch.env_from_args(port) == ref_launch.env_from_args(ref)
    for key in ("np", "command", "min_np", "max_np", "hosts", "mpi",
                "mpi_args", "start_timeout", "slots"):
        assert getattr(port, key) == getattr(ref, key), key
    assert launch.is_elastic(port) == ref_launch.is_elastic(ref)
    assert launch.run_controller(port) == ref_launch.run_controller(ref)


def test_env_from_args_values():
    env = launch.env_from_args(launch.parse_args(ARGVS["knobs"]))
    assert env["HOROVOD_FUSION_THRESHOLD"] == str(32 * 1024 * 1024)
    assert env["HOROVOD_CYCLE_TIME"] == "5.0"
    assert env["HOROVOD_TIMELINE"] == "/tmp/t.json"
    assert env["HOROVOD_STALL_CHECK_DISABLE"] == "1"
    assert env["HOROVOD_LOG_LEVEL"] == "DEBUG"
    env = launch.env_from_args(launch.parse_args(ARGVS["all"]))
    # Exported for parity; nothing in either package reads it.
    assert env["HOROVOD_GLOO_IFACE"] == "eth0,eth1"
    assert env["HOROVOD_CROSS_PLANE"] == "hier"


@pytest.mark.parametrize("argv", [["python", "x.py"], ["-np", "2"]])
def test_parse_args_refuses_like_reference(argv):
    for mod in (launch, ref_launch):
        with pytest.raises(SystemExit):
            mod.parse_args(argv)


def test_tpu_pod_is_refused_for_local_cards():
    with pytest.raises(SystemExit):
        launch.parse_args(["--tpu-pod", "python", "x.py"])
    args = launch.parse_args(["--local-cards", "python", "x.py"])
    assert args.np is None and args.local_cards


def test_version_is_setup_py_s():
    from horovod_tpu.version import __version__ as ref_version
    from horovod_tpu_torch.version import __version__

    setup = (os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
             + "/setup.py")
    assert f'version="{__version__}"' in open(setup).read()
    assert __version__ == ref_version


# ---- the config file -----------------------------------------------------

CONFIGS = {
    "knobs": "fusion-threshold-mb: 8\nlog-level: INFO\n",
    "types": textwrap.dedent("""\
        ---
        # a comment line
        fusion-threshold-mb: 0.25   # trailing comment
        cycle-time-ms: 3
        cache-capacity: -1
        autotune: true
        no-stall-check: false
        timeline-filename: /tmp/tl.json
        autotune-log-file: 'a b.csv'
        cross-plane: "ring"
        log-level: WARNING
        network-interface: eth0,eth1
        stall-check-warning-time-seconds: 1.5e+1
        unknown-knob: ~
        verbose: True
        """),
    "quoted": "timeline-filename: 'it''s # here'\nlog-level: \"ERROR\"\n",
    "empty": "",
    "comments": "# nothing but comments\n\n   # indented comment\n",
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_config_reader_matches_yaml(case, tmp_path):
    f = tmp_path / "cfg.yaml"
    f.write_text(CONFIGS[case])
    got = launch.read_config(str(f))
    want = yaml.safe_load(CONFIGS[case]) or {}
    assert got == want
    assert [type(v) for v in got.values()] == \
        [type(v) for v in want.values()]


@pytest.mark.parametrize("case", ["knobs", "types"])
def test_config_file_matches_reference(case, tmp_path):
    f = tmp_path / "cfg.yaml"
    f.write_text(CONFIGS[case])
    argv = ["-np", "1", "--config-file", str(f), "--log-level", "DEBUG",
            "python", "x.py"]
    port, ref = launch.parse_args(argv), ref_launch.parse_args(argv)
    env = launch.env_from_args(port)
    assert env == ref_launch.env_from_args(ref)
    assert env["HOROVOD_LOG_LEVEL"] == "DEBUG"   # the flag wins
    assert port.verbose == ref.verbose


@pytest.mark.parametrize("text", [
    "outer:\n  inner: 1\n",                 # nested mapping
    "hosts:\n  - a\n  - b\n",               # block list
    "hosts: [a, b]\n",                      # flow list
    "knobs: {a: 1}\n",                      # flow mapping
    "- a\n- b\n",                           # a list document
    "a: &x 1\nb: *x\n",                     # anchor and alias
    "a: !!str 1\n",                         # tag
    "a: |\n  text\n",                       # block scalar
    "a: yes\n",                             # YAML 1.1's other booleans
    "a: 0x10\n", "a: 017\n", "a: 1_000\n", "a: 1e5\n", "a: .inf\n",
    "a: 1:20\n",                            # other number forms
    "a: 1\na: 2\n",                         # a duplicate key
    "a: b: c\n",                            # a colon-space in a value
    "just text\n",                          # not key: value
    "a: \"esc\\n\"\n",                      # an escape
])
def test_config_reader_raises_rather_than_guess(text, tmp_path):
    f = tmp_path / "cfg.yaml"
    f.write_text(text)
    with pytest.raises(ValueError):
        launch.read_config(str(f))


# ---- command lines -------------------------------------------------------

def test_ssh_wrap_matches_reference():
    slot = util.SlotInfo("remotehost", 1, 0, 1, 2, 1, 2)
    ref_slot = ref_util.SlotInfo("remotehost", 1, 0, 1, 2, 1, 2)
    env = {"HOROVOD_RANK": "1", "HOROVOD_TIMELINE": "a b.json"}
    for port_in, identity in ((2222, "/id_rsa"), (None, None)):
        cmd = launch._ssh_wrap(slot, env, ["python", "t.py"], port_in,
                               identity)
        assert cmd == ref_launch._ssh_wrap(ref_slot, env, ["python", "t.py"],
                                           port_in, identity)
    assert cmd[0] == "ssh" and "remotehost" in cmd
    assert "HOROVOD_RANK=1" in cmd[-1]


MPI_ENV = {"HOROVOD_FUSION_THRESHOLD": "1", "PATH": "/bin", "HOME": "/home/u",
           "PYTHONPATH": "/repo", "NCCL_DEBUG": "INFO",
           "LD_LIBRARY_PATH": "/lib"}


@pytest.mark.parametrize("flavor", ["openmpi", "spectrum", "mpich", "impi"])
def test_build_mpi_command_matches_reference(flavor):
    from horovod_tpu.runner import mpi_run as ref_mpi
    from horovod_tpu_torch.runner import mpi_run

    for hosts, extra, ssh in (("h1:2,h2:2", None, 2222),
                              ("h1:2", "-mca btl tcp --oversubscribe", None)):
        got = mpi_run.build_mpi_command(
            4, util.parse_hosts(hosts), ["python", "train.py"], MPI_ENV,
            flavor=flavor, ssh_port=ssh, extra_mpi_args=extra)
        want = ref_mpi.build_mpi_command(
            4, ref_util.parse_hosts(hosts), ["python", "train.py"], MPI_ENV,
            flavor=flavor, ssh_port=ssh, extra_mpi_args=extra)
        assert got == want
    assert got[0] == "mpirun" and got[-2:] == ["python", "train.py"]


@pytest.mark.parametrize("text", ["mpirun (Open MPI) 4.1.4",
                                  "HYDRA build details:",
                                  "Intel(R) MPI Library",
                                  "IBM Spectrum MPI", "???",
                                  "mpiexec (OpenRTE) 2.1.1"])
def test_detect_mpi_flavor_matches_reference(text):
    from horovod_tpu.runner.mpi_run import detect_mpi_flavor as ref_detect
    from horovod_tpu_torch.runner.mpi_run import detect_mpi_flavor

    assert detect_mpi_flavor(text) == ref_detect(text)


def test_mpi_run_without_mpirun_raises(monkeypatch):
    from horovod_tpu_torch.runner import mpi_run

    monkeypatch.setenv("PATH", "/nonexistent")
    assert not mpi_run.mpi_available()
    args = launch.parse_args(ARGVS["mpi"])
    with pytest.raises(RuntimeError, match="mpirun"):
        mpi_run.mpi_run(args, {})


@pytest.mark.parametrize("mcpu", ["batch 1 c1 4 c2 4", "c1 8",
                                  "batch 1 c1 2 c2 2 c3 2"])
def test_lsf_matches_reference(mcpu):
    from horovod_tpu.runner import js_run as ref_js
    from horovod_tpu_torch.runner import js_run

    env = {"LSB_JOBID": "1", "LSB_MCPU_HOSTS": mcpu}
    assert js_run.LSFUtils.using_lsf(env)
    assert _rows(js_run.LSFUtils.get_compute_hosts(env)) == \
        _rows(ref_js.LSFUtils.get_compute_hosts(env))
    assert js_run.LSFUtils.get_num_processes(env) == \
        ref_js.LSFUtils.get_num_processes(env)
    for extra in (None, "--smpiargs=-gpu"):
        assert js_run.build_js_command(2, 4, ["python", "t.py"], extra) == \
            ref_js.build_js_command(2, 4, ["python", "t.py"], extra)


@pytest.mark.parametrize("argv,lsf", [
    (["-np", "2", "--mpi", "--", "p"], False),
    (["-np", "2", "--", "p"], False),
    (["-np", "2", "--js", "--", "p"], False),
    (["--", "p"], True),
    (["-np", "2", "--gloo", "--", "p"], True),
    (["-np", "2", "-H", "a:2", "--", "p"], True),
])
def test_run_controller_matches_reference(argv, lsf, monkeypatch, tmp_path):
    from horovod_tpu_torch.runner import js_run

    if lsf:
        monkeypatch.setenv("LSB_JOBID", "7")
        jsrun = tmp_path / "jsrun"
        jsrun.write_text("#!/bin/sh\n")
        jsrun.chmod(0o755)
        monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
        assert js_run.js_available()
    else:
        monkeypatch.delenv("LSB_JOBID", raising=False)
    port, ref = launch.parse_args(argv), ref_launch.parse_args(argv)
    assert launch.run_controller(port) == ref_launch.run_controller(ref)


def test_run_controller_refusals():
    with pytest.raises(ValueError):
        launch.run_controller(launch.parse_args(
            ["-np", "2", "--mpi", "--js", "--", "p"]))
    with pytest.raises(ValueError, match="elastic"):
        launch.run_controller(launch.parse_args(
            ["--min-np", "1", "--mpi", "--", "p"]))


# ---- NIC discovery -------------------------------------------------------

@pytest.mark.parametrize("driver_impl,task_impl", [
    ("port", "port"), ("port", "ref"), ("ref", "port")])
def test_nic_discovery_roundtrip(driver_impl, task_impl):
    from horovod_tpu.runner import driver_service as ref_driver
    from horovod_tpu.runner import task_service as ref_task
    from horovod_tpu_torch.runner import driver_service, task_service

    drivers = {"port": driver_service, "ref": ref_driver}
    tasks = {"port": task_service, "ref": ref_task}
    driver = drivers[driver_impl].HorovodRunDriverService(3)
    services = [tasks[task_impl].HorovodRunTaskService(
        i, driver.addresses, driver.key) for i in range(3)]
    try:
        import threading

        threads = [threading.Thread(target=t.run_discovery, args=(30,),
                                    daemon=True) for t in services]
        for t in threads:
            t.start()
        driver.wait_for_initial_registration(30)
        driver.wait_for_probe_results(30)
        for t in threads:
            t.join(30)
        common = driver.get_common_interfaces()
    finally:
        for t in services:
            t.shutdown()
        driver.shutdown()
    assert set(common) == {0, 1, 2}
    for idx, addrs in common.items():
        assert addrs, f"no common interface found for task {idx}"


def test_discover_common_interfaces():
    from horovod_tpu_torch.runner.task_service import (
        HorovodRunTaskService,
        discover_common_interfaces,
    )

    def spawn(driver):
        return [HorovodRunTaskService(i, driver.addresses, driver.key)
                for i in range(2)]

    common = discover_common_interfaces(2, spawn, timeout=30)
    assert set(common) == {0, 1} and all(common.values())


def test_driver_drops_a_bad_hmac():
    from horovod_tpu_torch.runner.driver_service import (
        HorovodRunDriverService,
        send_msg,
        sign,
    )

    driver = HorovodRunDriverService(1)
    try:
        with socket.create_connection(driver.addresses, timeout=5) as s:
            send_msg(s, {"type": "register", "index": 0, "host": "x",
                         "addrs": []}, "wrong-key")
            f = s.makefile("rb")
            assert f.readline() == b""  # dropped, no ack
        assert driver._registered == {}
        with socket.create_connection(driver.addresses, timeout=5) as s:
            send_msg(s, {"type": "register", "index": 0, "host": "x",
                         "addrs": []}, driver.key)
            assert b"ack" in s.makefile("rb").read()
        assert set(driver._registered) == {0}
    finally:
        driver.shutdown()
    from horovod_tpu.runner.driver_service import sign as ref_sign

    assert sign("k", b"payload") == ref_sign("k", b"payload")


# ---- the slots' environment and --local-cards ----------------------------

def test_slot_env_matches_reference_and_binds_no_card():
    for hosts, np in (("localhost:4", 4), ("a:2,b:2", 3)):
        slots = util.get_host_assignments(util.parse_hosts(hosts), np)
        ref_slots = ref_util.get_host_assignments(
            ref_util.parse_hosts(hosts), np)
        for s, r in zip(slots, ref_slots):
            got = launch._slot_env(s, "10.0.0.1", 1234)
            assert got == ref_launch._slot_env(r, "10.0.0.1", 1234,
                                               tpu_pod=False)
            assert "CUDA_VISIBLE_DEVICES" not in got


def _capture_launch(monkeypatch, argv, cards):
    """run_launcher with the ranks' execution captured, the card count
    ``cards``: (rc, [(cmd, env)] by rank)."""
    from horovod_tpu_torch.runner import safe_shell_exec

    seen = {}

    def execute(cmd, env=None, prefix=None, events=None, **kw):
        seen[int(env["HOROVOD_RANK"])] = (cmd, env)
        return 0

    monkeypatch.setattr(safe_shell_exec, "execute", execute)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    rc = launch.run_launcher(launch.parse_args(argv))
    return rc, [seen[r] for r in sorted(seen)]


def test_local_cards_one_rank_a_card(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    rc, ranks = _capture_launch(monkeypatch,
                                ["--local-cards", "python", "t.py"], 2)
    assert rc == 0 and len(ranks) == 2
    for r, (cmd, env) in enumerate(ranks):
        assert cmd == ["python", "t.py"]
        assert env["HOROVOD_LOCAL_RANK"] == str(r)
        assert env["HOROVOD_SIZE"] == env["HOROVOD_LOCAL_SIZE"] == "2"
        # The launcher's own visibility, never a rank's own.
        assert env["CUDA_VISIBLE_DEVICES"] == "3,5"
        assert env["HOROVOD_START_TIMEOUT"] == "60"
    assert not torch.cuda.is_initialized()


def test_local_cards_np_given(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    rc, ranks = _capture_launch(
        monkeypatch, ["--local-cards", "-np", "3", "--start-timeout", "9",
                      "python", "t.py"], 8)
    assert rc == 0 and len(ranks) == 3
    assert all("CUDA_VISIBLE_DEVICES" not in env for _, env in ranks)
    assert all(env["HOROVOD_START_TIMEOUT"] == "9" for _, env in ranks)


def test_local_cards_without_a_card_raises(monkeypatch):
    with pytest.raises(SystemExit, match="no CUDA card"):
        _capture_launch(monkeypatch, ["--local-cards", "python", "t.py"], 0)


def test_check_build_rows(capsys):
    rows = dict(launch.check_build_rows())
    labels = [label for section in rows.values() for _, label in section]
    assert list(rows) == ["Available Frameworks", "Available Controllers",
                          "Available Tensor Operations"]
    flat = " ".join(labels)
    for absent in ("JAX", "TensorFlow", "MXNet", "TPU", "XLA"):
        assert absent not in flat
    ops = {label.split()[0]: ok for ok, label in
           rows["Available Tensor Operations"]}
    assert ops["gloo"] is True
    assert ops["CUDA"] == ops["NCCL"] == torch.cuda.is_available()
    controllers = dict((label, ok) for ok, label in
                       rows["Available Controllers"])
    import importlib.util

    assert controllers["MPI bootstrap (mpi4py)"] == (
        importlib.util.find_spec("mpi4py") is not None)
    assert controllers["TCP rendezvous (TCPStore)"] is True
    with pytest.raises(SystemExit) as e:
        launch.parse_args(["--check-build"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("horovod_tpu_torch v")
    assert f"[X] PyTorch {torch.__version__}" in out
    assert "[X] gloo" in out
