"""``horovodrun-torch``: the port's launcher.

The port's own copy of ``horovod_tpu/runner/launch.py``: the rank layout
from ``-np``/``-H``/``--hostfile``, the ``HOROVOD_*`` environment
contract (the same keys and values as the reference's for the same
arguments), one process a slot (ssh for a remote host), rank-prefixed
output, and the job torn down when a rank fails: every other rank's
process group is killed (``safe_shell_exec``) and the launcher exits 1.
``--mpi`` and ``--js`` hand the processes to ``mpirun``/``jsrun``
(``mpi_run.py``, ``js_run.py``), and ``--min-np``/``--max-np``/
``--host-discovery-script`` run the job under the port's
``ElasticDriver``.

Where the reference binds TPU chips (``--tpu-pod``), the port has
``--local-cards``: one rank a local CUDA card, ``-np`` defaulting to
``torch.cuda.device_count()`` (which honours the launcher's own
``CUDA_VISIBLE_DEVICES``). No rank gets a visibility of its own: the
lane opens ``cuda:{local_rank}`` (``common/basics.py``), which a
per-rank ``CUDA_VISIBLE_DEVICES`` of one card would make not exist.

``--config-file`` takes the reference's flat ``key: value`` file; the
port reads it itself (:func:`read_config`), since it imports no YAML
library. ``--check-build`` prints what the port can use here.

Run: ``python -m horovod_tpu_torch.runner.launch -np 2 python train.py``
(``hvd.init(device="cpu")`` in the script on a machine with no card), or
``horovodrun-torch --local-cards python train.py`` on a card host.
"""

import argparse
import os
import re
import shlex
import signal
import sys
import threading

from horovod_tpu_torch.runner import safe_shell_exec, util
from horovod_tpu_torch.version import __version__


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="horovodrun-torch",
        description="Launch a horovod_tpu_torch distributed job.")
    p.add_argument("-v", "--version", action="version", version=__version__)
    p.add_argument("-np", "--num-proc", type=int, dest="np", required=False,
                   help="total number of processes")
    p.add_argument("-H", "--hosts", dest="hosts",
                   help="host1:slots,host2:slots (default: localhost:np)")
    p.add_argument("--hostfile", help="file with one 'host slots=N' per line")
    p.add_argument("-p", "--ssh-port", type=int, default=None)
    p.add_argument("--ssh-identity-file", default=None)
    p.add_argument("--network-interface", dest="nics", default=None)
    p.add_argument("--start-timeout", type=int, default=60,
                   help="seconds to wait for ranks to register")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--check-build", action="store_true",
                   help="print available frameworks/controllers/"
                        "tensor-operation backends and exit")
    p.add_argument("--local-cards", action="store_true",
                   help="one rank per local CUDA card (-np defaults to "
                        "their count); rank r takes cuda:{local_rank}")
    p.add_argument("--tpu-pod", action="store_true",
                   help="the reference's chip binding: refused here, "
                        "use --local-cards")
    p.add_argument("--gloo", action="store_true",
                   help="force the built-in launcher (default)")
    p.add_argument("--mpi", action="store_true",
                   help="delegate process management to mpirun")
    p.add_argument("--mpi-args", default=None,
                   help="extra arguments appended to the mpirun cmdline")
    p.add_argument("--js", action="store_true",
                   help="launch with jsrun (LSF clusters)")
    p.add_argument("--js-args", default=None,
                   help="extra arguments appended to the jsrun cmdline")
    p.add_argument("--min-np", type=int, default=None,
                   help="elastic: keep training while >= this many workers")
    p.add_argument("--max-np", type=int, default=None,
                   help="elastic: never run more than this many workers")
    p.add_argument("--host-discovery-script", default=None,
                   help="elastic: executable printing current host:slots "
                        "lines; polled for topology changes")
    p.add_argument("--slots", type=int, default=1,
                   help="elastic: default slots per discovered host")
    p.add_argument("--elastic-poll-interval", type=float, default=2.0,
                   help="elastic: seconds between discovery polls")
    p.add_argument("--fusion-threshold-mb", type=float, default=None)
    p.add_argument("--cycle-time-ms", type=float, default=None)
    p.add_argument("--cache-capacity", type=int, default=None)
    p.add_argument("--timeline-filename", default=None)
    p.add_argument("--timeline-mark-cycles", action="store_true")
    p.add_argument("--no-stall-check", action="store_true")
    p.add_argument("--stall-check-warning-time-seconds", type=float,
                   default=None)
    p.add_argument("--log-level", default=None,
                   choices=["TRACE", "DEBUG", "INFO", "WARNING", "ERROR",
                            "FATAL"])
    p.add_argument("--autotune", action="store_true")
    p.add_argument("--autotune-log-file", default=None)
    p.add_argument("--hierarchical-allreduce", action="store_true",
                   help="legacy spelling of --cross-plane hier")
    p.add_argument("--cross-plane", default=None,
                   choices=["auto", "ici", "ring", "hier"],
                   help="plane selection for collectives "
                        "(HOROVOD_CROSS_PLANE)")
    p.add_argument("--config-file", default=None,
                   help="flat 'key: value' file of the above knobs")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="program and args to launch on every rank")
    args = p.parse_args(argv)
    if args.config_file:
        _apply_config_file(args)
    if args.check_build:
        _print_check_build()
        raise SystemExit(0)
    if args.tpu_pod:
        p.error("--tpu-pod binds TPU chips; the port runs one rank per "
                "CUDA card with --local-cards")
    if not args.command:
        p.error("no command given")
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if args.min_np or args.max_np or args.host_discovery_script:
        if args.np is None:
            args.np = args.min_np
        if args.min_np is None:
            args.min_np = args.np
        if args.np is None:
            p.error("elastic mode needs -np or --min-np")
    elif args.np is None and not args.local_cards and not (
            args.js or "LSB_JOBID" in os.environ):
        # jsrun derives np from the LSF allocation (LSB_MCPU_HOSTS).
        p.error("-np is required (or use --local-cards)")
    return args


def is_elastic(args):
    return bool(args.min_np or args.max_np or args.host_discovery_script)


# ---- the config file: a flat 'key: value' mapping -----------------------

_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_-]*$")
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?$")
# Plain scalars YAML would read as something the reader does not take:
# other number forms (hex, octal, underscores, exponents without a
# sign or a dot, sexagesimal, .inf/.nan), YAML 1.1's other booleans,
# and what starts a tag, anchor, alias, block scalar, directive,
# collection or quoted string.
_AMBIGUOUS = re.compile(
    r"([-+]?[0-9._:]*[0-9][0-9a-zA-Z._:+-]*|[-+]?\.(inf|Inf|INF|nan|NaN|NAN)"
    r"|y|Y|yes|Yes|YES|n|N|no|No|NO|on|On|ON|off|Off|OFF|=|<<)$")
_INDICATORS = tuple("[]{}&*!|>'\"%@`,?:-#")
_TRUE, _FALSE = ("true", "True", "TRUE"), ("false", "False", "FALSE")
_NULL = ("", "~", "null", "Null", "NULL")


def _strip_comment(line):
    """The line without a comment: '#' at its start or after a space,
    outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text, where):
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if len(text) >= 2 and text[0] == text[-1] == "'":
        body = text[1:-1]
        if "'" in body.replace("''", ""):
            raise ValueError(f"{where}: unbalanced quote in {text!r}")
        return body.replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        body = text[1:-1]
        if "\\" in body or '"' in body:
            raise ValueError(f"{where}: escapes in a double-quoted value "
                             f"are not read: {text!r}")
        return body
    if _AMBIGUOUS.match(text) or text.startswith(_INDICATORS) \
            or ": " in text or text.endswith(":") or " #" in text:
        raise ValueError(f"{where}: the value {text!r} is not a plain "
                         "int, float, true/false or string")
    return text


def read_config(path):
    """The reference's config file (``yaml.safe_load`` of a flat
    mapping) without a YAML library: ``key: value`` lines, ``#``
    comments, ints, floats, ``true``/``false``, ``null``/``~`` and plain
    or quoted strings, an optional leading ``---``. Anything else, a
    nested mapping or a list above all, raises ``ValueError``: the
    reader never guesses what YAML would have made of it."""
    cfg = {}
    started = False
    with open(path) as f:
        lines = f.read().splitlines()
    for n, raw in enumerate(lines, 1):
        where = f"{path}:{n}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line == "---" and not started and not cfg:
            started = True
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: nested or indented content is not "
                             f"read (a flat 'key: value' file): {raw!r}")
        key, sep, value = line.partition(":")
        if not sep or (value and value[0] not in " \t"):
            raise ValueError(f"{where}: not a 'key: value' line: {raw!r}")
        key = key.strip()
        if not _KEY.match(key):
            raise ValueError(f"{where}: unsupported key {key!r}")
        if key in cfg:
            raise ValueError(f"{where}: duplicate key {key!r}")
        cfg[key] = _scalar(value.strip(), where)
    return cfg


def _apply_config_file(args):
    """The config file's knobs; the command line takes precedence."""
    for key, value in read_config(args.config_file).items():
        attr = key.replace("-", "_")
        if hasattr(args, attr) and getattr(args, attr) in (None, False):
            setattr(args, attr, value)


def env_from_args(args):
    """The ``HOROVOD_*`` tuning environment, as the reference's."""
    env = {}
    if args.fusion_threshold_mb is not None:
        env["HOROVOD_FUSION_THRESHOLD"] = str(
            int(args.fusion_threshold_mb * 1024 * 1024))
    if args.cycle_time_ms is not None:
        env["HOROVOD_CYCLE_TIME"] = str(args.cycle_time_ms)
    if args.cache_capacity is not None:
        env["HOROVOD_CACHE_CAPACITY"] = str(args.cache_capacity)
    if args.timeline_filename:
        env["HOROVOD_TIMELINE"] = args.timeline_filename
    if args.timeline_mark_cycles:
        env["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
    if args.no_stall_check:
        env["HOROVOD_STALL_CHECK_DISABLE"] = "1"
    if args.stall_check_warning_time_seconds is not None:
        env["HOROVOD_STALL_CHECK_TIME"] = str(
            args.stall_check_warning_time_seconds)
    if args.log_level:
        env["HOROVOD_LOG_LEVEL"] = args.log_level
    if args.autotune:
        env["HOROVOD_AUTOTUNE"] = "1"
    if args.autotune_log_file:
        env["HOROVOD_AUTOTUNE_LOG"] = args.autotune_log_file
    if os.environ.get("HOROVOD_AUTOTUNE_STEPS"):
        # Not a flag, but it must still reach remote (ssh) ranks.
        env["HOROVOD_AUTOTUNE_STEPS"] = os.environ["HOROVOD_AUTOTUNE_STEPS"]
    if args.hierarchical_allreduce:
        env["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    if args.cross_plane:
        env["HOROVOD_CROSS_PLANE"] = args.cross_plane
    if args.nics:
        # Exported as the reference does; nothing in either package
        # reads it.
        env["HOROVOD_GLOO_IFACE"] = args.nics
    return env


def check_build_rows():
    """``(section, [(available, label)])`` of what the port can use on
    this machine, probed live (``common/capabilities.py probe``, which
    the torch frontend's ``hvd.nccl_built()`` and the rest read too)."""
    from horovod_tpu_torch.common import capabilities
    from horovod_tpu_torch.ops import _build

    caps = capabilities.probe()
    nccl_version = (" " + capabilities.nccl_version_string()
                    if caps["nccl"] else "")
    built = sum(_build._library_path(n).exists() for n in _build.SOURCES)
    try:
        nvcc = bool(_build._nvcc())
    except RuntimeError:
        nvcc = False
    return [
        ("Available Frameworks", [
            (True, f"PyTorch {caps['torch_version']}")]),
        ("Available Controllers", [
            (caps["tcp_store"], "TCP rendezvous (TCPStore)"),
            (caps["mpi4py"], "MPI bootstrap (mpi4py)")]),
        ("Available Tensor Operations", [
            (caps["gloo"], "gloo"),
            (caps["nccl"], f"NCCL{nccl_version}"),
            (caps["cuda"], f"CUDA {caps['cuda_version']}".rstrip()),
            (nvcc, "nvcc (the Hopper kernels can be built)"),
            (built == len(_build.SOURCES),
             f"kernel libraries built: {built} of {len(_build.SOURCES)}")]),
    ]


def _print_check_build():
    """``--check-build``: what this machine gives the port."""
    box = lambda v: "[X]" if v else "[ ]"  # noqa: E731
    print(f"horovod_tpu_torch v{__version__}:")
    for section, rows in check_build_rows():
        print(f"\n{section}:")
        for ok, label in rows:
            print(f"    {box(ok)} {label}")


def _local_cards_np():
    """``--local-cards``' rank count: the CUDA cards this process sees.
    Raises when there is none; never launches CPU ranks. The count
    creates no CUDA context (the ranks are exec'd anyway)."""
    import torch

    n = torch.cuda.device_count()
    if n < 1:
        raise SystemExit("horovodrun-torch: --local-cards found no CUDA "
                         "card on this machine")
    return n


def _slot_env(slot, controller_addr, controller_port):
    """A slot's identity, controller and ``OMPI_COMM_WORLD_*`` alias
    variables, as the reference's. ``--local-cards`` adds nothing: the
    lane takes ``cuda:{local_rank}`` itself, and no rank is given a
    ``CUDA_VISIBLE_DEVICES`` of its own."""
    return {
        "HOROVOD_RANK": str(slot.rank),
        "HOROVOD_SIZE": str(slot.size),
        "HOROVOD_LOCAL_RANK": str(slot.local_rank),
        "HOROVOD_LOCAL_SIZE": str(slot.local_size),
        "HOROVOD_CROSS_RANK": str(slot.cross_rank),
        "HOROVOD_CROSS_SIZE": str(slot.cross_size),
        "HOROVOD_CONTROLLER_ADDR": controller_addr,
        "HOROVOD_CONTROLLER_PORT": str(controller_port),
        "OMPI_COMM_WORLD_RANK": str(slot.rank),
        "OMPI_COMM_WORLD_SIZE": str(slot.size),
        "OMPI_COMM_WORLD_LOCAL_RANK": str(slot.local_rank),
    }


def _ssh_wrap(slot, command_env, command, ssh_port, identity_file):
    """The ssh command line of a remote slot."""
    exports = " ".join(f"{k}={shlex.quote(v)}"
                       for k, v in sorted(command_env.items()))
    ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        ssh += ["-p", str(ssh_port)]
    if identity_file:
        ssh += ["-i", identity_file]
    remote = f"cd {shlex.quote(os.getcwd())} && env {exports} " \
             f"{' '.join(shlex.quote(c) for c in command)}"
    return ssh + [slot.hostname, remote]


def _hosts(args):
    return (util.parse_hostfile(args.hostfile) if args.hostfile
            else util.parse_hosts(args.hosts or f"localhost:{args.np}"))


def run_elastic(args):
    """The elastic launch: the port's driver, discovery and rendezvous
    instead of a static slot layout."""
    from horovod_tpu_torch.runner.elastic.discovery import (
        FixedHosts,
        HostDiscoveryScript,
    )
    from horovod_tpu_torch.runner.elastic.driver import ElasticDriver

    if args.host_discovery_script:
        discovery = HostDiscoveryScript(args.host_discovery_script,
                                        default_slots=args.slots)
    else:
        discovery = FixedHosts({h.hostname: h.slots for h in _hosts(args)})
    driver = ElasticDriver(
        discovery, args.command, min_np=args.min_np,
        max_np=args.max_np or args.np, poll_interval=args.elastic_poll_interval,
        start_timeout=args.start_timeout, env=env_from_args(args),
        verbose=args.verbose)
    driver.start()
    try:
        return driver.wait_for_completion()
    finally:
        driver.stop()


def run_controller(args):
    """The launch backend: an explicit flag wins, an LSF allocation
    implies jsrun, else the built-in launcher."""
    from horovod_tpu_torch.runner.js_run import LSFUtils, js_available

    if args.mpi and args.js:
        raise ValueError("--mpi and --js are mutually exclusive")
    if is_elastic(args):
        if args.mpi or args.js:
            raise ValueError(
                "elastic mode needs the built-in launcher (worker respawn "
                "is driven by the elastic driver, not mpirun/jsrun)")
        return "gloo"
    if args.mpi:
        return "mpi"
    if args.js or (not args.gloo and LSFUtils.using_lsf() and js_available()
                   and not args.hosts and not args.hostfile):
        return "js"
    return "gloo"


def run_launcher(args):
    if args.local_cards and args.np is None:
        args.np = _local_cards_np()
    controller = run_controller(args)
    if args.np is None and controller != "js":
        raise SystemExit(
            "horovodrun-torch: -np is required (only jsrun mode can derive "
            "the process count from the LSF allocation)")
    if controller == "mpi":
        from horovod_tpu_torch.runner.mpi_run import mpi_run

        return mpi_run(args, env_from_args(args))
    if controller == "js":
        from horovod_tpu_torch.runner.js_run import js_run

        return js_run(args, env_from_args(args))
    if is_elastic(args):
        return run_elastic(args)
    hosts = _hosts(args)
    slots = util.get_host_assignments(hosts, args.np)
    controller_addr = util.resolvable_addr_for(hosts)
    controller_port = util.free_port()
    knob_env = env_from_args(args)

    if args.verbose:
        print(f"[horovodrun-torch] np={args.np} hosts="
              f"{[(h.hostname, h.slots) for h in hosts]} "
              f"controller={controller_addr}:{controller_port}",
              file=sys.stderr)

    failure = threading.Event()
    rcs = [None] * args.np

    def launch_slot(slot):
        local = util.is_local_host(slot.hostname)
        env = dict(os.environ)
        env.update(knob_env)
        slot_env = _slot_env(slot, controller_addr, controller_port)
        env.update(slot_env)
        env.setdefault("HOROVOD_START_TIMEOUT", str(args.start_timeout))
        if local:
            cmd = list(args.command)
        else:
            cmd = _ssh_wrap(slot, {**knob_env, **slot_env}, args.command,
                            args.ssh_port, args.ssh_identity_file)
        rc = safe_shell_exec.execute(
            cmd, env=env, prefix=f"[{slot.rank}]<out>: ".encode()
            if args.verbose else b"", events=[failure])
        rcs[slot.rank] = rc
        if rc != 0:
            failure.set()

    threads = [threading.Thread(target=launch_slot, args=(s,), daemon=True)
               for s in slots]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
    except BaseException:
        # Interrupted (SIGINT, or SIGTERM through main()): take every
        # rank's process group down before leaving.
        failure.set()
        for t in threads:
            t.join(safe_shell_exec.GRACEFUL_TERMINATION_TIME_S + 5)
        raise

    bad = [(r, rc) for r, rc in enumerate(rcs) if rc != 0]
    if bad:
        print(f"[horovodrun-torch] ranks failed: {bad}", file=sys.stderr)
        return 1
    return 0


def run_commandline(argv=None):
    return run_launcher(parse_args(argv))


def _exit_on_sigterm(signum, frame):
    raise SystemExit(128 + signum)


def main():
    # SIGTERM unwinds like SIGINT, so that the ranks go down with the
    # launcher (run_launcher, ElasticDriver.stop) instead of outliving it.
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
