"""The LSF/jsrun launch path.

The port's own copy of ``horovod_tpu/runner/js_run.py`` (``LSFUtils:17``,
``js_available:43``, ``build_js_command:49``, ``js_run:63``): on an LSF
cluster the allocation (hosts x slots) comes from the scheduler's
environment (``LSB_MCPU_HOSTS``), and ``jsrun`` starts the processes.
"""

import os
import shlex
import subprocess
import sys

from horovod_tpu_torch.runner import util


class LSFUtils:
    """The LSF allocation, read from the environment."""

    @staticmethod
    def using_lsf(env=None):
        return "LSB_JOBID" in (env or os.environ)

    @staticmethod
    def get_compute_hosts(env=None):
        """Parse LSB_MCPU_HOSTS ('host1 16 host2 16 ...'), dropping the
        launch node (first entry is the batch host)."""
        env = env or os.environ
        mcpu = env.get("LSB_MCPU_HOSTS", "")
        toks = mcpu.split()
        pairs = [(toks[i], int(toks[i + 1])) for i in range(0, len(toks) - 1, 2)]
        # The batch (launch) host is dropped when compute hosts exist.
        if len(pairs) > 1:
            pairs = pairs[1:]
        return [util.HostInfo(h, s) for h, s in pairs]

    @staticmethod
    def get_num_processes(env=None):
        return sum(h.slots for h in LSFUtils.get_compute_hosts(env))


def js_available(env=None):
    from shutil import which

    return which("jsrun", path=(env or os.environ).get("PATH")) is not None


def build_js_command(num_hosts, tasks_per_host, command, extra_args=None):
    """The jsrun command line: one resource set a host, holding all of
    that host's ranks."""
    cmd = ["jsrun", "--nrs", str(max(num_hosts, 1)),
           "--tasks_per_rs", str(tasks_per_host),
           "--cpu_per_rs", "ALL_CPUS", "--gpu_per_rs", "ALL_GPUS",
           "--rs_per_host", "1"]
    if extra_args:
        cmd += shlex.split(extra_args)
    cmd += list(command)
    return cmd


def js_run(args, knob_env, command=None):
    if not js_available():
        raise RuntimeError("horovodrun-torch --js requested but 'jsrun' not found "
                           "in PATH (are you inside an LSF allocation?)")
    hosts = LSFUtils.get_compute_hosts()
    np = args.np or LSFUtils.get_num_processes()
    env = dict(os.environ)
    env.update(knob_env)
    env.setdefault("HOROVOD_SIZE", str(np))
    if hosts:
        # jsrun assigns ranks host-major, so rank 0 (the controller's
        # listen socket) lands on the first compute host — workers must
        # dial THAT host, not the launch node (which LSF excludes from
        # the compute list).
        env.setdefault("HOROVOD_CONTROLLER_ADDR", hosts[0].hostname)
        env.setdefault("HOROVOD_CONTROLLER_PORT", str(util.free_port()))
    per_host = hosts[0].slots if hosts else np
    cmd = build_js_command(len(hosts), per_host, command or args.command,
                           extra_args=getattr(args, "js_args", None))
    if args.verbose:
        print(f"[horovodrun-torch] js: {' '.join(map(shlex.quote, cmd))}",
              file=sys.stderr)
    return subprocess.call(cmd, env=env)
