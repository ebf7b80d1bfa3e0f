"""The MPI launch path: hand process management to ``mpirun``.

The port's own copy of ``horovod_tpu/runner/mpi_run.py`` (``MpiFlavor:25``,
``mpi_available:33``, ``detect_mpi_flavor:39``, ``build_mpi_command:60``,
``mpi_run:95``): the ``mpirun`` command line (the host list, Open MPI's
``-x`` exports or MPICH's ``-genvlist``, ``--bind-to none --map-by
slot``), run with MPI owning placement and lifetimes. The ranks read the
``OMPI_COMM_WORLD_*``-style variables at ``hvd.init``; the controller
endpoint still travels as ``HOROVOD_CONTROLLER_*``.
"""

import os
import shlex
import subprocess
import sys

from horovod_tpu_torch.runner import util

# Variable prefixes forwarded to the ranks (``-x`` each, or one
# ``-genvlist``), the reference's.
_FORWARD_PREFIXES = ("HOROVOD_", "JAX_", "TPU_", "XLA_", "LIBTPU_",
                     "PYTHONPATH", "PATH", "NCCL_", "LD_LIBRARY_PATH")


class MpiFlavor:
    OPENMPI = "openmpi"
    SPECTRUM = "spectrum"
    MPICH = "mpich"
    INTEL = "impi"
    UNKNOWN = "unknown"


def mpi_available(env=None):
    from shutil import which

    return which("mpirun", path=(env or os.environ).get("PATH")) is not None


def detect_mpi_flavor(version_text=None):
    """Classify the local MPI from ``mpirun --version`` output."""
    if version_text is None:
        try:
            version_text = subprocess.run(
                ["mpirun", "--version"], capture_output=True, text=True,
                timeout=10).stdout
        except (OSError, subprocess.TimeoutExpired):
            return MpiFlavor.UNKNOWN
    text = version_text.lower()
    if "open mpi" in text or "openrte" in text or "open-mpi" in text:
        return MpiFlavor.OPENMPI
    if "spectrum" in text:
        return MpiFlavor.SPECTRUM
    if "intel" in text:
        return MpiFlavor.INTEL
    if "mpich" in text or "hydra" in text:
        return MpiFlavor.MPICH
    return MpiFlavor.UNKNOWN


def build_mpi_command(np, hosts, command, env, flavor=MpiFlavor.OPENMPI,
                      ssh_port=None, extra_mpi_args=None):
    """The mpirun command line, built and not run.

    ``hosts``: list of HostInfo. ``env``: full worker env dict; vars
    matching _FORWARD_PREFIXES become ``-x`` args (Open MPI family) or a
    ``-genvlist`` (MPICH/Intel family).
    """
    host_arg = ",".join(f"{h.hostname}:{h.slots}" for h in hosts)
    forward = sorted(
        k for k in env
        if k.startswith(_FORWARD_PREFIXES) or k in ("PATH", "PYTHONPATH"))

    if flavor in (MpiFlavor.OPENMPI, MpiFlavor.SPECTRUM):
        cmd = ["mpirun", "--allow-run-as-root", "--tag-output",
               "-np", str(np), "-H", host_arg,
               "--bind-to", "none", "--map-by", "slot",
               "-mca", "pml", "ob1", "-mca", "btl", "^openib"]
        if ssh_port:
            cmd += ["-mca", "plm_rsh_args", f"-p {ssh_port}"]
        for k in forward:
            cmd += ["-x", k]
    else:
        # MPICH / Intel MPI / hydra family.
        cmd = ["mpirun", "-np", str(np), "-hosts",
               ",".join(h.hostname for h in hosts)]
        if forward:
            cmd += ["-genvlist", ",".join(forward)]
    if extra_mpi_args:
        cmd += shlex.split(extra_mpi_args)
    cmd += list(command)
    return cmd


def mpi_run(args, knob_env, command=None):
    """Launch through mpirun, which owns the process tree; returns its
    exit code."""
    if not mpi_available():
        raise RuntimeError(
            "horovodrun-torch --mpi requested but no 'mpirun' found in PATH. "
            "Install an MPI implementation or use the default launcher.")
    if args.np is None:
        raise ValueError("--mpi requires -np (rank count is owned by mpirun)")
    hosts = (util.parse_hostfile(args.hostfile) if args.hostfile
             else util.parse_hosts(args.hosts or f"localhost:{args.np}"))
    controller_addr = util.resolvable_addr_for(hosts)
    env = dict(os.environ)
    env.update(knob_env)
    env.setdefault("HOROVOD_CONTROLLER_ADDR", controller_addr)
    env.setdefault("HOROVOD_CONTROLLER_PORT", str(util.free_port()))
    env.setdefault("HOROVOD_SIZE", str(args.np))
    cmd = build_mpi_command(
        args.np, hosts, command or args.command, env,
        flavor=detect_mpi_flavor(),
        ssh_port=args.ssh_port,
        extra_mpi_args=getattr(args, "mpi_args", None))
    if args.verbose:
        print(f"[horovodrun-torch] mpi: {' '.join(map(shlex.quote, cmd))}",
              file=sys.stderr)
    return subprocess.call(cmd, env=env)
