"""Start a job from an MPI world: a bare ``mpirun`` or ``srun`` with no
launcher of the port's.

The port's own copy of the first half of
``horovod_tpu/common/mpi_bootstrap.py`` (``_under_mpi_launcher:46``,
``_routable_ip:66``, ``_mpi_world:96``, ``maybe_bootstrap_from_mpi:138``,
``_identity_env:186``), called where the reference calls it: in
``hvd.init`` (``common/elastic.py init``) without an elastic driver,
when ``HOROVOD_RANK`` is absent. From the communicator:

- rank and size;
- local_rank and local_size from a shared-memory split (``Split_type``);
- cross_rank and cross_size from a split keyed by the local rank;
- rank 0 picks the controller port (the lane's TCPStore) and
  ``comm.bcast``s ``(ip, port)``.

mpi4py is imported only behind the launcher gate: a bare ``from mpi4py
import MPI`` runs MPI_Init as a side effect, and a failing MPI_Init
aborts the process before any ``except`` runs. So the import happens
only when a launcher's own variables say an MPI world is expected, with
``mpi4py.rc.initialize`` off and ``MPI.Init()`` called explicitly (and
``Finalize`` at exit).

``HOROVOD_CONTROLLER=mpi`` (the reference's zero-socket control and
ring data over mpi4py, ``bootstrap_mpi_control:308``) is not ported:
:func:`check_controller` raises naming ROADMAP.md L9b rather than run
the TCP path quietly.
"""

import os
import socket
import sys

# Env vars only an MPI-capable launcher sets on its children. Presence of
# any of these is the precondition for importing mpi4py ourselves.
# Deliberately NOT SLURM_PROCID: sbatch/srun set it on every task of
# every job, MPI or not — srun's MPI plugins announce themselves through
# PMI_SIZE / PMIX_RANK, which is the evidence an MPI runtime can
# actually bootstrap here.
_LAUNCHER_ENVS = (
    "OMPI_COMM_WORLD_SIZE",   # Open MPI orted
    "PMI_SIZE",               # MPICH / Hydra / PMI-1 (incl. srun --mpi=pmi2)
    "MV2_COMM_WORLD_SIZE",    # MVAPICH2
)

# PMIx sets no standard size var itself; under srun --mpi=pmix the step
# task count is the size evidence.
_PMIX_SIZE_ENVS = ("SLURM_STEP_NUM_TASKS", "SLURM_NTASKS")


def _under_mpi_launcher(environ):
    """Launcher evidence check. Size evidence must also say >1 — an
    '-np 1' world has nothing to bootstrap and is not worth an
    MPI_Init (which under a half-configured PMI env can still
    hard-abort)."""

    def _gt1(val):
        try:
            return int(val) > 1
        except (TypeError, ValueError):
            return False

    for var in _LAUNCHER_ENVS:
        if _gt1(environ.get(var)):
            return True
    if "PMIX_RANK" in environ:
        return any(_gt1(environ.get(v)) for v in _PMIX_SIZE_ENVS)
    return False


def _routable_ip():
    """Best-effort routable IPv4 address for this host (the UDP-connect
    trick the NIC-discovery task service uses), falling back to
    resolver-reported non-loopback IPv4 addresses, then the hostname.

    IPv4 only, as the reference's: its control plane listens and
    connects AF_INET, and the port's TCPStore endpoint is published the
    same way.
    """
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        pass
    finally:
        s.close()
    # Egress-filtered hosts where the UDP-connect trick finds nothing:
    # any non-loopback IPv4 the resolver maps the hostname to.
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None,
                                       socket.AF_INET):
            addr = info[4][0]
            if not addr.startswith("127."):
                return addr
    except OSError:
        pass
    return socket.gethostname()


def _mpi_world(environ):
    """(MPI module, COMM_WORLD) for a genuinely running MPI program, else
    None. Never initializes an MPI runtime unless a launcher env var
    proves one is expected."""
    mod = sys.modules.get("mpi4py")
    MPI = getattr(mod, "MPI", None) if mod is not None else None
    if MPI is None:
        if not _under_mpi_launcher(environ):
            return None
        try:
            import mpi4py

            # Import must stay side-effect free; Init runs explicitly
            # below. (MPI_Init failure under a broken PMI bootstrap can
            # still hard-abort — pre-init errors bypass error handlers —
            # but the launcher gate means one was genuinely expected.)
            mpi4py.rc.initialize = False
            from mpi4py import MPI
        except Exception:
            return None
    try:
        if not MPI.Is_initialized():
            if not _under_mpi_launcher(environ):
                # Embedding program imported mpi4py but never brought the
                # world up, and no launcher is present: not an MPI run.
                return None
            MPI.Init()
            # We initialized, so we must finalize — an Init-without-
            # Finalize exit makes mpirun report the whole (successful)
            # job as failed. Guarded: an embedding program or mpi4py's
            # own atexit hook may get there first.
            import atexit

            atexit.register(
                lambda: MPI.Finalize()
                if MPI.Is_initialized() and not MPI.Is_finalized()
                else None)
        return MPI, MPI.COMM_WORLD
    except Exception:
        return None


def maybe_bootstrap_from_mpi(environ=os.environ):
    """Populate HOROVOD_* env from MPI when launched by bare mpirun.

    Returns True when the env was populated from a communicator.
    No-op (False) when a launcher already provided HOROVOD_RANK, or when
    there is no usable MPI world.
    """
    if "HOROVOD_RANK" in environ:
        return False
    world = _mpi_world(environ)
    if world is None:
        return False
    MPI, comm = world
    if comm.Get_size() <= 1:
        return False

    identity = _identity_env(MPI, comm)
    rank = int(identity["HOROVOD_RANK"])

    # Rank 0 owns the controller endpoint; everyone learns it via bcast
    # (the comm plays the role horovodrun's env injection plays).
    if rank == 0:
        port = environ.get("HOROVOD_CONTROLLER_PORT")
        if not port:
            # Same ephemeral-port probe the launcher uses; the brief
            # close->rebind window is shared with every free_port()
            # user in the runner.
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("", 0))
            port = str(s.getsockname()[1])
            s.close()
        # Publish a routable IP, not the bare hostname: peer hosts in
        # containerized MPI clusters often cannot resolve each other's
        # hostnames.
        endpoint = (_routable_ip(), port)
    else:
        endpoint = None
    host, port = comm.bcast(endpoint, root=0)

    environ.update(identity)
    environ.update({
        "HOROVOD_CONTROLLER_ADDR": host,
        "HOROVOD_CONTROLLER_PORT": str(port),
    })
    return True


def _identity_env(MPI, comm):
    """The six HOROVOD_* identity variables from a communicator: the
    global rank and size, the shared-memory (local) split, and the
    cross split keyed by the local rank."""
    rank, size = comm.Get_rank(), comm.Get_size()
    local_comm = comm.Split_type(MPI.COMM_TYPE_SHARED, key=rank)
    cross_comm = comm.Split(color=local_comm.Get_rank(), key=rank)
    return {
        "HOROVOD_RANK": str(rank),
        "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(local_comm.Get_rank()),
        "HOROVOD_LOCAL_SIZE": str(local_comm.Get_size()),
        "HOROVOD_CROSS_RANK": str(cross_comm.Get_rank()),
        "HOROVOD_CROSS_SIZE": str(cross_comm.Get_size()),
    }


def check_controller(environ=os.environ):
    """Refuse ``HOROVOD_CONTROLLER=mpi``: control frames and a host data
    plane over mpi4py point-to-point are ROADMAP.md L9b, not ported."""
    if environ.get("HOROVOD_CONTROLLER", "").lower() == "mpi":
        raise NotImplementedError(
            "HOROVOD_CONTROLLER=mpi (control frames and host ring data "
            "over mpi4py, no TCP sockets) is not ported yet (ROADMAP.md "
            "L9b); unset it to run the TCP rendezvous, which a bare "
            "mpirun still bootstraps")
