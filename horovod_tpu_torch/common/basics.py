"""init, shutdown and the rank layout of the port's Horovod lane.

Counterpart of ``horovod_tpu/common/basics.py`` (``HorovodBasics`` over
the core's C API) and of the core's init (``csrc/operations.cc:1452``).
It reads the same environment: ``HOROVOD_RANK``/``SIZE`` (default 0/1),
``HOROVOD_LOCAL_RANK``/``LOCAL_SIZE`` (default rank/size),
``HOROVOD_CROSS_RANK``/``CROSS_SIZE`` (default 0/1), the launchers'
variables when those are unset (mpirun, srun, jsrun),
``HOROVOD_CONTROLLER_ADDR``/``PORT`` (default 127.0.0.1:29500), and two
knobs: ``HOROVOD_FUSION_THRESHOLD`` (bytes, default 64 MiB) and
``HOROVOD_CYCLE_TIME`` (ms, default 1.0).

``init()`` builds one ``TCPStore`` at the controller address (a world of
one needs no rendezvous and keeps an in-process store), opens
``torch.distributed`` with a gloo group for control, a gloo group for
CPU tensors and, when the lane runs on the card, an NCCL group on
``cuda:{local_rank}``, then starts the lane thread. The device rule is
the port's (``_device.py``): with no ``device`` and no CUDA, ``init``
raises; after ``init(device="cpu")`` a CUDA tensor raises, and a CUDA
tensor never travels over gloo or through host memory, nor a CPU
tensor over NCCL.
"""

import atexit
import datetime
import os
import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.common.data_plane import DataPlane
from horovod_tpu_torch.common.operations import Runtime, SetGroups

_TIMEOUT = datetime.timedelta(seconds=600)

# Launcher fallbacks, HOROVOD_* first (horovod_tpu/common/basics.py:251).
_ENV_FALLBACKS = {
    "HOROVOD_RANK": ("OMPI_COMM_WORLD_RANK", "PMIX_RANK", "PMI_RANK",
                     "SLURM_PROCID", "JSM_NAMESPACE_RANK"),
    "HOROVOD_SIZE": ("OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS",
                     "JSM_NAMESPACE_SIZE"),
    "HOROVOD_LOCAL_RANK": ("OMPI_COMM_WORLD_LOCAL_RANK", "PMI_LOCAL_RANK",
                           "SLURM_LOCALID", "JSM_NAMESPACE_LOCAL_RANK"),
    "HOROVOD_LOCAL_SIZE": ("OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_LOCAL_SIZE",
                           "SLURM_TASKS_PER_NODE"),
}


def _env_int(name, default):
    val = os.environ.get(name)
    if val:
        return int(val)
    for src in _ENV_FALLBACKS.get(name, ()):
        val = os.environ.get(src)
        if val:
            # SLURM_TASKS_PER_NODE can read '4(x2)': take the number.
            return int(val.split("(")[0].split(",")[0])
    return default


class _Lane:
    """What init() opened; shutdown() closes it."""

    def __init__(self, runtime, layout, device):
        self.runtime = runtime
        self.layout = layout
        self.device = device


_lock = threading.Lock()
_lane = None


def init(device=None):
    """Open the lane. ``device`` None means the card (``cuda`` must be
    available), ``"cpu"`` a gloo-only lane. A second call is a no-op."""
    global _lane
    with _lock:
        if _lane is not None:
            return
        dev = resolve_device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"the lane runs on cuda or cpu, not {dev}")
        rank = _env_int("HOROVOD_RANK", 0)
        size = _env_int("HOROVOD_SIZE", 1)
        layout = dict(rank=rank, size=size,
                      local_rank=_env_int("HOROVOD_LOCAL_RANK", rank),
                      local_size=_env_int("HOROVOD_LOCAL_SIZE", size),
                      cross_rank=_env_int("HOROVOD_CROSS_RANK", 0),
                      cross_size=_env_int("HOROVOD_CROSS_SIZE", 1))
        card = (torch.device("cuda", layout["local_rank"])
                if dev.type == "cuda" else None)
        if dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is already initialized: hvd.init() opens "
                "its own process groups")
        if size == 1:
            store = dist.HashStore()
        else:
            store = dist.TCPStore(
                os.environ.get("HOROVOD_CONTROLLER_ADDR") or "127.0.0.1",
                _env_int("HOROVOD_CONTROLLER_PORT", 29500), size,
                is_master=rank == 0, timeout=_TIMEOUT)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=size, timeout=_TIMEOUT)
        try:
            runtime = _open_lane(rank, size, card)
        except BaseException:
            dist.destroy_process_group()
            raise
        runtime.start()
        _lane = _Lane(runtime, layout, card)


def _open_lane(rank, size, card):
    """The process groups of the global set and the lane's runtime."""

    def make_groups(ranks):
        ranks = sorted(int(r) for r in ranks)
        groups = {"cpu": dist.new_group(ranks, timeout=_TIMEOUT,
                                        backend="gloo")}
        if card is not None:
            groups["cuda"] = dist.new_group(ranks, timeout=_TIMEOUT,
                                            backend="nccl")
        return groups

    world = list(range(size))
    groups = make_groups(world)
    if card is not None:
        # Open the communicator now, so that a failure shows at init.
        with torch.cuda.device(card):
            probe = torch.zeros(1, device=card)
            dist.all_reduce(probe, group=groups["cuda"])
            torch.cuda.synchronize(card)
    threshold = _env_int("HOROVOD_FUSION_THRESHOLD", 64 << 20)
    return Runtime(rank, size, dist.group.WORLD, DataPlane(card, threshold),
                   {0: SetGroups(world, rank, groups)}, threshold,
                   float(os.environ.get("HOROVOD_CYCLE_TIME") or 1.0),
                   make_groups)


def shutdown():
    """Negotiated: returns once every rank has called it (or the lane
    has failed); then closes the process groups. A no-op when not
    initialized."""
    global _lane
    with _lock:
        lane, _lane = _lane, None
    if lane is None:
        return
    if lane.runtime.shutdown(_TIMEOUT.total_seconds()):
        dist.destroy_process_group()


@atexit.register
def _shutdown_at_exit():
    # A process that never called shutdown() still takes part in the
    # negotiated one, so that no peer is left waiting.
    shutdown()


def is_initialized():
    return _lane is not None


def lane():
    """The open lane's runtime; raises before init()."""
    current = _lane
    if current is None:
        raise ValueError("Horovod is not initialized: call hvd.init() first")
    return current.runtime


def device():
    """The card this rank's lane runs CUDA tensors on, or None."""
    current = _lane
    return None if current is None else current.device


def _layout(key):
    current = _lane
    if current is None:
        raise ValueError(f"hvd.{key}() called before hvd.init(); call "
                         "hvd.init() first")
    return current.layout[key]


def rank():
    return _layout("rank")


def size():
    return _layout("size")


def local_rank():
    return _layout("local_rank")


def local_size():
    return _layout("local_size")


def cross_rank():
    return _layout("cross_rank")


def cross_size():
    return _layout("cross_size")


def loop_failed():
    """Whether the lane stopped on a failed collective."""
    current = _lane
    return current is not None and current.runtime.failure is not None
