"""What the port can use on this machine, decided once.

``runner/launch.py check_build_rows`` prints it (``horovodrun-torch
--check-build``) and the torch frontend's capability probes answer from
it: ``gloo_built``, ``gloo_enabled``, ``mpi_built``, ``mpi_enabled``,
``mpi_threads_supported``, ``nccl_built``, ``cuda_built``,
``rocm_built``, ``ccl_built``, ``ddl_built``, ``xla_built`` and
``xla_enabled``, the names of ``horovod_tpu/common/basics.py``'s
capability surface. They report the port's reality, not the reference's:

- gloo is torch's gloo backend (the lane's CPU tensors and control);
- NCCL and CUDA are torch's, on a machine with a card: the lane's CUDA
  tensors ride NCCL (the reference's TPU build answers False for both);
- MPI is the bare-``mpirun`` start (``common/mpi_bootstrap.py``), which
  needs mpi4py; ``mpi_enabled`` says whether an MPI launcher's variables
  are set (``common/basics.py _ENV_FALLBACKS``, as the reference's);
- the lane's controller owns its traffic on one thread and user threads
  only enqueue, so ``mpi_threads_supported`` is True, as the
  reference's;
- the port has no XLA plane, and no ROCm, oneCCL or DDL backend.
"""

import importlib.util
import os


def probe():
    """The lane's backends on this machine, probed live: a dict of
    ``torch_version``, ``tcp_store``, ``mpi4py``, ``gloo``, ``nccl``,
    ``cuda`` and ``cuda_version``."""
    import torch
    import torch.distributed as dist

    try:
        mpi4py = importlib.util.find_spec("mpi4py") is not None
    except (ImportError, ValueError):
        mpi4py = False
    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "tcp_store": dist.is_available(),
        "mpi4py": mpi4py,
        "gloo": dist.is_available() and dist.is_gloo_available(),
        "nccl": dist.is_available() and dist.is_nccl_available() and cuda,
        "cuda": cuda,
        "cuda_version": torch.version.cuda or "",
    }


def nccl_version_string():
    """``torch.cuda.nccl.version()`` as ``major.minor.patch``."""
    import torch

    v = torch.cuda.nccl.version()
    return ".".join(map(str, v)) if isinstance(v, tuple) else str(v)


def gloo_built(verbose=False):
    """torch's gloo backend: the lane's CPU tensors and its control."""
    del verbose
    return probe()["gloo"]


def gloo_enabled():
    return probe()["gloo"]


def mpi_built(verbose=False):
    """The bare-``mpirun`` start, which takes its world from mpi4py."""
    del verbose
    return probe()["mpi4py"]


def mpi_enabled():
    """Whether an MPI launcher's rank variable is set in this process."""
    from horovod_tpu_torch.common.basics import _ENV_FALLBACKS

    return any(v in os.environ for v in _ENV_FALLBACKS["HOROVOD_RANK"])


def mpi_threads_supported():
    return True


def nccl_built(verbose=False):
    """torch's NCCL on a machine with a card: the lane's CUDA tensors."""
    del verbose
    return probe()["nccl"]


def cuda_built(verbose=False):
    del verbose
    return probe()["cuda"]


def rocm_built(verbose=False):
    del verbose
    return False


def ccl_built(verbose=False):
    del verbose
    return False


def ddl_built(verbose=False):
    del verbose
    return False


def xla_built(verbose=False):
    del verbose
    return False


def xla_enabled():
    return False
