"""horovod_tpu_torch.torch: the Horovod eager lane for PyTorch
(``import horovod_tpu_torch.torch as hvd``).

Counterpart of ``horovod_tpu/torch/__init__.py``, with its API: init,
rank and size; (grouped) allreduce, allgather, broadcast, alltoall and
reducescatter, sync and async, in place and out of place; barrier and
join; process sets; ``DistributedOptimizer``; the broadcast helpers and
``Compression``. It runs on the port's own controller over
``torch.distributed``: NCCL for CUDA tensors, gloo for CPU tensors
(``common/``).

The reference's names this port does not have yet raise
``NotImplementedError`` naming their ROADMAP.md item: ``SyncBatchNorm``
(L4), ``elastic`` (L5), ``start_timeline``/``stop_timeline``,
``metrics``/``metrics_reset``, ``events`` and ``debug_port`` (L3).
"""

from horovod_tpu_torch.common.exceptions import (  # noqa: F401
    HorovodInternalError,
    HorovodPeerFailureError,
    HorovodWireCorruptionError,
    HostsUpdatedInterrupt,
)
from horovod_tpu_torch.common.message import ReduceOp  # noqa: F401
from horovod_tpu_torch.common.process_sets import (  # noqa: F401
    ProcessSet,
    add_process_set,
    global_process_set,
    remove_process_set,
)
from horovod_tpu_torch.torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.torch.functions import (  # noqa: F401
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from horovod_tpu_torch.torch.mpi_ops import (  # noqa: F401
    Adasum,
    Average,
    Handle,
    Max,
    Min,
    Product,
    Sum,
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    cross_rank,
    cross_size,
    grouped_allgather,
    grouped_allgather_async,
    grouped_allreduce,
    grouped_allreduce_,
    grouped_allreduce_async,
    grouped_allreduce_async_,
    grouped_reducescatter,
    grouped_reducescatter_async,
    init,
    is_initialized,
    join,
    local_rank,
    local_size,
    poll,
    rank,
    reducescatter,
    reducescatter_async,
    shutdown,
    size,
    synchronize,
)
from horovod_tpu_torch.torch.optimizer import (  # noqa: F401
    DistributedOptimizer,
)


def _not_ported(name, item):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"hvd.{name} is not ported yet "
                                  f"(ROADMAP.md {item})")
    fn.__name__ = name
    return fn


SyncBatchNorm = _not_ported("SyncBatchNorm", "L4")
start_timeline = _not_ported("start_timeline", "L3")
stop_timeline = _not_ported("stop_timeline", "L3")
metrics = _not_ported("metrics", "L3")
metrics_reset = _not_ported("metrics_reset", "L3")
events = _not_ported("events", "L3")
debug_port = _not_ported("debug_port", "L3")


def __getattr__(name):
    if name == "elastic":
        raise NotImplementedError("hvd.elastic is not ported yet "
                                  "(ROADMAP.md L5)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
