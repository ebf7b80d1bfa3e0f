"""horovod_tpu_torch.torch: the Horovod eager lane for PyTorch
(``import horovod_tpu_torch.torch as hvd``).

Counterpart of ``horovod_tpu/torch/__init__.py``, with its API: init,
rank and size; (grouped) allreduce, allgather, broadcast, alltoall and
reducescatter, sync and async, in place and out of place; barrier and
join; process sets; ``DistributedOptimizer``; the broadcast helpers and
``Compression``. It runs on the port's own controller over
``torch.distributed``: NCCL for CUDA tensors, gloo for CPU tensors
(``common/``), with the reference's instruments: the timeline
(``start_timeline``/``stop_timeline``), ``metrics``/``metrics_reset``,
``events`` and ``debug_port``; and ``SyncBatchNorm``.

``hvd.elastic`` is elastic training (``torch/elastic.py``: ``run``,
``TorchState``, ``TreeState``, ``ObjectState``, ``init``, ``reset``,
``survivors``), and ``init`` takes the elastic driver's assignment when
one runs the job (``HOROVOD_RDZV_ADDR``). Still to port behind the same
names: the parole door (L5b), autotune (L6), hierarchical allreduce
(L7), the control tree and wire checksums (L8), the MPI controller (L9),
the launcher (L10) and the JAX frontend's functional lane (L11).
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
    debug_port,
    events,
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
    metrics,
    metrics_reset,
    poll,
    rank,
    reducescatter,
    reducescatter_async,
    shutdown,
    size,
    start_timeline,
    stop_timeline,
    synchronize,
)
from horovod_tpu_torch.torch.optimizer import (  # noqa: F401
    DistributedOptimizer,
)
from horovod_tpu_torch.torch.sync_batch_norm import (  # noqa: F401
    SyncBatchNorm,
)
from horovod_tpu_torch.torch import elastic  # noqa: E402,F401
