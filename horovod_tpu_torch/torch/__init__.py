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
``survivors``, and the parole door's ``rejoin`` and the voluntary
``shrink``), and ``init`` takes the elastic driver's assignment when
one runs the job (``HOROVOD_RDZV_ADDR``) or opens rank 0's door
(``HOROVOD_REJOIN_PORT``). ``HOROVOD_AUTOTUNE=1`` tunes the fusion
threshold, the cycle time, the wire codec and the hierarchy split on the
coordinator. The cross-plane surface: ``HOROVOD_CROSS_PLANE`` (the
hierarchical allreduce on a layout of several slices), the wire codecs
of ``HOROVOD_WIRE_COMPRESSION`` and ``HOROVOD_CROSS_PLANE_COMPRESSION``,
and ``cross_plane``, ``CROSS_PLANE_MODES``, ``hier_split``,
``set_hier_split``, ``cross_compression``, ``wire_compression``,
``set_wire_compression``, ``wire_codec`` and ``set_wire_codec``. A job
starts under the port's own launcher (``horovodrun-torch``,
``runner/launch.py``), its elastic driver, or a bare ``mpirun``
(``common/mpi_bootstrap.py``). The JAX frontend's functional lane
(``torch/fused_optimizer.py``): ``allreduce_gradients``,
``DistributedFusedAdam`` (with ``zero=True``, ZeRO-1 on the lane) and
``make_fused_train_step``; ``init(jit_fusion=...)``. The capability
probes (``gloo_built``, ``nccl_built``... ``common/capabilities.py``)
answer what ``horovodrun-torch --check-build`` prints. Still to port
behind the same names: the control tree and wire checksums (L8) and
control frames over MPI (L9b).
"""

from horovod_tpu_torch.common.basics import (  # noqa: F401
    CROSS_PLANE_MODES,
    cross_compression,
    cross_plane,
    hier_split,
    set_hier_split,
    set_wire_codec,
    set_wire_compression,
    wire_codec,
    wire_compression,
)
# The capability surface (``hvd.nccl_built()``, ``hvd.gloo_built()``...),
# the answers ``horovodrun-torch --check-build`` prints.
from horovod_tpu_torch.common.capabilities import (  # noqa: F401
    ccl_built,
    cuda_built,
    ddl_built,
    gloo_built,
    gloo_enabled,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rocm_built,
    xla_built,
    xla_enabled,
)
from horovod_tpu_torch.common.exceptions import (  # noqa: F401
    HorovodInternalError,
    HorovodPeerFailureError,
    HorovodReformationError,
    HorovodStateLostError,
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
from horovod_tpu_torch.torch.fused_optimizer import (  # noqa: F401
    DistributedFusedAdam,
    allreduce_gradients,
    make_fused_train_step,
)
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
# The resharding planner's mesh surface (``parallel/reshard.py``): a
# rank's block moved between two (mesh, spec) layouts.
from horovod_tpu_torch.parallel.reshard import (  # noqa: E402,F401
    redistribute,
)
