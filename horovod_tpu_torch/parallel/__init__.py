"""Training-step machinery of the port: the fused single-pass
optimizers and the master-weights wrapper (``precision``), the split
train step (``train_step``), ZeRO-1 (``zero``) and its fused schedule's
knob and hooks (``fusion``); and the mesh of the ``pipe``, ``data``,
``fsdp``, ``seq``, ``expert`` and ``tensor`` axes: the mesh (``mesh``),
its differentiable collectives (``ops``), the sharding rules' helpers
(``sharding``), the pipeline schedules and their hvdlint hooks
(``pipeline``), the resharding
planner and its executors (``reshard``), ring attention
(``ring_attention``) and Ulysses (``ulysses``). Their names are
re-exported here under the JAX package's names."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    Mesh,
    MeshConfig,
    create_mesh,
)
from horovod_tpu_torch.parallel.ops import (  # noqa: F401
    all_gather,
    all_gather_invariant,
    all_to_all,
    hier_allreduce,
    ppermute_ring,
    predicted_hier_collectives,
    psum,
    reduce_scatter,
    replicate,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    InProcessTransport,
    InterleavedSchedule,
    MeshTransport,
    build_interleaved_schedule,
    build_pipeline_inner,
    gpipe,
    interleaved_one_f_one_b,
    one_f_one_b,
    predicted_collectives,
)
from horovod_tpu_torch.parallel.reshard import (  # noqa: F401
    Layout,
    ReshardPlan,
    even_row_layout,
    execute_plan,
    layout_from_spec,
    plan_redistribute,
    redistribute,
    reshard_rows,
    simulate_plan,
)
from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    blockwise_attention,
    ring_attention,
    ring_flash_steps,
    ring_self_attention,
)
from horovod_tpu_torch.parallel.sharding import (  # noqa: F401
    P,
    gather_params,
    shard_params,
)
from horovod_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
    ulysses_self_attention,
)
from horovod_tpu_torch.parallel.precision import (  # noqa: F401
    FusedAdamState,
    FusedMasterState,
    FusedOptimizer,
    MasterWeightsState,
    fused_adam,
    fused_master_adam,
    master_weights,
)
from horovod_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainStep,
    make_split_train_step,
)
from horovod_tpu_torch.parallel.zero import (  # noqa: F401
    ZeroAdamState,
    ZeroConfig,
    ZeroMasterAdamState,
    optimizer_state_bytes,
    ring_owned_segment,
    zero_bucket_layout,
)
