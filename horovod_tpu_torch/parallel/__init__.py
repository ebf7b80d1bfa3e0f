"""Training-step machinery of the port: the fused single-pass
optimizers (``precision``) and the split train step (``train_step``),
imported as modules; and sequence parallelism over a ``data`` x ``seq``
mesh, re-exported here under the JAX package's names: the mesh
(``mesh``), its differentiable collectives (``ops``), ring attention
(``ring_attention``) and Ulysses (``ulysses``)."""

from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    Mesh,
    MeshConfig,
    create_mesh,
)
from horovod_tpu_torch.parallel.ops import (  # noqa: F401
    all_to_all,
    ppermute_ring,
    psum,
    replicate,
)
from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    blockwise_attention,
    ring_attention,
    ring_flash_steps,
    ring_self_attention,
)
from horovod_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
    ulysses_self_attention,
)
