"""Serving lane of the port: paged KV cache (``kvcache``), request
scheduler (``scheduler``), the continuous-batching ``DecodeEngine``
(``engine``) and the disaggregated elastic ``ServingLoop`` (``service``;
``serve_smoke`` is its two-rank chaos drill), with the JAX package's
package-level names."""

from horovod_tpu_torch.serving.kvcache import (  # noqa: F401
    OutOfBlocks,
    PagedKVCache,
    quantize_blocks,
)
from horovod_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    Request,
    Sequence,
    latency_summary,
    poisson_trace,
)
from horovod_tpu_torch.serving.engine import DecodeEngine  # noqa: F401
from horovod_tpu_torch.serving.service import (  # noqa: F401
    ServingLoop,
    serving_signals,
)
