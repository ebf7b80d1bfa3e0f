"""The port's telemetry: the lane's live endpoints and the offline
readers of what a run wrote.

The port's own copy of ``horovod_tpu/telemetry/`` (``predict.
collective_bytes`` sums hvdlint's recorded signature, ``analysis/``):

1. **Counters** (``core.py``): the lane's registry and event ring
   (``hvd.metrics()``, ``hvd.events()``) as the readers take them;
   :class:`MetricsScraper` (``exporters.py``) records them as JSONL, a
   Prometheus textfile or a console table; ``debug_server.py`` serves
   ``/healthz``, ``/metrics``, ``/events``, ``/requests``, ``/stacks``
   and ``/fleet``.
2. **Step accounting** (``step_timer.py``): :class:`StepTimer` turns a
   step's wall time into MFU (FLOPs counted by ``torch.utils.flop_counter``'s formulas) and
   wire goodput, and reconciles its bytes with ``predict.py``; the
   bubble helpers hold a pipeline's idle share to its schedule's.
3. **Readers**: ``python -m horovod_tpu_torch.telemetry.report`` merges
   per-rank timelines (``report.py``), attributes each step to the rank
   and phase that bounded it (``--critical-path``, ``critpath.py``),
   merges black-box dumps into a fault's causal timeline
   (``--post-mortem``, ``postmortem.py``) and decomposes a serving
   latency band by phase (``--requests``, ``reqtrace.py``);
   ``python -m horovod_tpu_torch.telemetry.perfwatch`` gates on a
   regression in scraper or bench rows.
4. **The fleet**: ``fleet.py`` decomposes each rank's wall time into
   rank-seconds buckets that sum to its window to the microsecond
   (``report --fleet``, and live at ``/fleet`` through
   :class:`FleetObservatory`); ``slo.py`` judges declared objectives per
   rank and records each breach as a ``slo_breach`` event;
   ``autoscale.py`` turns the signals into grow and shrink decisions
   (:class:`AutoscalePolicy`, :class:`Autoscaler`).
5. **Smokes**: ``smoke.py``, ``perf_smoke.py``, ``obs_smoke.py`` and
   ``fleet_smoke.py``, two ranks each.
"""

from horovod_tpu_torch.telemetry.core import (  # noqa: F401
    events,
    events_drain,
    metrics_reset,
    snapshot,
    step_id,
    step_mark,
    total_collective_bytes,
    wire_overlap,
    wire_plane_bytes,
)
from horovod_tpu_torch.telemetry.critpath import (  # noqa: F401
    critical_path,
    format_critical_path,
    write_event_dump,
)
from horovod_tpu_torch.telemetry.exporters import MetricsScraper  # noqa: F401
from horovod_tpu_torch.telemetry.postmortem import (  # noqa: F401
    format_post_mortem,
    merge_post_mortem,
    merge_post_mortem_streaming,
)
from horovod_tpu_torch.telemetry.reqtrace import (  # noqa: F401
    format_requests,
    live_requests,
    record_request,
    stitch_requests,
    tail_report,
)
from horovod_tpu_torch.telemetry.step_timer import (  # noqa: F401
    StepTimer,
    analytic_bubble,
    bubble_report,
    measured_bubble,
)
