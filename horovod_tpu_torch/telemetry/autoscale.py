"""The serving signal set's sentinels, and their reader.

The port's own copy of ``horovod_tpu/telemetry/autoscale.py``'s
``SERVING_SIGNAL_DEFAULTS`` and ``read_serving_signals``: the one
literal every consumer of the serving fields shares (``/healthz`` in
``telemetry/debug_server.py``, ``serving/service.py serving_signals``).
``kv_blocks_*`` -1 means no pool in this process, distinct from a pool
momentarily empty; zeros elsewhere mean no service live or nothing
measured yet. The autoscaler itself (``AutoscalePolicy``,
``Autoscaler``, ``collect_signals``) waits for ROADMAP.md A12b.
"""

import sys

SERVING_SIGNAL_DEFAULTS = {
    "serving_queue_depth": 0,
    "inflight_sequences": 0,
    "kv_blocks_free": -1,
    "kv_blocks_total": -1,
    "serving_p50_ms": 0.0,
    "serving_p99_ms": 0.0,
    "requests_served": 0,
    "recomputed_prefill_tokens": 0,
    "useful_tokens": 0,
    "eviction_amplification": 0.0,
}


def read_serving_signals():
    """The live serving loop's signals, or the defaults. The serving
    module is looked up, not imported: a process that serves nothing
    never imports it for a health check."""
    svc = sys.modules.get("horovod_tpu_torch.serving.service")
    if svc is not None:
        try:
            return svc.serving_signals()
        except Exception:  # noqa: BLE001: the health check must answer
            pass
    return dict(SERVING_SIGNAL_DEFAULTS)
