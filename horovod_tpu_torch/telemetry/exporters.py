"""The Prometheus text of a metrics snapshot.

The port's own copy of ``horovod_tpu/telemetry/exporters.py``
``_flatten_prom``, over the sections the port's snapshot has
(``common/metrics.py``): the same ``hvdtpu_*`` names and labels, the
wire-byte counters, the elastic fault lifecycle (less the wire's
``heals``, ``retries`` and ``crc_errors``) and the serving gauges of the
live ``ServingLoop`` (``telemetry/autoscale.py read_serving_signals``).
The wire's stripe-channel, syscall and overlap series wait for ROADMAP.md
L8 and A12, and the reference's scraper for A12.
"""

from horovod_tpu_torch.telemetry.autoscale import read_serving_signals


def _flatten_prom(snap, rank):
    """Flatten a snapshot into Prometheus text-format lines."""
    lines = [
        "# HELP hvdtpu_op_bytes_total payload bytes moved per op class",
        "# TYPE hvdtpu_op_bytes_total counter",
    ]
    label = f'rank="{rank}"'
    for plane_key, plane in (("host", "ops"), ("device", "device_ops")):
        for op, c in snap.get(plane, {}).items():
            for field in ("responses", "tensors", "bytes"):
                lines.append(
                    f'hvdtpu_op_{field}_total{{op="{op}",'
                    f'plane="{plane_key}",{label}}} {c.get(field, 0)}')
    for hist in ("negotiation_us", "queue_us", "wire_us"):
        h = snap.get(hist, {})
        for field in ("count", "sum_us", "p50_us", "p99_us", "max_us"):
            lines.append(
                f'hvdtpu_{hist}_{field}{{{label}}} {h.get(field, 0)}')
    cache = snap.get("cache", {})
    for field in ("hits", "misses", "entries", "hit_bytes"):
        lines.append(f'hvdtpu_cache_{field}{{{label}}} '
                     f'{cache.get(field, 0)}')
    lines.append(f'hvdtpu_cache_hit_rate{{{label}}} '
                 f'{cache.get("hit_rate", 0.0)}')
    cyc = snap.get("cycle", {})
    for field in ("count", "stalls", "overrun_us"):
        lines.append(f'hvdtpu_cycle_{field}{{{label}}} '
                     f'{cyc.get(field, 0)}')
    fus = snap.get("fusion", {})
    for field in ("fused_responses", "fill_bytes", "capacity_bytes"):
        lines.append(f'hvdtpu_fusion_{field}{{{label}}} '
                     f'{fus.get(field, 0)}')
    lines.append(f'hvdtpu_fusion_fill_ratio{{{label}}} '
                 f'{fus.get("fill_ratio", 0.0)}')
    wire = snap.get("wire", {})
    for field in ("tx_bytes", "rx_bytes", "tx_logical_bytes",
                  "rx_logical_bytes", "cross_tx_bytes", "cross_rx_bytes",
                  "cross_tx_logical_bytes", "cross_rx_logical_bytes"):
        lines.append(f'hvdtpu_wire_{field}_total{{{label}}} '
                     f'{wire.get(field, 0)}')
    for field in ("compression_ratio", "cross_compression_ratio"):
        lines.append(f'hvdtpu_wire_{field}{{{label}}} '
                     f'{wire.get(field, 1.0)}')
    el = snap.get("elastic", {})
    for field in ("faults_detected", "faults_recovered",
                  "ranks_blacklisted", "ranks_rejoined", "resets"):
        lines.append(f'hvdtpu_elastic_{field}_total{{{label}}} '
                     f'{el.get(field, 0)}')
    lines.append(f'hvdtpu_elastic_epoch{{{label}}} {el.get("epoch", 0)}')
    det = el.get("detect_us", {})
    for field in ("count", "p50_us", "p99_us", "max_us"):
        lines.append(f'hvdtpu_elastic_detect_{field}{{{label}}} '
                     f'{det.get(field, 0)}')
    # The serving loop's gauges, or their defaults when no loop runs in
    # this process: a training scrape has the same fields.
    for field, v in sorted(read_serving_signals().items()):
        lines.append(f'hvdtpu_serving_{field}{{{label}}} {v}')
    for r, n in enumerate(
            snap.get("straggler", {}).get("last_rank_counts", [])):
        lines.append(
            f'hvdtpu_straggler_last_total{{{label},'
            f'straggler="{r}"}} {n}')
    lines.append(f'hvdtpu_errors_total{{{label}}} '
                 f'{snap.get("errors", 0)}')
    return "\n".join(lines) + "\n"
