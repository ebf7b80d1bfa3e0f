"""The Prometheus text of a metrics snapshot.

The port's own copy of ``horovod_tpu/telemetry/exporters.py``
``_flatten_prom``, over the sections the port's snapshot has
(``common/metrics.py``): the same ``hvdtpu_*`` names and labels. The
reference's scraper and its ``wire``, ``elastic`` and serving samples
are not ported (ROADMAP.md L5, L8, A6).
"""


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
    for r, n in enumerate(
            snap.get("straggler", {}).get("last_rank_counts", [])):
        lines.append(
            f'hvdtpu_straggler_last_total{{{label},'
            f'straggler="{r}"}} {n}')
    lines.append(f'hvdtpu_errors_total{{{label}}} '
                 f'{snap.get("errors", 0)}')
    return "\n".join(lines) + "\n"
