"""The metrics scraper and its exporters.

The port's own copy of ``horovod_tpu/telemetry/exporters.py``.
:class:`MetricsScraper` snapshots the lane's registry on an interval, on
a daemon thread, and fans each snapshot out to any of three sinks:

- the JSONL flight recorder: one line a scrape (timestamped, with the
  serving signals), rotated to ``<path>.1`` past a size cap;
- the Prometheus textfile (:func:`_flatten_prom`), written atomically;
- the console table (:func:`_console_table`) on stderr.

:func:`_flatten_prom` covers the sections the port's snapshot has
(``common/metrics.py``): the same ``hvdtpu_*`` names and labels, the
wire-byte counters, the overlap ledger, the elastic fault lifecycle
(less the wire's ``heals``, ``retries`` and ``crc_errors``) and the
serving gauges of the live ``ServingLoop``
(``telemetry/autoscale.py read_serving_signals``). The wire's
stripe-channel and syscall series wait for ROADMAP.md L8.
"""

import json
import os
import sys
import threading
import time

from horovod_tpu_torch.telemetry import core as _core
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
    # The overlap ledger: exposed against hidden wire time a plane.
    ov = wire.get("overlap", {})
    lines.append(f'hvdtpu_overlap_steps_total{{{label}}} '
                 f'{ov.get("steps", 0)}')
    lines.append(f'hvdtpu_overlap_unattributed_us_total{{{label}}} '
                 f'{ov.get("unattributed_us", 0)}')
    lines.append(f'hvdtpu_overlap_efficiency{{{label}}} '
                 f'{ov.get("overlap_efficiency", 0.0)}')
    for plane in ("intra", "cross"):
        p = ov.get(plane, {})
        for field in ("exposed_us", "hidden_us", "total_us"):
            lines.append(
                f'hvdtpu_overlap_{field}_total{{plane="{plane}",'
                f'{label}}} {p.get(field, 0)}')
        lines.append(
            f'hvdtpu_overlap_plane_efficiency{{plane="{plane}",'
            f'{label}}} {p.get("overlap_efficiency", 0.0)}')
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


def _console_table(snap, stream):
    ops = snap.get("ops", {})
    dev = snap.get("device_ops", {})
    cache = snap.get("cache", {})
    cyc = snap.get("cycle", {})
    q = snap.get("queue_us", {})
    print(f"-- hvdtpu metrics (rank {snap.get('rank')}/"
          f"{snap.get('size')}) --", file=stream)
    print(f"{'op':<14}{'plane':<8}{'responses':>10}{'tensors':>10}"
          f"{'bytes':>14}", file=stream)
    for plane_name, plane in (("host", ops), ("device", dev)):
        for op, c in plane.items():
            print(f"{op:<14}{plane_name:<8}{c['responses']:>10}"
                  f"{c['tensors']:>10}{c['bytes']:>14}", file=stream)
    print(f"queue p50/p99: {q.get('p50_us', 0)}/{q.get('p99_us', 0)} us"
          f"  cache hit rate: {cache.get('hit_rate', 0.0):.3f}"
          f"  cycles: {cyc.get('count', 0)}"
          f" (stalls {cyc.get('stalls', 0)})", file=stream)


class MetricsScraper:
    """Periodic snapshot -> exporters, on a daemon thread.

    ``jsonl_path`` / ``prom_path`` / ``console`` pick the sinks (any
    subset). :meth:`start` launches the loop; :meth:`stop` takes one last
    scrape, so a short run still leaves a record. :meth:`scrape_once`
    works without the thread.
    """

    def __init__(self, interval_s=10.0, jsonl_path=None, prom_path=None,
                 console=False, console_stream=None,
                 jsonl_max_bytes=16 << 20):
        self.interval_s = float(interval_s)
        self.jsonl_path = jsonl_path
        self.prom_path = prom_path
        self.console = console
        self.console_stream = console_stream or sys.stderr
        self.jsonl_max_bytes = jsonl_max_bytes
        self._stop = threading.Event()
        self._thread = None
        self.scrapes = 0

    def scrape_once(self):
        snap = _core.snapshot()
        rank = snap.get("rank", -1)
        # The serving signals on every row (their defaults when no loop
        # serves): the recorder is the offline twin of /healthz.
        row = {"ts": time.time(), **snap, "serving": read_serving_signals()}
        if self.jsonl_path:
            self._write_jsonl(row)
        if self.prom_path:
            self._write_prom(snap, rank)
        if self.console:
            _console_table(snap, self.console_stream)
        self.scrapes += 1
        return row

    def _write_jsonl(self, row):
        path = self.jsonl_path
        try:
            if (os.path.exists(path)
                    and os.path.getsize(path) > self.jsonl_max_bytes):
                os.replace(path, path + ".1")  # keep one generation
        except OSError:
            pass
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def _write_prom(self, snap, rank):
        tmp = self.prom_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(_flatten_prom(snap, rank))
        os.replace(tmp, self.prom_path)  # the textfile collector reads whole

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception as e:  # noqa: BLE001 — never take the
                # training process down with the scraper
                print(f"hvdtpu metrics scraper error: {e}",
                      file=sys.stderr)

    def start(self):
        if self._thread is not None:
            raise RuntimeError("scraper already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-torch-metrics-scraper")
        self._thread.start()
        return self

    def stop(self, final_scrape=True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 5)
            self._thread = None
        if final_scrape:
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
