"""Live per-rank introspection over HTTP (``HOROVOD_DEBUG_PORT``).

The port's own copy of ``horovod_tpu/telemetry/debug_server.py``. Rank
r listens on ``HOROVOD_DEBUG_PORT + r`` (port 0: an ephemeral port,
read back with ``hvd.debug_port()`` or the ``X-Hvdtpu-Debug-Port``
header), on loopback unless ``HOROVOD_DEBUG_HOST`` widens it, from a
daemon thread of stdlib ``http.server``, and serves:

- ``/healthz``: initialized, rank, size, the membership epoch, loop
  state, the last fault record, uptime, the bound port, the lane's
  queue depth, its cycles and the straggler skew;
- ``/metrics``: the Prometheus text of a fresh snapshot
  (``exporters._flatten_prom``);
- ``/events?n=``: the newest n events of the ring (default 256);
- ``/requests``: in-flight serving requests: an empty list until the
  port serves requests on the lane (ROADMAP.md A6, A12);
- ``/stacks``: every Python thread's stack (``faulthandler``).

The reference's serving and fleet fields and ``/fleet`` wait for A6
and A12; its ``pending_rejoiners`` for the parole door (L5b).
"""

import faulthandler
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.telemetry.exporters import _flatten_prom

_server = None
_lock = threading.Lock()
_start_time = None


def _healthz():
    snap = basics.metrics()
    rt = basics.lane() if basics.is_initialized() else None
    return {
        "initialized": snap["initialized"],
        "rank": snap["rank"],
        "size": snap["size"] if rt is not None else -1,
        "epoch": basics.epoch(),
        "loop_failed": basics.loop_failed(),
        "last_fault": basics.last_fault(),
        "uptime_s": round(time.monotonic() - _start_time, 3),
        "debug_port": debug_port(),
        "queue_depth": rt.queue.depth() if rt is not None else 0,
        "cycles": snap["cycle"]["count"],
        "straggler_skew_ms": round(
            snap["straggler"]["skew_us"]["p90_us"] / 1000.0, 3),
    }


def _stacks():
    """Every thread's traceback, with the thread-name table."""
    names = {t.ident: f"{t.name}{' daemon' if t.daemon else ''}"
             for t in threading.enumerate()}
    with tempfile.TemporaryFile(mode="w+") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        dump = f.read()
    header = "\n".join(f"thread 0x{ident:x}: {name}"
                       for ident, name in names.items() if ident)
    return header + "\n\n" + dump


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # no per-request stderr lines
        pass

    def _reply(self, code, body, ctype="application/json"):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-Hvdtpu-Debug-Port",
                         str(self.server.server_address[1]))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        url = urlparse(self.path)
        query = parse_qs(url.query)
        try:
            if url.path in ("/healthz", "/health"):
                self._reply(200, json.dumps(_healthz()))
            elif url.path == "/metrics":
                snap = basics.metrics()
                self._reply(200, _flatten_prom(snap, snap["rank"]),
                            ctype="text/plain; version=0.0.4")
            elif url.path == "/events":
                n = int(query.get("n", ["256"])[0])
                self._reply(200, json.dumps(basics.events(n)))
            elif url.path == "/requests":
                self._reply(200, "[]")
            elif url.path == "/stacks":
                self._reply(200, _stacks(), ctype="text/plain")
            else:
                self._reply(404, json.dumps({
                    "error": f"unknown path {url.path}",
                    "endpoints": ["/healthz", "/metrics", "/events",
                                  "/requests", "/stacks"]}))
        except Exception as e:  # noqa: BLE001 — keep the server alive
            try:
                self._reply(500, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}))
            except Exception:  # noqa: BLE001 — the client went away
                pass


def start(port, host="127.0.0.1"):
    """Serve on ``port`` (exact); returns the bound port. Idempotent."""
    global _server, _start_time
    with _lock:
        if _server is None:
            _server = ThreadingHTTPServer((host, port), _Handler)
            _server.daemon_threads = True
            _start_time = time.monotonic()
            threading.Thread(target=_server.serve_forever,
                             name="hvd-torch-debug-server",
                             daemon=True).start()
        return _server.server_address[1]


def maybe_start(rank):
    """Serve iff ``HOROVOD_DEBUG_PORT`` is set and not negative: on that
    port + ``rank``, or an ephemeral port for 0."""
    base = int(os.environ.get("HOROVOD_DEBUG_PORT") or -1)
    if base < 0:
        return None
    host = os.environ.get("HOROVOD_DEBUG_HOST", "127.0.0.1")
    return start(base + rank if base else 0, host=host)


def debug_port():
    """The bound port, or None when the server is not running."""
    with _lock:
        return None if _server is None else _server.server_address[1]


def stop():
    """Shut the server down (``hvd.shutdown``); safe if never started."""
    global _server
    with _lock:
        server, _server = _server, None
    if server is not None:
        server.shutdown()
        server.server_close()
