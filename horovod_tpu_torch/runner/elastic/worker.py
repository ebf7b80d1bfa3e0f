"""A worker's listener for the elastic driver's notifications.

The port's own copy of ``horovod_tpu/runner/elastic/worker.py``
(``WorkerNotificationManager:14``, ``notify_worker:80``): the driver
posts ``/notify`` to each worker when the host set changes; the worker
latches the flag and raises ``HostsUpdatedInterrupt`` at its next
commit.
"""

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class WorkerNotificationManager:
    """One per worker process: listens for the driver's notifications
    and latches a hosts-updated flag that elastic states consume."""

    def __init__(self):
        self._lock = threading.Lock()
        self._httpd = None
        self._hosts_updated = False
        self._skip_sync = False

    def init(self, addr="0.0.0.0"):
        with self._lock:
            if self._httpd is not None:
                return self.port
        manager = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                if self.path == "/notify":
                    n = int(self.headers.get("Content-Length", 0))
                    event = json.loads(self.rfile.read(n) or b"{}")
                    manager.handle_hosts_updated(
                        skip_sync=bool(event.get("skip_sync", False)))
                    self.send_response(200)
                else:
                    self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()

        httpd = ThreadingHTTPServer((addr, 0), Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        with self._lock:
            self._httpd = httpd
        return self.port

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else None

    def handle_hosts_updated(self, skip_sync=False):
        with self._lock:
            self._hosts_updated = True
            self._skip_sync = skip_sync

    def poll_hosts_updated(self):
        """Consume the latched flag: (updated, skip_sync)."""
        with self._lock:
            updated, skip = self._hosts_updated, self._skip_sync
            self._hosts_updated = False
            self._skip_sync = False
            return updated, skip


notification_manager = WorkerNotificationManager()


def notify_worker(host, port, skip_sync=False, timeout=5):
    """The driver's side: ping one worker's notification service."""
    data = json.dumps({"skip_sync": skip_sync}).encode()
    req = urllib.request.Request(f"http://{host}:{port}/notify", data=data,
                                 method="POST")
    try:
        urllib.request.urlopen(req, timeout=timeout)
        return True
    except OSError:
        return False
