"""The elastic rendezvous: workers register with the driver and poll for
their epoch's rank assignment.

The port's own copy of ``horovod_tpu/runner/elastic/rendezvous.py``: the
server (``_State:15``, ``_Handler:31``, ``RendezvousServer:88``, with
``start_epoch``, ``take_reregistrations``, ``forget_worker`` and a
``/kv`` store) and the client (``RendezvousClient:148``), on the
reference's wire format: JSON over HTTP, ``POST /register``, and ``GET
/assignment/<worker id>`` answering 202 until the epoch is cut. So the
port's ``ElasticDriver`` drives the reference's workers as well as the
port's, and the reference's driver the port's.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.kv = {}
        # worker_id -> info dict (host, local_rank, notify_port, epoch seen)
        self.workers = {}
        self.epoch = 0
        # epoch -> {worker_id -> assignment dict}
        self.assignments = {}
        # Workers that re-registered after already being known: an alive
        # worker re-entering rendezvous (in-process recovery) — the
        # driver must cut a fresh epoch for them even though no process
        # exited.
        self.reregistered = set()


class _Handler(BaseHTTPRequestHandler):
    state = None  # injected by RendezvousServer

    def log_message(self, *args):  # quiet
        pass

    def _send(self, code, payload=None):
        body = b"" if payload is None else json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n) or b"{}")

    def do_PUT(self):
        if self.path.startswith("/kv/"):
            with self.state.lock:
                self.state.kv[self.path[4:]] = self._body()
            return self._send(200)
        return self._send(404)

    def do_POST(self):
        if self.path == "/register":
            info = self._body()
            with self.state.lock:
                if info["worker_id"] in self.state.workers \
                        and info.get("last_epoch", 0) >= self.state.epoch:
                    # A known worker that already consumed the current
                    # epoch is waiting for a NEW one: in-process recovery.
                    # (A re-register with last_epoch < current will be
                    # satisfied by the already-published epoch.)
                    self.state.reregistered.add(info["worker_id"])
                self.state.workers[info["worker_id"]] = info
            return self._send(200)
        return self._send(404)

    def do_GET(self):
        if self.path.startswith("/kv/"):
            with self.state.lock:
                val = self.state.kv.get(self.path[4:])
            return self._send(404 if val is None else 200, val)
        if self.path.startswith("/assignment/"):
            worker_id = self.path[len("/assignment/"):]
            with self.state.lock:
                cur = self.state.assignments.get(self.state.epoch, {})
                asg = cur.get(worker_id)
            # 202: registered but this epoch's assignment isn't cut yet.
            return self._send(202 if asg is None else 200, asg)
        if self.path == "/workers":
            with self.state.lock:
                return self._send(200, self.state.workers)
        return self._send(404)


class RendezvousServer:
    """The driver's side: the worker registry, the epochs' rank
    assignments and a key-value store."""

    def __init__(self, addr="0.0.0.0"):
        self._state = _State()
        handler = type("Handler", (_Handler,), {"state": self._state})
        self._httpd = ThreadingHTTPServer((addr, 0), handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def port(self):
        return self._httpd.server_address[1]

    def registered_workers(self):
        with self._state.lock:
            return dict(self._state.workers)

    def forget_worker(self, worker_id):
        with self._state.lock:
            self._state.workers.pop(worker_id, None)
            self._state.reregistered.discard(worker_id)

    def take_reregistrations(self, satisfied_by=None):
        """Drain and return worker ids that re-registered while alive
        (in-process recovery awaiting a fresh epoch). With
        ``satisfied_by=N``, drain only workers whose awaited epoch is
        covered by the just-published epoch N (keep ones that failed
        again and already need something newer)."""
        with self._state.lock:
            if satisfied_by is None:
                out = set(self._state.reregistered)
            else:
                out = {w for w in self._state.reregistered
                       if self._state.workers.get(w, {})
                       .get("last_epoch", 0) < satisfied_by}
            self._state.reregistered -= out
            return out

    def start_epoch(self, assignments):
        """Publish a new epoch's worker_id -> assignment map; workers polling
        /assignment see it immediately. Returns the epoch number."""
        with self._state.lock:
            self._state.epoch += 1
            for asg in assignments.values():
                asg["epoch"] = self._state.epoch
            self._state.assignments[self._state.epoch] = dict(assignments)
            return self._state.epoch

    @property
    def epoch(self):
        with self._state.lock:
            return self._state.epoch

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()




class RendezvousClient:
    """Worker-side helper for register and assignment polling."""

    def __init__(self, addr, port):
        self.addr = addr
        self.port = int(port)

    def _url(self, path):
        return f"http://{self.addr}:{self.port}{path}"

    def _request(self, method, path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(self._url(path), data=data,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                body = resp.read()
                return resp.status, json.loads(body) if body else None
        except urllib.error.HTTPError as e:  # a non-2xx status
            return e.code, None

    def register(self, worker_id, host, local_rank, notify_port,
                 last_epoch=0):
        """``last_epoch``: the newest epoch this worker has consumed; the
        driver cuts a fresh epoch only for a worker that already consumed
        the current one (an in-process recovery)."""
        code, _ = self._request("POST", "/register", {
            "worker_id": worker_id, "host": host,
            "local_rank": local_rank, "notify_port": notify_port,
            "last_epoch": int(last_epoch)})
        if code != 200:
            raise RuntimeError(f"rendezvous register failed: HTTP {code}")

    def poll_assignment(self, worker_id, timeout, min_epoch=0,
                        interval=0.25):
        """This worker's assignment for an epoch >= ``min_epoch``, once
        published. A worker that saw a peer fail before the driver did
        must not take the old epoch again: it names the dead worker and
        a stale controller endpoint."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            code, asg = self._request("GET", f"/assignment/{worker_id}")
            if code == 200 and asg.get("epoch", 0) >= min_epoch:
                return asg
            time.sleep(interval)
        raise TimeoutError(
            f"no rendezvous assignment for {worker_id} (epoch >= "
            f"{min_epoch}) within {timeout}s")

    def kv_put(self, key, value):
        self._request("PUT", f"/kv/{key}", value)

    def kv_get(self, key):
        code, val = self._request("GET", f"/kv/{key}")
        return val if code == 200 else None
