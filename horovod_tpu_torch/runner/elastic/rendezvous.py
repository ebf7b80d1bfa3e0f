"""Rendezvous client: a worker registers with the elastic driver and
polls for its epoch's rank assignment.

The port's own copy of the worker side of
``horovod_tpu/runner/elastic/rendezvous.py`` (``RendezvousClient:148``),
on the reference's wire format (JSON over HTTP: ``POST /register``,
``GET /assignment/<worker id>`` answering 202 until the epoch is
cut), so that the reference's ``ElasticDriver``
and ``RendezvousServer`` drive the port's workers. The driver, host
discovery and the server are the launcher's (ROADMAP.md L10).
"""

import json
import time
import urllib.error
import urllib.request


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
