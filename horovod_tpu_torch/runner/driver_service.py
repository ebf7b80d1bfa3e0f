"""NIC discovery before a launch: the driver's side.

The port's own copy of ``horovod_tpu/runner/driver_service.py``
(``make_secret_key:25``, ``sign:30``, ``HorovodRunDriverService:51``): a
task service on every host registers its addresses with this driver,
the driver hands out the whole table, every task probes every other
task's addresses, and the driver intersects the results into the
addresses each host is reachable at from all others.

Protocol: newline-delimited JSON over TCP, each message signed with the
job's secret (HMAC-SHA256); a message with a bad signature is dropped
without an answer.
"""

import hmac
import hashlib
import json
import os
import socket
import socketserver
import threading


def make_secret_key():
    """A job's HMAC key."""
    return os.urandom(32).hex()


def sign(key, payload_bytes):
    return hmac.new(key.encode(), payload_bytes, hashlib.sha256).hexdigest()


def send_msg(sock, obj, key):
    body = json.dumps(obj, sort_keys=True).encode()
    frame = json.dumps({"mac": sign(key, body)}).encode() + b"\n" + body + b"\n"
    sock.sendall(frame)


def recv_msg(f, key):
    header = f.readline()
    body = f.readline()
    if not header or not body:
        return None
    mac = json.loads(header)["mac"]
    if not hmac.compare_digest(mac, sign(key, body.rstrip(b"\n"))):
        raise PermissionError("bad message HMAC (wrong job secret?)")
    return json.loads(body)


class HorovodRunDriverService:
    """Collects task registrations, orchestrates cross-host probing, and
    exposes the common routable interface set."""

    def __init__(self, num_hosts, key=None):
        self._num_hosts = num_hosts
        self._key = key or make_secret_key()
        self._registered = {}      # index -> {"host":…, "addrs":[(ip,port)…]}
        self._probe_results = {}   # index -> {other_index: [reachable addrs]}
        self._cv = threading.Condition()
        svc = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    msg = recv_msg(self.rfile, svc._key)
                except PermissionError:
                    return
                if msg is None:
                    return
                reply = svc._dispatch(msg)
                if reply is not None:
                    send_msg(self.connection, reply, svc._key)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(("0.0.0.0", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def key(self):
        return self._key

    @property
    def addresses(self):
        return ("127.0.0.1", self._server.server_address[1])

    @property
    def port(self):
        return self._server.server_address[1]

    def _dispatch(self, msg):
        kind = msg.get("type")
        with self._cv:
            if kind == "register":
                self._registered[msg["index"]] = {
                    "host": msg["host"], "addrs": msg["addrs"]}
                self._cv.notify_all()
                return {"type": "ack"}
            if kind == "addr_table":
                # Task polls for the full table once everyone registered.
                if len(self._registered) < self._num_hosts:
                    return {"type": "wait"}
                return {"type": "table",
                        "table": {str(k): v for k, v in
                                  self._registered.items()}}
            if kind == "probe_result":
                self._probe_results[msg["index"]] = {
                    int(k): v for k, v in msg["reachable"].items()}
                self._cv.notify_all()
                return {"type": "ack"}
        return {"type": "error", "error": f"unknown message {kind!r}"}

    def wait_for_initial_registration(self, timeout=60):
        with self._cv:
            ok = self._cv.wait_for(
                lambda: len(self._registered) >= self._num_hosts, timeout)
        if not ok:
            missing = self._num_hosts - len(self._registered)
            raise TimeoutError(
                f"{missing} task service(s) never registered with the "
                f"driver within {timeout}s")

    def wait_for_probe_results(self, timeout=60):
        with self._cv:
            ok = self._cv.wait_for(
                lambda: len(self._probe_results) >= self._num_hosts, timeout)
        if not ok:
            raise TimeoutError("probe results incomplete")

    def get_common_interfaces(self):
        """The addresses of each host reachable from every other host:
        {index: [ip, ...]}."""
        common = {}
        for target, info in self._registered.items():
            addrs = {a[0] for a in info["addrs"]}
            for prober, results in self._probe_results.items():
                if prober == target:
                    continue
                addrs &= set(results.get(target, []))
            common[target] = sorted(addrs)
        return common

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
