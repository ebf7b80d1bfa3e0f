"""NIC discovery before a launch: the task's side.

The port's own copy of ``horovod_tpu/runner/task_service.py``
(``HorovodRunTaskService:44``, ``discover_common_interfaces:129``): runs
briefly on every host of a job, lists its IPv4 addresses, listens for
probes, registers with the driver, takes the address table, connects to
every other task's addresses and reports which it reached. The protocol
is ``driver_service.py``'s.
"""

import socket
import threading
import time

from horovod_tpu_torch.runner.driver_service import recv_msg, send_msg


def local_addresses(port):
    """This host's non-loopback IPv4 addresses (loopback when there is
    none), from the resolver and a UDP connect, with ``port``."""
    addrs = set()
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None,
                                       socket.AF_INET):
            addrs.add(info[4][0])
    except OSError:
        pass
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        addrs.add(s.getsockname()[0])
    except OSError:
        pass
    finally:
        s.close()
    addrs.discard("127.0.0.1")
    if not addrs:
        addrs.add("127.0.0.1")
    return [(a, port) for a in sorted(addrs)]


class HorovodRunTaskService:
    """One per host. start() → registers + probes; runs in-thread."""

    def __init__(self, index, driver_addr, key, probe_timeout=2.0):
        self._index = index
        self._driver_addr = tuple(driver_addr)
        self._key = key
        self._probe_timeout = probe_timeout
        # _stopped must exist before the accept thread can observe self.
        self._stopped = False
        # Probe listener: plain TCP accept; connectability is the test.
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", 0))
        self._listener.listen(64)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    @property
    def listen_port(self):
        return self._listener.getsockname()[1]

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn, _ = self._listener.accept()
                conn.close()
            except OSError:
                return

    def _rpc(self, obj):
        with socket.create_connection(self._driver_addr, timeout=10) as s:
            send_msg(s, obj, self._key)
            f = s.makefile("rb")
            return recv_msg(f, self._key)

    def register(self):
        return self._rpc({"type": "register", "index": self._index,
                          "host": socket.gethostname(),
                          "addrs": local_addresses(self.listen_port)})

    def wait_for_table(self, timeout=60):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            reply = self._rpc({"type": "addr_table"})
            if reply and reply.get("type") == "table":
                return {int(k): v for k, v in reply["table"].items()}
            time.sleep(0.2)
        raise TimeoutError("driver never published the address table")

    def probe(self, table):
        """TCP-connect to every other task's candidate addrs; report
        which were reachable."""
        reachable = {}
        for other, info in table.items():
            if other == self._index:
                continue
            ok = []
            for ip, port in info["addrs"]:
                try:
                    with socket.create_connection(
                            (ip, port), timeout=self._probe_timeout):
                        ok.append(ip)
                except OSError:
                    pass
            reachable[other] = ok
        self._rpc({"type": "probe_result", "index": self._index,
                   "reachable": reachable})
        return reachable

    def run_discovery(self, timeout=60):
        """The task's whole flow: register, take the table, probe."""
        self.register()
        table = self.wait_for_table(timeout)
        return self.probe(table)

    def shutdown(self):
        self._stopped = True
        try:
            self._listener.close()
        except OSError:
            pass


def discover_common_interfaces(num_hosts, services_spawner, timeout=60):
    """A whole discovery round in one process: the driver, and the tasks
    ``services_spawner(driver)`` makes, each on a thread."""
    from horovod_tpu_torch.runner.driver_service import HorovodRunDriverService

    driver = HorovodRunDriverService(num_hosts)
    try:
        tasks = services_spawner(driver)
        threads = [threading.Thread(target=t.run_discovery, daemon=True)
                   for t in tasks]
        for t in threads:
            t.start()
        driver.wait_for_initial_registration(timeout)
        driver.wait_for_probe_results(timeout)
        for t in threads:
            t.join(timeout)
        return driver.get_common_interfaces()
    finally:
        driver.shutdown()
