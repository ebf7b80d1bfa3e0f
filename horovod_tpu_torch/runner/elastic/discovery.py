"""Host discovery for elastic jobs.

The port's own copy of ``horovod_tpu/runner/elastic/discovery.py``
(``HostDiscoveryScript:13``, ``FixedHosts:36``, ``HostManager:47``): a
user's executable prints the current hosts, one ``hostname:slots`` a
line; the driver polls it and reacts to hosts added and removed. A host
that fails repeatedly is blacklisted.
"""

import subprocess
import threading


class HostDiscoveryScript:
    """Runs the user's discovery executable and parses host:slots lines."""

    def __init__(self, script, default_slots=1):
        self.script = script
        self.default_slots = default_slots

    def find_available_hosts_and_slots(self):
        out = subprocess.run([self.script], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        hosts = {}
        for line in out.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if ":" in line:
                name, slots = line.rsplit(":", 1)
                hosts[name] = int(slots)
            else:
                hosts[line] = self.default_slots
        return hosts


class FixedHosts:
    """Fixed 'discovery' from -H/--hostfile: elastic min/max without a
    script is failure recovery over a fixed pool."""

    def __init__(self, hosts):
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self):
        return dict(self._hosts)


class HostManager:
    """The live host set and the failure blacklist."""

    def __init__(self, discovery):
        self._discovery = discovery
        self._lock = threading.Lock()
        self._blacklist = set()
        self._current = {}

    def update_available_hosts(self):
        """Re-run discovery; returns (changed, added, removed). ``added``
        lists hosts whose capacity GREW — a brand-new host or extra slots
        on a known one both count (workers must be notified either way,
        or they keep training at the old size while new slots idle)."""
        found = self._discovery.find_available_hosts_and_slots()
        with self._lock:
            found = {h: s for h, s in found.items()
                     if h not in self._blacklist}
            added = sorted(h for h, s in found.items()
                           if s > self._current.get(h, 0))
            removed = sorted(set(self._current) - set(found))
            changed = bool(added or removed) or found != self._current
            self._current = found
            return changed, added, removed

    def blacklist(self, host):
        with self._lock:
            self._blacklist.add(host)
            self._current.pop(host, None)

    def is_blacklisted(self, host):
        with self._lock:
            return host in self._blacklist

    @property
    def current_hosts(self):
        with self._lock:
            return dict(self._current)

    def slot_count(self):
        with self._lock:
            return sum(self._current.values())
