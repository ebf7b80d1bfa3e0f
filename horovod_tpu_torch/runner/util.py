"""Launcher utilities: host parsing, the rank layout, networking.

The port's own copy of ``horovod_tpu/runner/util.py`` (``HostInfo:12``,
``SlotInfo:18``, ``parse_hosts:28``, ``parse_hostfile:43``,
``get_host_assignments:62``, ``free_port:90``, ``is_local_host:101``,
``resolvable_addr_for:111``), with the same results.
"""

import dataclasses
import socket


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int


@dataclasses.dataclass
class SlotInfo:
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int


def parse_hosts(hosts_str):
    """'host1:2,host2:4' -> [HostInfo]. A bare 'host' means 1 slot."""
    hosts = []
    for part in hosts_str.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            hosts.append(HostInfo(name, int(slots)))
        else:
            hosts.append(HostInfo(part, 1))
    return hosts


def parse_hostfile(path):
    """One 'hostname slots=N' (or 'hostname:N' or bare) a line; # comments."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "slots=" in line:
                name, _, slots = line.partition("slots=")
                hosts.append(HostInfo(name.strip(), int(slots)))
            elif ":" in line:
                name, slots = line.rsplit(":", 1)
                hosts.append(HostInfo(name.strip(), int(slots)))
            else:
                hosts.append(HostInfo(line, 1))
    return hosts


def get_host_assignments(hosts, np):
    """Fill ranks across the hosts in their order, host-major; raises if
    the hosts have fewer than ``np`` slots."""
    total = sum(h.slots for h in hosts)
    if total < np:
        raise ValueError(
            f"requested -np {np} but hosts only provide {total} slots")
    slots = []
    rank = 0
    used_hosts = []
    for cross_rank, h in enumerate(hosts):
        if rank >= np:
            break
        n_here = min(h.slots, np - rank)
        used_hosts.append((h, n_here))
        for local_rank in range(n_here):
            slots.append(SlotInfo(h.hostname, rank, local_rank, cross_rank,
                                  np, n_here, 0))
            rank += 1
    cross_size = len(used_hosts)
    for s in slots:
        s.cross_size = cross_size
    return slots


def free_port(addr="0.0.0.0"):
    s = socket.socket()
    s.bind((addr, 0))
    port = s.getsockname()[1]
    s.close()
    return port


_LOCAL_NAMES = {"localhost", "127.0.0.1", "::1"}


def is_local_host(hostname):
    if hostname in _LOCAL_NAMES:
        return True
    try:
        local = {socket.gethostname(), socket.getfqdn()}
    except OSError:
        local = set()
    return hostname in local


def resolvable_addr_for(hosts):
    """The address the workers dial for the controller: loopback when
    every host is local, else this host's primary address."""
    if all(is_local_host(h.hostname) for h in hosts):
        return "127.0.0.1"
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())
    finally:
        s.close()
