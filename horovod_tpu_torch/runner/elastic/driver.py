"""The elastic driver: keeps the worker fleet matched to the discovered
hosts.

The port's own copy of ``horovod_tpu/runner/elastic/driver.py``
(``ElasticDriver:50``: ``wait_for_available_slots:84``, ``_monitor:132``,
``_spawn:154``, ``_on_worker_exit:199``, ``_reconcile:221``,
``_cut_epoch:312``). It gives each worker what the port's worker reads
(``common/elastic.py init``): ``HOROVOD_ELASTIC``,
``HOROVOD_WORKER_ID``, ``HOROVOD_HOSTNAME`` and the rendezvous's
``HOROVOD_RDZV_ADDR``/``PORT``, and its spawn slot on the host,
``HOROVOD_ELASTIC_SLOT``; the worker then takes its epoch's layout and
controller endpoint, and ``HOROVOD_ELASTIC_EPOCH``, from the
rendezvous. On the card each worker's slot picks its card
(``cuda:{slot}``): a survivor's ``local_rank`` can change at a new
epoch (the layout numbers a host's workers by spawn age), its card and
the state restored onto it do not.

Lifecycle per epoch:
  1. reconcile: kill workers on removed hosts, spawn workers for empty
     slots (capped at max_np), notify surviving workers if topology grew;
  2. wait until every alive worker has registered with the rendezvous;
  3. publish epoch assignments (rank/local/cross layout + a fresh
     controller endpoint); resetting workers pick them up and re-init.
A worker's failure shows as its process's exit: its peers' lane raises
HorovodInternalError and they re-enter the rendezvous; the driver
respawns the slot (or goes on smaller if the host is gone, down to
min_np).
"""

import itertools
import os
import shlex
import sys
import threading
import time
import uuid

from horovod_tpu_torch.runner import safe_shell_exec, util
from horovod_tpu_torch.runner.elastic.discovery import HostManager
from horovod_tpu_torch.runner.elastic.rendezvous import RendezvousServer
from horovod_tpu_torch.runner.elastic.worker import notify_worker

_FAILURES_TO_BLACKLIST = 3


_spawn_seq = itertools.count()


class _Worker:
    def __init__(self, worker_id, host, local_index):
        self.worker_id = worker_id
        self.host = host
        self.local_index = local_index  # slot on its host at spawn time
        self.seq = next(_spawn_seq)     # spawn age: survivors < respawns
        self.kill_event = threading.Event()
        self.driver_killed = False      # deliberate kill, not a failure
        self.thread = None
        self.exit_code = None


class ElasticDriver:
    def __init__(self, discovery, command, min_np, max_np=None,
                 poll_interval=2.0, start_timeout=60, env=None, verbose=False):
        self._manager = HostManager(discovery)
        self._command = list(command)
        self._min_np = min_np
        self._max_np = max_np or 10 ** 9
        self._poll_interval = poll_interval
        self._start_timeout = start_timeout
        self._extra_env = dict(env or {})
        self._verbose = verbose

        self._rendezvous = RendezvousServer()
        self._lock = threading.RLock()
        self._workers = {}           # worker_id -> _Worker (alive)
        self._host_failures = {}
        self._shutdown = threading.Event()
        self._reconcile_needed = threading.Event()
        self._epoch_cut = threading.Event()
        self._final_codes = []

    # ---- public API -----------------------------------------------------

    @property
    def rendezvous(self):
        return self._rendezvous

    def start(self):
        self._manager.update_available_hosts()
        self.wait_for_available_slots(self._min_np)
        self._reconcile()
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()

    def wait_for_available_slots(self, min_np, timeout=None):
        """Block until discovery reports at least min_np slots."""
        deadline = time.monotonic() + (timeout or self._start_timeout)
        while self._manager.slot_count() < min_np:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {self._manager.slot_count()} slots available "
                    f"after {self._start_timeout}s; need {min_np}")
            time.sleep(self._poll_interval / 4)
            self._manager.update_available_hosts()

    def wait_for_completion(self):
        """Block until the fleet has exited; returns 0 on success."""
        while True:
            with self._lock:
                # The job is over only when workers finished (or failed)
                # on their own: an empty fleet with NO final codes means
                # every worker was driver-killed (e.g. a transient empty
                # discovery result) — keep waiting for discovery to
                # restore hosts and the monitor to respawn.
                if not self._workers \
                        and not self._reconcile_needed.is_set() \
                        and self._final_codes:
                    break
            if self._shutdown.is_set():
                break
            time.sleep(0.25)
        self._shutdown.set()
        with self._lock:
            codes = list(self._final_codes)
        return 0 if codes and all(c == 0 for c in codes) else 1

    def stop(self):
        """Kill every live worker's process group and wait for it (at
        most the grace period and a little), then stop the rendezvous."""
        self._shutdown.set()
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            w.driver_killed = True
            w.kill_event.set()
        for w in workers:
            if w.thread is not None:
                w.thread.join(safe_shell_exec.GRACEFUL_TERMINATION_TIME_S + 5)
        self._rendezvous.stop()

    # ---- internals ------------------------------------------------------

    def _rdzv_addr(self):
        hosts = [util.HostInfo(h, s)
                 for h, s in self._manager.current_hosts.items()]
        return util.resolvable_addr_for(hosts)

    def _monitor(self):
        while not self._shutdown.is_set():
            time.sleep(self._poll_interval)
            try:
                changed, added, removed = \
                    self._manager.update_available_hosts()
            except Exception as e:  # discovery script hiccup: keep last view
                if self._verbose:
                    print(f"[elastic driver] discovery failed: {e}",
                          file=sys.stderr)
                continue
            rereg = self._rendezvous.take_reregistrations()
            # _reconcile_needed marks an explicit retry request (worker
            # failure, cut timeout, min_np guard) whose epoch was never
            # published — those must cut even if the fleet looks
            # unchanged, so they count like a pending re-registration.
            needed = self._reconcile_needed.is_set()
            if changed or rereg or needed:
                self._reconcile_needed.clear()
                self._reconcile(notify=bool(added),
                                force_cut=bool(rereg) or needed)

    def _spawn(self, host, local_index):
        worker_id = f"{host}:{uuid.uuid4().hex[:8]}"
        w = _Worker(worker_id, host, local_index)

        def run():
            env = dict(os.environ)
            env.update(self._extra_env)
            env.update({
                "HOROVOD_ELASTIC": "1",
                "HOROVOD_WORKER_ID": worker_id,
                "HOROVOD_HOSTNAME": host,
                "HOROVOD_RDZV_ADDR": self._rdzv_addr(),
                "HOROVOD_RDZV_PORT": str(self._rendezvous.port),
                # The card: the slot, which a worker keeps for its life,
                # not the local rank, which can change at a new epoch.
                "HOROVOD_ELASTIC_SLOT": str(local_index),
            })
            rc = self._execute_worker(w, env)
            self._on_worker_exit(w, rc)

        w.thread = threading.Thread(target=run, daemon=True)
        with self._lock:
            self._workers[worker_id] = w
        w.thread.start()
        return w

    def _execute_worker(self, worker, env):
        """Launch one worker and block until it exits; returns its exit
        code. It execs ``self._command`` as a process (locally, or over
        ssh) and kills its process group when ``worker.kill_event`` or
        ``self._shutdown`` fires."""
        if util.is_local_host(worker.host):
            cmd = list(self._command)
        else:
            exports = " ".join(
                f"{k}={shlex.quote(v)}" for k, v in sorted(env.items())
                if k.startswith("HOROVOD_"))
            cmd = ["ssh", "-o", "StrictHostKeyChecking=no", worker.host,
                   f"cd {shlex.quote(os.getcwd())} && env {exports} "
                   + " ".join(shlex.quote(c) for c in self._command)]
        return safe_shell_exec.execute(
            cmd, env=env,
            prefix=f"[{worker.worker_id}]: " if self._verbose else b"",
            events=[worker.kill_event, self._shutdown])

    def _on_worker_exit(self, worker, rc):
        worker.exit_code = rc
        with self._lock:
            self._workers.pop(worker.worker_id, None)
            self._rendezvous.forget_worker(worker.worker_id)
            if not worker.driver_killed:
                self._final_codes.append(rc)
        if worker.driver_killed:
            # Deliberate kill (host removed / slot shrunk): not a failure
            # — must not count toward blacklisting or the job's exit code.
            return
        if rc == 0:
            # Clean finish: the job is completing; let peers finish too.
            return
        if self._shutdown.is_set():
            return
        n = self._host_failures[worker.host] = \
            self._host_failures.get(worker.host, 0) + 1
        if n >= _FAILURES_TO_BLACKLIST:
            self._manager.blacklist(worker.host)
        self._reconcile_needed.set()

    def _reconcile(self, notify=False, force_cut=False):
        """Match the fleet to the current host view and cut a new epoch."""
        # The upcoming cut covers any pending re-registrations; drain them
        # so the monitor doesn't cut a second (ghost) epoch for the same
        # recovery.
        force_cut = bool(self._rendezvous.take_reregistrations()) \
            or force_cut
        with self._lock:
            fleet_done = (not self._workers and self._final_codes
                          and all(c == 0 for c in self._final_codes))
        if fleet_done:
            # Everyone exited cleanly: the job is complete; never respawn
            # a fresh fleet into the free slots (it would re-run the job).
            return
        with self._lock:
            hosts = self._manager.current_hosts
            # Kill workers whose host vanished; on slot-count decrease
            # kill only the EXCESS count, youngest first — the oldest
            # workers hold the committed state that rank 0's sync()
            # broadcasts, so they must survive a shrink.
            killed = 0

            def _kill(w):
                nonlocal killed
                w.driver_killed = True
                w.kill_event.set()
                self._workers.pop(w.worker_id, None)
                self._rendezvous.forget_worker(w.worker_id)
                killed += 1

            per_host = {}
            for w in list(self._workers.values()):
                if w.host not in hosts:
                    _kill(w)
                else:
                    per_host.setdefault(w.host, []).append(w)
            for host, ws in per_host.items():
                ws.sort(key=lambda w: w.seq)
                for w in ws[hosts[host]:]:  # youngest beyond capacity
                    _kill(w)
            # Spawn into FREE slot indexes (a respawn reuses the slot its
            # predecessor freed), up to max_np total. A host's LIVE worker
            # count — not its free indexes — bounds spawning: after a
            # fail→respawn→shrink history a surviving oldest worker can
            # occupy local_index >= slots, leaving a lower index free on a
            # host that is already at capacity; filling it would publish
            # local_size > slots and put two ranks on one card.
            used = {}
            for w in self._workers.values():
                used.setdefault(w.host, set()).add(w.local_index)
            total = sum(len(s) for s in used.values())
            spawned = 0
            for host, slots in sorted(hosts.items()):
                for idx in range(slots):
                    if idx in used.get(host, set()):
                        continue
                    if len(used.get(host, ())) >= slots:
                        break
                    if total >= self._max_np:
                        break
                    self._spawn(host, idx)
                    used.setdefault(host, set()).add(idx)
                    total += 1
                    spawned += 1
            alive = list(self._workers.values())
        if total < self._min_np:
            if self._verbose:
                print(f"[elastic driver] {total} workers < min_np="
                      f"{self._min_np}; waiting for discovery",
                      file=sys.stderr)
            return
        if not spawned and not killed and not force_cut:
            # Nothing about the fleet changed (e.g. a discovery delta
            # while at max_np). Cutting anyway would publish a ghost
            # epoch: a later recovery would re-register with a stale
            # last_epoch, adopt the dead assignment, and burn a full
            # start-timeout round before the real recovery epoch.
            return
        if notify and spawned:
            # Notify only when capacity growth actually ADDED workers: at
            # max_np the discovery delta is unusable, and a notification
            # would tear the whole fleet down for an identically-sized
            # epoch (a re-init of every card for nothing).
            registered = self._rendezvous.registered_workers()
            for w in alive:
                info = registered.get(w.worker_id)
                if info and info.get("notify_port"):
                    notify_worker(w.host if not util.is_local_host(w.host)
                                  else "127.0.0.1", info["notify_port"])
        self._cut_epoch(alive)

    def _cut_epoch(self, workers):
        """Wait for registrations, then publish rank assignments."""
        deadline = time.monotonic() + self._start_timeout
        ids = {w.worker_id for w in workers}
        while time.monotonic() < deadline:
            registered = set(self._rendezvous.registered_workers())
            with self._lock:
                ids &= set(self._workers)  # drop workers that died meanwhile
            if not ids:
                break  # whole cohort exited; fall through to the guard
            if ids <= registered:
                break
            time.sleep(0.1)
        else:
            # Registration timeout: retry the cut only if something
            # actually failed (same rationale as the min_np guard below).
            with self._lock:
                if any(c != 0 for c in self._final_codes):
                    self._reconcile_needed.set()
            return
        with self._lock:
            workers = [self._workers[i] for i in sorted(ids)
                       if i in self._workers]
        if len(workers) < self._min_np:
            # Workers vanished while we were waiting for registrations. A
            # smaller-than-min_np epoch must never be published (it would
            # split the job into an undersized world that trains alone) —
            # but only re-reconcile if something actually FAILED; clean
            # rc==0 exits mean the job is completing, and respawning
            # would re-run the finished job.
            with self._lock:
                any_failed = any(c != 0 for c in self._final_codes)
            if any_failed:
                self._reconcile_needed.set()
            return
        # Rank layout: host-major (hierarchical allreduce requires ranks
        # contiguous per host), with hosts ordered by their oldest
        # member's spawn age and workers within a host oldest-first — so
        # rank 0 is always a SURVIVOR (its state snapshot is what sync()
        # broadcasts; a fresh respawn as rank 0 would wipe committed
        # progress with untrained weights).
        workers.sort(key=lambda w: (w.seq, w.local_index))
        host_order = {}
        for w in workers:
            host_order.setdefault(w.host, len(host_order))
        workers.sort(key=lambda w: (host_order[w.host], w.seq,
                                    w.local_index))
        by_host = {}
        for w in workers:
            by_host.setdefault(w.host, []).append(w)
        # cross_rank must agree with the rank layout above (the lane's
        # hierarchy probe: cross_rank == rank / local_size), so order
        # hosts exactly as the layout does.
        hostnames = sorted(by_host, key=lambda h: host_order[h])
        root_host = workers[0].host
        controller_addr = ("127.0.0.1" if util.is_local_host(root_host)
                           else root_host)
        controller_port = util.free_port()
        assignments = {}
        for rank, w in enumerate(workers):
            local = by_host[w.host]
            assignments[w.worker_id] = {
                "rank": rank,
                "size": len(workers),
                "local_rank": local.index(w),
                "local_size": len(local),
                "cross_rank": hostnames.index(w.host),
                "cross_size": len(hostnames),
                "controller_addr": controller_addr,
                "controller_port": controller_port,
            }
        epoch = self._rendezvous.start_epoch(assignments)
        # Survivors that re-registered while we waited for respawn
        # registrations are satisfied by the epoch just published — drain
        # their flags so the monitor doesn't cut a ghost epoch for them.
        self._rendezvous.take_reregistrations(satisfied_by=epoch)
        with self._lock:
            # Success is judged on the FINAL epoch only: a worker that died
            # and was recovered from must not fail the whole job.
            self._final_codes.clear()
        if self._verbose:
            print(f"[elastic driver] epoch {epoch}: "
                  f"{[w.worker_id for w in workers]}", file=sys.stderr)
