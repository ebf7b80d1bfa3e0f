"""The Chrome-trace timeline of each tensor's way through the lane.

Counterpart of ``csrc/timeline.{h,cc}`` (``HOROVOD_TIMELINE``,
``hvd.start_timeline``). Per tensor, on its own row: ``QUEUED`` (an
instant, at enqueue), ``NEGOTIATE`` (begin when the lane thread takes
its request, end when its response comes back), the activities of its
response (``MEMCPY_IN_FUSION_BUFFER``, the collective,
``MEMCPY_OUT_FUSION_BUFFER``; each ended by an ``ACTIVITY`` end event)
and ``DONE``; with mark-cycles a ``CYCLE`` instant opens every lane
cycle. Collectives are named for the transport that runs them, as
upstream Horovod names them: ``NCCL_ALLREDUCE``, ``GLOO_ALLREDUCE``,
``NCCL_BCAST`` and so on (the reference's host lane writes ``RING_*``).
The header is a ``CLOCK_SYNC`` instant at ts 0 carrying the wall clock
in unix microseconds, then the ``process_name`` metadata.

Times are host times (steady clock, microseconds from the start): on
the card an activity spans the host's queuing of its work, not the
work itself, so recording adds no host synchronisation. A writer thread
does the file I/O, so the lane thread never blocks on it; it wakes every
50 ms (and on ``flush`` and ``stop``), not at each event, which would
hand it the interpreter's lock at every event. The file is valid JSON
at every instant: each batch of events is written in one
``pwrite`` together with the closing ``{}]``, over the previous close.
"""

import json
import os
import threading
import time
import zlib

_WRITE_PERIOD_S = 0.05


class Timeline:
    def __init__(self):
        self.enabled = False
        self.mark_cycles = False
        self._cv = threading.Condition()
        self._queue = []
        self._written = 0       # events handed to the file so far
        self._queued = 0
        self._writer = None
        self._fd = None

    def start(self, path, rank, mark_cycles=False):
        """Start writing to ``path`` (truncated); a running timeline is
        stopped first."""
        self.stop()
        fd = os.open(str(path), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        self._rank = rank
        self._start_us = time.monotonic_ns() // 1000
        unix_us = time.time_ns() // 1000
        head = ("[\n"
                f'{{"name": "CLOCK_SYNC", "ph": "i", "ts": 0, "pid": {rank}, '
                f'"tid": 0, "s": "p", "args": {{"unix_us": {unix_us}, '
                f'"rank": {rank}}}}},\n'
                f'{{"name": "process_name", "ph": "M", "pid": {rank}, '
                f'"args": {{"name": "rank {rank}"}}}},\n').encode()
        os.pwrite(fd, head + b"{}]\n", 0)
        self._fd, self._pos = fd, len(head)
        self._stop = False
        self._queue, self._queued, self._written = [], 0, 0
        self.mark_cycles = mark_cycles
        self._writer = threading.Thread(target=self._write_loop,
                                        name="hvd-torch-timeline",
                                        daemon=True)
        self._writer.start()
        self.enabled = True

    def stop(self):
        """Write what is queued and close the file."""
        if not self.enabled:
            return
        self.enabled = False
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._writer.join()
        os.close(self._fd)
        self._writer = self._fd = None

    def flush(self, timeout=10.0):
        """Wait until every event emitted so far is in the file."""
        with self._cv:
            target = self._queued
            self._cv.notify_all()
            self._cv.wait_for(lambda: self._written >= target, timeout)

    def _write_loop(self):
        with self._cv:
            while True:
                if not self._stop:
                    self._cv.wait(_WRITE_PERIOD_S)
                batch, self._queue = self._queue, []
                if batch:
                    self._cv.release()
                    try:
                        data = "".join(batch).encode()
                        os.pwrite(self._fd, data + b"{}]\n", self._pos)
                        self._pos += len(data)
                    finally:
                        self._cv.acquire()
                    self._written += len(batch)
                self._cv.notify_all()
                if self._stop and not self._queue:
                    return

    def _emit(self, tensor, phase, label):
        if not self.enabled:
            return
        ts = time.monotonic_ns() // 1000 - self._start_us
        # A stable row per tensor, as the reference's hash % 997.
        tid = zlib.crc32(tensor.encode()) % 997
        line = (f'{{"name": "{label}", "ph": "{phase}", "ts": {ts}, '
                f'"pid": {self._rank}, "tid": {tid}, '
                f'"args": {{"tensor": {json.dumps(tensor)}}}}},\n')
        with self._cv:
            self._queue.append(line)
            self._queued += 1

    def mark_cycle(self):
        self._emit("__cycle__", "i", "CYCLE")

    def negotiate_start(self, tensor):
        self._emit(tensor, "B", "NEGOTIATE")

    def negotiate_end(self, tensor):
        self._emit(tensor, "E", "NEGOTIATE")

    def entry_queued(self, tensor):
        self._emit(tensor, "i", "QUEUED")

    def activity_start(self, tensor, activity):
        self._emit(tensor, "B", activity)

    def activity_end(self, tensor):
        self._emit(tensor, "E", "ACTIVITY")

    def entry_done(self, tensor):
        self._emit(tensor, "i", "DONE")
