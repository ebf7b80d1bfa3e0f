"""Run a rank's command in its own process group and take the whole
group down with it.

The port's own copy of ``horovod_tpu/runner/safe_shell_exec.py``
(``execute:23``, ``terminate_tree:67``): each command starts in a new
session, its output is pumped line by line (optionally prefixed with
the rank), and when any of its ``events`` fires its process group is
sent SIGTERM, then SIGKILL after a grace period. On the card this is
what ends a job whose rank died: the peers sit in NCCL kernels that
never return, so the launcher must kill them rather than wait.

One addition: when the command itself exits, whatever is left of its
process group (a worker's own children) is taken down too, so that no
process of the job outlives the launcher.
"""

import os
import signal
import subprocess
import sys
import threading

GRACEFUL_TERMINATION_TIME_S = 5
WATCH_INTERVAL_S = 0.1


def _pump(stream, sink, prefix=b""):
    for line in iter(stream.readline, b""):
        sink.write(prefix + line)
        sink.flush()
    stream.close()


def execute(command, env=None, stdout=None, stderr=None, prefix=None,
            events=None):
    """Run ``command`` (a list, or a shell string) in its own process
    group; returns its exit code. Output streams line by line, with
    ``prefix`` before each line. ``events``: threading.Events; when any
    fires, the command's process group is terminated."""
    shell = isinstance(command, str)
    proc = subprocess.Popen(
        command, shell=shell, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)

    out_sink = getattr(stdout or sys.stdout, "buffer", stdout or sys.stdout)
    err_sink = getattr(stderr or sys.stderr, "buffer", stderr or sys.stderr)
    p = (prefix.encode() if isinstance(prefix, str) else prefix) or b""
    pumps = [
        threading.Thread(target=_pump, args=(proc.stdout, out_sink, p),
                         daemon=True),
        threading.Thread(target=_pump, args=(proc.stderr, err_sink, p),
                         daemon=True),
    ]
    for t in pumps:
        t.start()

    if events:
        def watch():
            while proc.poll() is None:
                if any(e.wait(WATCH_INTERVAL_S) for e in events):
                    terminate_tree(proc)
                    return
        threading.Thread(target=watch, daemon=True).start()

    proc.wait()
    # The command's session is its process group (start_new_session):
    # its pgid is its pid, valid while any member lives.
    _kill_group(proc.pid, signal.SIGKILL)
    for t in pumps:
        t.join(timeout=2)
    return proc.returncode


def _kill_group(pgid, sig):
    try:
        os.killpg(pgid, sig)
        return True
    except (ProcessLookupError, PermissionError):
        return False


def terminate_tree(proc):
    """SIGTERM the command's process group; SIGKILL after the grace
    period."""
    if not _kill_group(proc.pid, signal.SIGTERM):
        return
    try:
        proc.wait(timeout=GRACEFUL_TERMINATION_TIME_S)
    except subprocess.TimeoutExpired:
        pass
    _kill_group(proc.pid, signal.SIGKILL)
