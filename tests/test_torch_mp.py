"""The port's spawner for multi-rank tests, whose ranks import no JAX.

``run_ranks(fn, size)`` runs ``fn(rank, size)`` in ``size`` processes
with the ``HOROVOD_*`` layout of a local world and returns the results
by rank, as ``tests/utils_mp.py run_ranks`` does for the JAX package's
lanes. The ranks are forked from a fork server that imported torch and
the port once (``PRELOAD``), and take over the parent's environment and
directory at the call; a rank imports nothing of JAX, and runs torch on
one thread (a world's ranks share the machine's cores with each other
and with the other test workers; their thread pools would spin against
each other). A rank that needs the JAX package imports it itself, on the
CPU (``JAX_PLATFORMS=cpu``). A rank unpickles
``fn`` by importing the module that defines it, so a test module whose
ranks must stay free of JAX binds the JAX package through
:func:`lazy_module`: the module is imported when an attribute is first
read, which only the parent's oracles do.

Every multi-rank test of a file joins that file's shared world (a
module-scoped fixture, one world a file and world size): a new case is
one more entry in the world's result, not a new spawn. Each spawn costs
its ranks' imports of torch and the port, several seconds of CPU a rank
on a loaded machine.

This module holds no test.
"""

import importlib
import multiprocessing as mp
import os
import socket
import sys
import traceback

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _LazyModule:
    """A module imported when one of its attributes is first read or
    set."""

    def __init__(self, name):
        object.__setattr__(self, "_name", name)

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)

    def __setattr__(self, attr, value):
        setattr(importlib.import_module(self._name), attr, value)


def lazy_module(name):
    """``name``'s module, imported at the first attribute read."""
    return _LazyModule(name)


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# What every rank imports: the fork server imports it once, nothing of
# JAX among it, and each rank is forked from the server with it loaded.
PRELOAD = ("numpy", "torch", "horovod_tpu_torch.torch",
           "horovod_tpu_torch.parallel", "horovod_tpu_torch.models")


def context():
    """The ranks' multiprocessing context: a fork server that imported
    ``PRELOAD`` at its start (one server a test process). A rank starts
    in milliseconds, where a spawned interpreter imports torch and the
    port anew, several seconds of CPU a rank on a loaded machine."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(PRELOAD))
    return ctx


def parent_state():
    """This process's environment and working directory, which a rank
    takes over (the fork server holds those of its own start)."""
    return dict(os.environ), os.getcwd()


def rank_entry(fn, rank, size, port, q, env, parent):
    """A rank: the parent's environment and directory (``parent``), the
    local world's ``HOROVOD_*`` layout, ``env`` over it, torch on one
    thread, then ``fn(rank, size)``'s result (or its error) put on
    ``q``."""
    environ, cwd = parent
    os.environ.clear()
    os.environ.update(environ)
    os.chdir(cwd)
    os.environ.update({
        "HOROVOD_RANK": str(rank),
        "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(rank),
        "HOROVOD_LOCAL_SIZE": str(size),
        "HOROVOD_CONTROLLER_ADDR": "127.0.0.1",
        "HOROVOD_CONTROLLER_PORT": str(port),
        "JAX_PLATFORMS": "cpu",
    })
    os.environ.update(env or {})
    sys.path.insert(0, REPO_ROOT)
    import torch

    # The ranks of a world share the machine's cores with each other and
    # with the other tests: one thread each.
    torch.set_num_threads(1)
    try:
        result = fn(rank, size)
        q.put((rank, None, result))
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        q.put((rank, f"{type(e).__name__}: {e}", None))


def run_ranks(fn, size, timeout=90, env=None):
    """Run ``fn(rank, size)`` on ``size`` ranks; return the results by
    rank. Raises AssertionError if any rank fails."""
    ctx = context()
    port = free_port()
    q = ctx.Queue()
    parent = parent_state()
    procs = [ctx.Process(target=rank_entry,
                         args=(fn, r, size, port, q, env, parent))
             for r in range(size)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    try:
        for _ in range(size):
            rank, err, res = q.get(timeout=timeout)
            if err is not None:
                errors[rank] = err
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=15)
            if p.is_alive():
                p.terminate()
    assert not errors, f"rank failures: {errors}"
    return [results[r] for r in range(size)]
