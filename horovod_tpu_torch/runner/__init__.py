"""The port's launch layer: ``horovodrun-torch`` (``launch.py``), the
in-Python launcher :func:`run`, ``mpirun``/``jsrun`` delegation, the NIC
discovery services and the elastic driver (``elastic/``).

The port's own copy of ``horovod_tpu/runner/``; it imports nothing of
the JAX package.
"""

import multiprocessing
import os

from horovod_tpu_torch.runner import util


def _worker_main(fn, args, kwargs, slot, controller_addr, controller_port,
                 extra_env, q):
    env = {
        "HOROVOD_RANK": str(slot.rank),
        "HOROVOD_SIZE": str(slot.size),
        "HOROVOD_LOCAL_RANK": str(slot.local_rank),
        "HOROVOD_LOCAL_SIZE": str(slot.local_size),
        "HOROVOD_CROSS_RANK": str(slot.cross_rank),
        "HOROVOD_CROSS_SIZE": str(slot.cross_size),
        "HOROVOD_CONTROLLER_ADDR": controller_addr,
        "HOROVOD_CONTROLLER_PORT": str(controller_port),
    }
    env.update(extra_env or {})
    os.environ.update(env)
    try:
        q.put((slot.rank, None, fn(*args, **(kwargs or {}))))
    except BaseException as e:  # noqa: BLE001 — report, don't hang the pool
        import traceback

        traceback.print_exc()
        q.put((slot.rank, f"{type(e).__name__}: {e}", None))


def run(fn, args=(), kwargs=None, np=2, env=None, start_method="spawn",
        timeout=None):
    """Run ``fn`` on ``np`` local ranks; returns the results in rank
    order (the reference's ``horovod.run`` in local mode). ``fn`` must
    be picklable (module-level). Keep ``spawn``: a forked child of a
    parent that has touched CUDA cannot use the card. A worker takes
    the card by default (``hvd.init()``); on a machine with none, ``fn``
    calls ``hvd.init(device="cpu")``."""
    ctx = multiprocessing.get_context(start_method)
    q = ctx.Queue()
    port = util.free_port()
    slots = util.get_host_assignments([util.HostInfo("localhost", np)], np)
    procs = [
        ctx.Process(target=_worker_main,
                    args=(fn, args, kwargs, s, "127.0.0.1", port, env, q))
        for s in slots
    ]
    for p in procs:
        p.start()
    results, errors = {}, {}
    try:
        for _ in range(np):
            rank, err, res = q.get(timeout=timeout)
            (errors if err else results)[rank] = err or res
            if err:
                results[rank] = None
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    if errors:
        raise RuntimeError(f"horovod_tpu_torch.run rank failures: {errors}")
    return [results[r] for r in range(np)]
