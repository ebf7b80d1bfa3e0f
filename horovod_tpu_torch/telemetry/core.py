"""The lane's instruments as the telemetry layer reads them.

The port's own copy of ``horovod_tpu/telemetry/core.py``, over the
registry and the event ring of ``common/basics.py``: :func:`snapshot`
(``hvd.metrics()``'s dict, ``common/metrics.py`` lists its sections)
and :func:`metrics_reset`; the byte aggregates :func:`wire_bytes`,
:func:`wire_plane_bytes` and :func:`total_collective_bytes`; the step
windows :func:`step_mark`, :func:`step_id` and :func:`window_owner`;
the overlap ledger :func:`wire_overlap`; the ring's :func:`events` and
:func:`events_drain`. Counters live for the process: consumers diff
snapshots.
"""

from horovod_tpu_torch.common import basics as _basics

#: Who opened the open step window: "StepTimer" (an explicit scope),
#: "optimizer" (the fused optimizer's implicit boundary), or None (no
#: window, or a caller that did not say). Step ids alone cannot tell a
#: driver's own window from another's that reused its id, the owner can.
_window_owner = None


def snapshot():
    """One point-in-time dict of every lane counter (valid before
    ``init``, with ``initialized: False``)."""
    return _basics.metrics()


def metrics_reset():
    """Zero the registry and forget the open window's owner (the reset
    drops the window itself)."""
    global _window_owner
    _basics.metrics_reset()
    _window_owner = None


def wire_bytes(snap=None):
    """``(tx_bytes, tx_logical_bytes)``: what crossed the wire, and the
    same traffic at full width (they differ by the codec's saving)."""
    if snap is None:
        snap = snapshot()
    w = snap.get("wire", {})
    return w.get("tx_bytes", 0), w.get("tx_logical_bytes", 0)


def wire_plane_bytes(snap=None):
    """``(intra_tx, intra_tx_logical, cross_tx, cross_tx_logical)``: the
    cross hop is booked inside the totals, so intra is total minus
    cross."""
    if snap is None:
        snap = snapshot()
    w = snap.get("wire", {})
    cross = w.get("cross_tx_bytes", 0)
    cross_l = w.get("cross_tx_logical_bytes", 0)
    return (w.get("tx_bytes", 0) - cross,
            w.get("tx_logical_bytes", 0) - cross_l, cross, cross_l)


def step_mark(begin=True, owner=None):
    """Mark a step boundary (``basics.step_mark``) and record who opened
    the window (:func:`window_owner`); a close clears the owner. Returns
    the step id."""
    global _window_owner
    sid = _basics.step_mark(begin)
    _window_owner = owner if begin else None
    return sid


def step_id():
    """The open step's id, or -1."""
    return _basics.step_id()


def window_owner():
    """Who opened the open step window, or None."""
    return _window_owner


def wire_overlap(snap=None):
    """The overlap ledger (``wire.overlap`` of the snapshot)."""
    if snap is None:
        snap = snapshot()
    return snap.get("wire", {}).get("overlap", {})


def events(last_n=0):
    """The newest ``last_n`` ring events (0: all), not consumed."""
    return _basics.events(last_n)


def events_drain():
    """Every ring event since the last drain, consumed."""
    return _basics.events_drain()


def total_collective_bytes(snap=None, planes=("ops", "device_ops"),
                           op_classes=None):
    """Payload bytes summed over op classes (all, or ``op_classes``) and
    planes of a snapshot."""
    if snap is None:
        snap = snapshot()
    total = 0
    for plane in planes:
        for op, counters in snap.get(plane, {}).items():
            if op_classes is not None and op not in op_classes:
                continue
            total += counters.get("bytes", 0)
    return total
