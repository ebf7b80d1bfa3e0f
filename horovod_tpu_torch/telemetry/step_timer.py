"""Per-step wall time, MFU, goodput and pipeline-bubble accounting.

The port's own copy of ``horovod_tpu/telemetry/step_timer.py``.
:class:`StepTimer` relates the lane's counters (``telemetry.core``) to
steps: wall time a step, model-FLOPs utilization, wire goodput, the
collective bytes a step against a prediction (``telemetry.predict``),
and the overlap ledger's rows of the windows its own marks open.

The FLOP source differs from the JAX package's, which reads
``compiled.cost_analysis()``: the port has no compiled program, so the
split step (``parallel/train_step.py telemetry=``) runs its first step
under :func:`count_flops` (``torch.utils.flop_counter``'s formulas) and
stores the count in ``flops_per_step``. The kernels sit inside
custom ops the counter sees as single ops, each with a registered
formula that counts exactly what its plain version's matmuls count on
the same inputs (``ops/flash_attention.py``, ``ops/grouped_moe.py``,
``models/llama.py``), so a step on the card and the same step on the
CPU report the same count. The counter counts matmuls, convolutions and
attention, not elementwise work: XLA's cost analysis counts both. It
uses ``FlopCounterMode``'s formulas but not its decomposition of ops it
has no formula for, which would change the counted step's rounding
(:func:`count_flops`).

``block=True`` synchronizes the CUDA devices of the step's output
tensors before the clock stops; the peak FLOP/s for :meth:`mfu` is that
device's (:data:`PEAK_FLOPS` by ``torch.cuda.get_device_name``), the
CPU's otherwise. The bubble helpers compare a measured pipeline idle
share with ``parallel.pipeline``'s schedules.
"""

import time

from horovod_tpu_torch.telemetry import core as _core

# Peak dense bf16 FLOP/s by device name, substring-matched: the H100
# SXM's data sheet ("NVIDIA H100 80GB HBM3"), and the CPU's as the JAX
# package's table has it. Another card needs StepTimer(peak_flops=).
PEAK_FLOPS = {"h100": 989e12, "cpu": 1e12}


def device_peak_flops(device=None):
    """The peak of ``device`` (a CUDA device by its name; anything else
    is the CPU's)."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return PEAK_FLOPS["cpu"]
    name = torch.cuda.get_device_name(torch.device(device)).lower()
    return next((v for k, v in PEAK_FLOPS.items() if k in name),
                PEAK_FLOPS["cpu"])


def count_flops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), FLOPs it ran)``: every dispatcher op it
    runs (its backward passes included) counted by the formula
    ``torch.utils.flop_counter`` registers for it (matmuls, convolutions,
    attention, the port's custom ops), ops without one counting zero.

    ``FlopCounterMode`` itself counts with the same formulas, but it runs
    an op without a formula through that op's Python decomposition when
    it has one (``silu_backward`` among the split step's), which rounds
    differently from the op's kernel: the counted step would not be the
    step. This counter runs every op as it is."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Count(TorchDispatchMode):
        flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            return out

    with _Count() as counter:
        out = fn(*args, **kwargs)
    return out, counter.flops


# ---- the process's step-time EWMA -------------------------------------
# One number every observer agrees on: /healthz exports it. Fed by
# whichever StepTimer drives the loop; an EWMA so one pause does not
# move it alone.
_STEP_EWMA_ALPHA = 0.1
_step_ewma_ms = 0.0


def _update_step_ewma(ms):
    global _step_ewma_ms
    _step_ewma_ms = (ms if _step_ewma_ms == 0.0 else
                     (1 - _STEP_EWMA_ALPHA) * _step_ewma_ms
                     + _STEP_EWMA_ALPHA * ms)


def step_time_ewma_ms():
    """The process's step-time EWMA in ms (0.0 before any step)."""
    return _step_ewma_ms


def _cuda_devices(tree, found):
    """The CUDA devices of the tensors in ``tree`` (tuples, lists and
    dicts walked)."""
    import torch

    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Accumulates per-step measurements and renders one summary row::

        timer = StepTimer(flops_per_step=..., predicted_bytes_per_step=...)
        for batch in data:
            with timer.step():
                loss, carry = timer.set_outputs(step(carry, batch))
        row = timer.summary()

    ``block=True`` synchronizes the devices of the step's outputs in
    :meth:`end_step`, so a wall time means what it says. Collective
    bytes a step come from snapshots diffed at the step's bounds and
    reconcile against ``predicted_bytes_per_step``.
    """

    def __init__(self, flops_per_step=None, peak_flops=None,
                 predicted_bytes_per_step=None, block=True,
                 byte_op_classes=None):
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self.predicted_bytes_per_step = predicted_bytes_per_step
        self.block = block
        self.byte_op_classes = byte_op_classes
        self.step_times = []
        self.bytes_per_step = []
        # (tx, tx_logical) deltas a step (core.wire_bytes).
        self.wire_bytes_per_step = []
        # (intra_tx, intra_tx_logical, cross_tx, cross_tx_logical)
        # deltas a step (core.wire_plane_bytes).
        self.plane_bytes_per_step = []
        # {plane: (exposed_us, hidden_us, total_us)} a step: the ledger's
        # fold of the window this timer's marks opened.
        self.overlap_per_step = []
        self.device = None   # the last step's outputs' CUDA device
        self._step_id = None
        self._t0 = None
        self._bytes0 = None
        self._wire0 = None
        self._plane0 = None
        self._outputs = None

    # -- per-step recording ---------------------------------------------

    def _read_bytes(self):
        # One snapshot serves every read.
        try:
            snap = _core.snapshot()
        except Exception:  # noqa: BLE001 — no lane: the wall clock still
            return None, None, None, None
        return (_core.total_collective_bytes(
                    snap, op_classes=self.byte_op_classes),
                _core.wire_bytes(snap), _core.wire_plane_bytes(snap),
                _core.wire_overlap(snap))

    def start_step(self):
        self._bytes0, self._wire0, self._plane0, _ = self._read_bytes()
        # The window opens after the byte snapshot, so it brackets what
        # this step moves.
        self._step_id = _core.step_mark(True, owner="StepTimer")
        self._t0 = time.perf_counter()

    def end_step(self, outputs=None):
        if self._t0 is None:
            raise RuntimeError("end_step() without start_step()")
        if outputs is not None:
            devices = _cuda_devices(outputs, set())
            if devices:
                self.device = min(devices, key=str)
                if self.block:
                    import torch

                    for device in devices:
                        torch.cuda.synchronize(device)
        self.step_times.append(time.perf_counter() - self._t0)
        _update_step_ewma(self.step_times[-1] * 1000.0)
        # Close the window before the snapshot: the ledger folds the
        # step's spans at the close.
        if self._step_id is not None:
            # One owner a window: a window another driver re-opened mid
            # step would book a half window as the whole step.
            owner = _core.window_owner()
            if owner != "StepTimer":
                self._step_id = None
                self._t0 = None
                raise RuntimeError(
                    "StepTimer.end_step(): the step window this timer "
                    f"opened is now owned by {owner!r}: two step drivers "
                    "mark boundaries in the same iteration; scope the "
                    "step with one of them (the StepTimer or the fused "
                    "optimizer's implicit boundary)")
            _core.step_mark(False)
        b1, w1, p1, ov = self._read_bytes()
        if self._bytes0 is not None and b1 is not None:
            self.bytes_per_step.append(b1 - self._bytes0)
        if self._wire0 is not None and w1 is not None:
            self.wire_bytes_per_step.append(
                (w1[0] - self._wire0[0], w1[1] - self._wire0[1]))
        if self._plane0 is not None and p1 is not None:
            self.plane_bytes_per_step.append(
                tuple(a - b for a, b in zip(p1, self._plane0)))
        if self._step_id is not None and ov:
            self.overlap_per_step.append({
                plane: (ov[plane]["last_exposed_us"],
                        ov[plane]["last_hidden_us"],
                        ov[plane]["last_total_us"])
                for plane in ("intra", "cross") if plane in ov})
        self._step_id = None
        self._t0 = None

    class _Step:
        def __init__(self, timer):
            self._timer = timer

        def __enter__(self):
            self._timer.start_step()
            return self._timer

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None:
                self._timer.end_step(self._timer._outputs)
            self._timer._outputs = None
            return False

    def step(self):
        """A context manager timing one step; hand its outputs over with
        :meth:`set_outputs` inside the ``with`` body to block on them."""
        return StepTimer._Step(self)

    def set_outputs(self, outputs):
        self._outputs = outputs
        return outputs

    def wrap(self, step_fn):
        """``step_fn(carry, batch) -> (loss, carry)`` timed a call."""
        def timed_step(carry, batch):
            self.start_step()
            out = step_fn(carry, batch)
            self.end_step(out)
            return out

        return timed_step

    # -- aggregates ------------------------------------------------------

    @property
    def steps(self):
        return len(self.step_times)

    def mean_step_s(self, skip_first=True):
        """Mean step wall time; the first step is dropped by default (it
        carries the FLOP count, the kernels' first launches and the
        allocator's warm-up)."""
        times = self.step_times
        if skip_first and len(times) > 1:
            times = times[1:]
        return sum(times) / len(times) if times else None

    def mfu(self, skip_first=True):
        dt = self.mean_step_s(skip_first)
        if not dt or not self.flops_per_step:
            return None
        peak = self.peak_flops or device_peak_flops(self.device)
        return self.flops_per_step / dt / peak

    def measured_bytes_per_step(self, skip_first=True):
        vals = self.bytes_per_step
        if skip_first and len(vals) > 1:
            vals = vals[1:]
        return sum(vals) / len(vals) if vals else None

    def byte_reconciliation(self):
        """Measured / predicted collective bytes a step (1.0: the
        prediction and the counters agree)."""
        measured = self.measured_bytes_per_step()
        if not measured or not self.predicted_bytes_per_step:
            return None
        return measured / self.predicted_bytes_per_step

    def wire_goodput_gbps(self, skip_first=True):
        """Collective payload a second of step wall time, GB/s (logical
        bytes: a codec makes the wire cheaper, not the payload
        smaller)."""
        dt = self.mean_step_s(skip_first)
        bytes_ = self.measured_bytes_per_step(skip_first)
        if not dt or bytes_ is None:
            return None
        return bytes_ / dt / 1e9

    def wire_compression_ratio(self, skip_first=True):
        """Wire bytes / full-width bytes over the recorded steps."""
        vals = self.wire_bytes_per_step
        if skip_first and len(vals) > 1:
            vals = vals[1:]
        tx = sum(w[0] for w in vals)
        txl = sum(w[1] for w in vals)
        return tx / txl if txl else None

    def plane_wire_summary(self, skip_first=True):
        """``{plane: {tx_bytes_per_step, goodput_gbps,
        compression_ratio}}`` for ``intra`` and ``cross`` over the
        recorded steps, or None."""
        vals = self.plane_bytes_per_step
        if skip_first and len(vals) > 1:
            vals = vals[1:]
        if not vals:
            return None
        dt = self.mean_step_s(skip_first)
        n = len(vals)
        out = {}
        for plane, (itx, itxl) in (("intra", (0, 1)), ("cross", (2, 3))):
            tx = sum(v[itx] for v in vals)
            txl = sum(v[itxl] for v in vals)
            out[plane] = {
                "tx_bytes_per_step": tx / n,
                "goodput_gbps": (tx / n / dt / 1e9) if dt else None,
                "compression_ratio": (tx / txl) if txl else None,
            }
        return out

    def overlap_summary(self, skip_first=True):
        """``{plane: {mean_exposed_wire_ms, mean_hidden_wire_ms,
        mean_total_wire_ms, overlap_efficiency}}`` over the recorded
        steps, and the combined ``overlap_efficiency``; None before a
        step recorded ledger rows. ``exposed`` is wire time while a
        caller sat blocked in a wait, ``hidden = total - exposed``."""
        vals = self.overlap_per_step
        if skip_first and len(vals) > 1:
            vals = vals[1:]
        if not vals:
            return None
        n = len(vals)
        out = {}
        all_exp = all_tot = 0
        for plane in ("intra", "cross"):
            exp = sum(v[plane][0] for v in vals if plane in v)
            hid = sum(v[plane][1] for v in vals if plane in v)
            tot = sum(v[plane][2] for v in vals if plane in v)
            all_exp += exp
            all_tot += tot
            out[plane] = {
                "mean_exposed_wire_ms": exp / 1000.0 / n,
                "mean_hidden_wire_ms": hid / 1000.0 / n,
                "mean_total_wire_ms": tot / 1000.0 / n,
                "overlap_efficiency": (hid / tot) if tot else 0.0,
            }
        out["overlap_efficiency"] = (
            (all_tot - all_exp) / all_tot if all_tot else 0.0)
        return out

    def summary(self):
        """One JSON-ready row of everything the timer knows."""
        snap = None
        try:
            snap = _core.snapshot()
        except Exception:  # noqa: BLE001
            pass
        row = {
            "steps": self.steps,
            "mean_step_s": self.mean_step_s(),
            "mfu": self.mfu(),
            "flops_per_step": self.flops_per_step,
            "bytes_per_step": self.measured_bytes_per_step(),
            "predicted_bytes_per_step": self.predicted_bytes_per_step,
            "byte_reconciliation": self.byte_reconciliation(),
            "wire_goodput_gbps": self.wire_goodput_gbps(),
            "wire_compression_ratio": self.wire_compression_ratio(),
            "plane_wire": self.plane_wire_summary(),
            "overlap": self.overlap_summary(),
        }
        if snap and snap.get("initialized"):
            row["cache_hit_rate"] = snap["cache"]["hit_rate"]
            row["cycle_stalls"] = snap["cycle"]["stalls"]
        return row


# ---- pipeline bubble accounting ---------------------------------------


def analytic_bubble(schedule, S, M, num_virtual=1):
    """The schedule's predicted idle share (``gpipe``, ``1f1b``,
    ``interleaved_1f1b``; the last from ``parallel.pipeline``'s slot
    table)."""
    if schedule == "gpipe":
        return 2 * (S - 1) / (2 * M + 2 * (S - 1))
    if schedule == "1f1b":
        return 2 * (S - 1) / (M + 2 * (S - 1))
    if schedule == "interleaved_1f1b":
        from horovod_tpu_torch.parallel.pipeline import (
            build_interleaved_schedule,
        )

        return build_interleaved_schedule(S, num_virtual, M).bubble_fraction
    raise ValueError(f"unknown schedule {schedule!r}")


def measured_bubble(step_time_s, subtick_time_s, M, num_virtual=1):
    """Measured idle share: a stage runs ``2*M*V`` useful subticks a
    step; the rest of the step's wall time is bubble (and comms)."""
    work = 2.0 * M * num_virtual * subtick_time_s
    if step_time_s <= 0:
        raise ValueError("step_time_s must be positive")
    return max(0.0, 1.0 - work / step_time_s)


def bubble_report(schedule, S, M, num_virtual, step_time_s,
                  subtick_time_s):
    """Measured against analytic bubble for one pipeline configuration;
    ``excess`` is what the schedule does not explain."""
    measured = measured_bubble(step_time_s, subtick_time_s, M,
                               num_virtual)
    analytic = analytic_bubble(schedule, S, M, num_virtual)
    return {
        "schedule": schedule, "S": S, "M": M, "V": num_virtual,
        "measured_bubble": round(measured, 4),
        "analytic_bubble": round(analytic, 4),
        "excess": round(measured - analytic, 4),
        "step_time_s": step_time_s,
        "subtick_time_s": subtick_time_s,
    }
