"""Online autotuning of the lane's fusion threshold, cycle time, wire
codec and hierarchy split.

The port's copy of ``csrc/parameter_manager.{h,cc}`` (``HOROVOD_AUTOTUNE``):
Bayesian optimization (``bayes_opt.py``) over the discrete grid of
fusion thresholds 1-64 MiB in powers of two, cycle times {0.5, 1, 2.5,
5, 10} ms, the wire codec and the hierarchy split, each window of cycles
scored by the allreduced bytes per second of wall time. It runs on the
coordinator; the chosen values ride every response list to the workers
(``controller.py``, ``operations.py``).

The codec dimension is ``{off, chosen}`` when the user chose a codec
(the tuner may settle on off, never on a codec the user did not pick),
else the one value off (``operations.cc:425-431``). The split dimension
is the splits ``basics._init_autotune`` passes: flat (left out under an
explicit ``HOROVOD_CROSS_PLANE=hier``) and every divisor d >= 2 of
``local_size`` that divides ``size`` on a hierarchical layout, else the
one value 0 (``:411-420``). The reference's ring-chunk and stripe-width
dimensions stay pinned, exactly as it pins a single-valued dimension
(one value at coordinate 0): NCCL and gloo own their chunking and
channels, so the port has no chunk or stripe to move. The log writes
``0,<codec>,<split>,1`` for them. Untuned codec and split, the grid is
the reference's 7 x 5 = 35 candidates at the same coordinates, in the
same order.

A window closes once it holds ``HOROVOD_AUTOTUNE_WINDOW_BYTES`` (1 MiB)
and ``HOROVOD_AUTOTUNE_WINDOW_CYCLES`` (20), or after 5 s. Its clock
starts where the previous window closed, so a compute phase between
bursts counts against the knobs that caused it; a gap of 5 s or more is
a stall the knobs did not cause, and the window starts fresh. The first
3 windows are thrown away (warm-up); a capped window below both floors
is thrown away too. After ``HOROVOD_AUTOTUNE_STEPS`` (20) scored windows
the knobs move to the best mean score, and the log's last row is that
converged point with its mean score. ``HOROVOD_AUTOTUNE_LOG`` names the
CSV log, in the reference's header and row format.
"""

import math
import sys
import time

from horovod_tpu_torch.common.bayes_opt import BayesOpt

FUSION_VALUES = tuple(1 << s for s in range(20, 27))   # 1 MiB .. 64 MiB
CYCLE_VALUES = (0.5, 1.0, 2.5, 5.0, 10.0)
# The pinned dimensions as the log writes them: ring chunk bytes and
# stripe width.
PINNED_CHUNK, PINNED_CHANNELS = 0, 1
HEADER = ("fusion_threshold_bytes,cycle_time_ms,ring_chunk_bytes,"
          "wire_compression,hier_split,wire_channels,score_bytes_per_sec\n")
MAX_WINDOW_S = 5.0
WARMUP_WINDOWS = 3


def _snap(values, target):
    """The index of the largest grid value not above ``target`` (0 when
    every value is above it)."""
    idx = 0
    for i, v in enumerate(values):
        if v <= target:
            idx = i
    return idx


class ParameterManager:
    """``fusion_bytes`` and ``cycle_ms`` are the starting knobs (snapped
    onto the grid); ``log_path`` the CSV log (None or "": none);
    ``clock`` returns seconds (``time.monotonic`` by default);
    ``wire_codec`` the live codec, tuned between off and it under
    ``tune_wire_codec``; ``hier_values`` the split grid (empty: pinned at
    0) and ``hier_split`` the live split."""

    def __init__(self, fusion_bytes, cycle_ms, log_path=None, max_samples=20,
                 window_bytes=1 << 20, window_cycles=20, clock=None,
                 wire_codec=0, tune_wire_codec=False, hier_values=(),
                 hier_split=0):
        self.min_window_bytes = max(int(window_bytes), 1)
        self.min_window_cycles = max(int(window_cycles), 1)
        self.max_samples = max(int(max_samples), 2)
        self._clock = clock or time.monotonic
        self.comp_values = (0, wire_codec) if tune_wire_codec and \
            wire_codec else (wire_codec,)
        self.hier_values = tuple(hier_values) or (0,)
        f_lo, f_hi = math.log2(FUSION_VALUES[0]), math.log2(FUSION_VALUES[-1])
        c_lo, c_hi = math.log2(CYCLE_VALUES[0]), math.log2(CYCLE_VALUES[-1])
        nh = len(self.hier_values)
        # Candidate ((fusion_i * |cycle| + cycle_i) * |codec| + codec_i)
        # * |split| + split_i: the reference's flattening, its chunk and
        # stripe dimensions of one value each.
        self.candidates = [
            ((math.log2(f) - f_lo) / (f_hi - f_lo),
             (math.log2(c) - c_lo) / (c_hi - c_lo), 0.0,
             1.0 if m else 0.0, hi / (nh - 1) if nh > 1 else 0.0, 0.0)
            for f in FUSION_VALUES for c in CYCLE_VALUES
            for m in self.comp_values for hi in range(nh)]
        self._opt = BayesOpt(self.candidates)
        self.fusion_idx = _snap(FUSION_VALUES, fusion_bytes)
        self.cycle_idx = _snap(CYCLE_VALUES, cycle_ms)
        self.comp_idx = self.comp_values.index(wire_codec)
        self.hier_idx = self.hier_values.index(hier_split) \
            if hier_split in self.hier_values else 0
        self.candidate = ((self.fusion_idx * len(CYCLE_VALUES) +
                           self.cycle_idx) * len(self.comp_values) +
                          self.comp_idx) * nh + self.hier_idx
        self.done = False
        self._warmup = WARMUP_WINDOWS
        self._window_bytes = self._window_cycles = 0
        self._window_start = self._window_end = None
        # The dimensions the port does not tune are said, not pretended.
        print("hvd-torch autotune: tuning the fusion threshold, the cycle "
              f"time, the wire codec over {list(self.comp_values)} and the "
              f"hierarchy split over {list(self.hier_values)}; ring chunk "
              "bytes and stripe width pinned at 0 and 1 (NCCL and gloo own "
              "them)", file=sys.stderr, flush=True)
        self._log = None
        if log_path:
            self._log = open(log_path, "w")
            self._log.write(HEADER)
            self._log.flush()

    @property
    def fusion_threshold_bytes(self):
        return FUSION_VALUES[self.fusion_idx]

    @property
    def cycle_time_ms(self):
        return CYCLE_VALUES[self.cycle_idx]

    @property
    def wire_codec(self):
        return self.comp_values[self.comp_idx]

    @property
    def hier_split(self):
        return self.hier_values[self.hier_idx]

    def close(self):
        if self._log is not None:
            self._log.close()
            self._log = None

    def _write(self, score):
        if self._log is None:
            return
        self._log.write(
            f"{self.fusion_threshold_bytes},{self.cycle_time_ms:.3f},"
            f"{PINNED_CHUNK},{self.wire_codec},{self.hier_split},"
            f"{PINNED_CHANNELS},{score:.0f}\n")
        self._log.flush()

    def move_to(self, candidate):
        """Set the knobs to ``candidate`` (``MoveTo``: the pinned
        dimensions' factors are 1)."""
        self.candidate = candidate
        candidate, self.hier_idx = divmod(candidate, len(self.hier_values))
        candidate, self.comp_idx = divmod(candidate, len(self.comp_values))
        self.fusion_idx, self.cycle_idx = divmod(candidate, len(CYCLE_VALUES))

    def score(self, bytes_per_sec):
        """Log one window's score, feed it to the optimizer, and move to
        its suggestion, or to the best point once ``max_samples`` are
        in."""
        self._write(bytes_per_sec)
        if self.done:
            return
        self._opt.add_sample(self.candidate, bytes_per_sec)
        if self._opt.num_samples >= self.max_samples:
            self.move_to(self._opt.best())
            self.done = True
            self._write(self._opt.mean_score(self.candidate))
            print(f"hvd-torch autotune converged: fusion="
                  f"{self.fusion_threshold_bytes} bytes, cycle="
                  f"{self.cycle_time_ms:.2f} ms, wire_codec="
                  f"{self.wire_codec}, hier_split={self.hier_split}",
                  file=sys.stderr, flush=True)
            return
        self.move_to(self._opt.suggest())

    def update(self, nbytes):
        """Count one cycle's allreduced bytes; True when a window closed
        and the knobs moved."""
        if self.done:
            return False
        now = self._clock()
        if self._window_start is None:
            start = self._window_end if self._window_end is not None \
                else now
            if now - start >= MAX_WINDOW_S:
                start = now
            self._window_start = start
            self._window_bytes = self._window_cycles = 0
        self._window_bytes += int(nbytes)
        self._window_cycles += 1
        secs = now - self._window_start
        full = (self._window_bytes >= self.min_window_bytes and
                self._window_cycles >= self.min_window_cycles) or \
            secs >= MAX_WINDOW_S
        if not full or secs <= 0:
            return False
        before = self.candidate
        if self._warmup > 0:
            self._warmup -= 1
        elif (self._window_bytes >= self.min_window_bytes or
              self._window_cycles >= self.min_window_cycles):
            self.score(self._window_bytes / secs)
        self._window_start = None
        self._window_end = now
        return self.candidate != before
