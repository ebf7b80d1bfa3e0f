"""The port's autotuner (``common/bayes_opt.py``,
``common/parameter_manager.py``) against the reference's C++
(``csrc/bayes_opt.cc``, ``csrc/parameter_manager.cc``), compiled with
``g++`` as ``tests/single/test_bayes_opt.py`` compiles it (and skipped,
as there, without a compiler).

- ``BayesOpt``: on scripted sample streams over the 8 x 5 grid of
  ``test_bayes_opt.py`` and over the autotuner's 7 x 5 grid (closed
  loops on smooth surfaces, and open streams of seeded random samples
  with repeats), ``Suggest`` gives the same index at every step, ``Best``
  the same index and ``MeanScore`` the same value (1e-9 relative); the
  reference's property holds: 16 samples of 40 land within 2 % of the
  peak.
- ``ParameterManager``: the 35-point grid at the C++'s coordinates, the
  start snapped onto the grid as the C++ snaps it, the moves of
  ``Score`` and the CSV log byte for byte against the C++ class driven
  by the same score stream (a driver that includes the C++ sources with
  ``private`` read as ``public``, so that it can call ``Score``), the
  header equal to the reference's; then the window rules on a scripted
  clock: warm-up, floors, the 5 s cap, the stall gap, convergence;
- the codec and split dimensions, live: ``basics._init_autotune``'s grid
  (``InitAutotune``'s split values: flat, not under ``hier``, and the
  divisors of ``local_size`` that divide ``size``; ``{off, codec}`` when a
  codec is chosen) at ``local_size`` 2 and 4, modes ``auto`` and
  ``hier``, the codec off, bf16 and int8, against the C++ class
  initialised with the same ``hier_values`` and ``tune_wire_codec``:
  the grid, its order, the start, every move and the CSV log.
"""

import math
import subprocess

import numpy as np
import pytest

from horovod_tpu_torch.common import parameter_manager as pmod
from horovod_tpu_torch.common.bayes_opt import BayesOpt
from horovod_tpu_torch.common.parameter_manager import ParameterManager
from tests.utils_mp import REPO_ROOT

DRIVER = r"""
#include <algorithm>
#include <array>
#include <chrono>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <iostream>
#include <limits>
#include <memory>
#include <string>
#include <vector>
// The driver calls ParameterManager::Score, which is private.
#define private public
#include "bayes_opt.cc"
#include "parameter_manager.cc"
#undef private

using namespace hvdtpu;

int main(int argc, char** argv) {
  std::string mode = argv[1];
  if (mode == "bayes") {
    size_t n, d;
    std::cin >> n >> d;
    std::vector<std::vector<double>> cands(n, std::vector<double>(d));
    for (auto& c : cands)
      for (auto& x : c) std::cin >> x;
    BayesOpt opt(cands);
    size_t m;
    std::cin >> m;
    for (size_t i = 0; i < m; i++) {
      size_t idx;
      double y;
      std::cin >> idx >> y;
      opt.AddSample(idx, y);
      printf("%zu\n", opt.Suggest());
    }
    printf("%zu\n", opt.Best());
    for (size_t c = 0; c < n; c++) printf("%.17g\n", opt.MeanScore(c));
    return 0;
  }
  // mode "pm": fusion cycle max_samples log; codec tune_codec, the
  // split grid (its length, then its values) and the split; then m
  // scores.
  long long fusion, split;
  double cycle;
  int max_samples, codec, tune;
  size_t nh;
  std::string log;
  std::cin >> fusion >> cycle >> max_samples >> log >> codec >> tune >> nh;
  std::vector<int64_t> hier(nh);
  for (auto& h : hier) std::cin >> h;
  std::cin >> split;
  ParameterManager pm;
  // The port's grid: ring chunk and stripes pinned.
  pm.Initialize(fusion, cycle, log, max_samples, 1 << 20, 20,
                /*ring_chunk_bytes=*/0, codec, tune != 0, hier, split, 1, 1);
  printf("%zu %lld %.17g %zu\n", pm.current_candidate_,
         (long long)pm.fusion_threshold_bytes(), pm.cycle_time_ms(),
         pm.opt_->cand_.size());
  for (const auto& c : pm.opt_->cand_) {
    for (double x : c) printf("%.17g ", x);
    printf("\n");
  }
  size_t m;
  std::cin >> m;
  for (size_t i = 0; i < m; i++) {
    double y;
    std::cin >> y;
    pm.Score(y);
    printf("%zu %lld %.17g %d %d %lld\n", pm.current_candidate_,
           (long long)pm.fusion_threshold_bytes(), pm.cycle_time_ms(),
           (int)pm.done_, pm.wire_codec(), (long long)pm.hier_split());
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """Run the compiled driver: ``native(mode, text)`` -> stdout lines."""
    tmp = tmp_path_factory.mktemp("autotune_native")
    src = tmp / "driver.cc"
    src.write_text(DRIVER)
    binary = tmp / "driver"
    build = subprocess.run(
        ["g++", "-O2", "-std=c++17", f"-I{REPO_ROOT}/csrc", str(src), "-o",
         str(binary)], capture_output=True, text=True)
    if build.returncode != 0:
        pytest.skip(f"native toolchain unavailable: {build.stderr[:200]}")

    def run(mode, text):
        out = subprocess.run([str(binary), mode], input=text,
                             capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        return out.stdout.split("\n")[:-1]
    return run


def _grid_8x5():
    return [(f / 7.0, c / 4.0) for f in range(8) for c in range(5)]


def _grid_7x5():
    return ParameterManager(64 << 20, 1.0).candidates


def _surface(point, peak, noise_seed=None):
    """A smooth unimodal score over the first two coordinates (the
    reference's test surface), times seeded noise when asked."""
    dx, dy = point[0] - peak[0], point[1] - peak[1]
    y = 100.0 * math.exp(-6.0 * (dx * dx + dy * dy))
    if noise_seed is not None:
        rng = np.random.default_rng([noise_seed, int(point[0] * 1e6),
                                     int(point[1] * 1e6)])
        y *= 1.0 + 0.05 * rng.standard_normal()
    return y


def _closed_loop(cands, steps, peak, noise_seed=None, start=0):
    """The port's optimizer sampling ``steps`` points from ``start``:
    the (index, score) stream and its suggestions."""
    opt = BayesOpt(cands)
    cur, stream, suggested = start, [], []
    for _ in range(steps):
        y = _surface(cands[cur], peak, noise_seed)
        opt.add_sample(cur, y)
        stream.append((cur, y))
        cur = opt.suggest()
        suggested.append(cur)
    return opt, stream, suggested


def _open_stream(n_cand, m, seed):
    """Seeded random samples, repeats of an index included."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_cand, m)
    idx[m // 2:m // 2 + 3] = idx[0]
    return [(int(i), float(y)) for i, y in
            zip(idx, rng.uniform(1e6, 5e9, m))]


def _native_bayes(native, cands, stream):
    text = f"{len(cands)} {len(cands[0])}\n" + "".join(
        " ".join(repr(float(x)) for x in c) + "\n" for c in cands)
    text += f"{len(stream)}\n" + "".join(f"{i} {y!r}\n" for i, y in stream)
    out = native("bayes", text)
    m = len(stream)
    return ([int(x) for x in out[:m]], int(out[m]),
            [float(x) for x in out[m + 1:]])


def _port_bayes(cands, stream):
    opt = BayesOpt(cands)
    suggested = []
    for i, y in stream:
        opt.add_sample(i, y)
        suggested.append(opt.suggest())
    return opt, suggested


CASES = [
    # (grid, closed-loop peak or None for an open stream, steps, seed)
    ("8x5", (5 / 7, 0.25), 16, None),
    ("8x5", (0.3, 0.9), 24, 3),
    ("7x5", (4 / 6, 0.5), 20, None),
    ("7x5", (0.2, 0.1), 25, 7),
    ("8x5", None, 30, 11),
    ("7x5", None, 30, 12),
]


@pytest.mark.parametrize("grid,peak,steps,seed", CASES)
def test_bayes_opt_matches_the_native_optimizer(native, grid, peak, steps,
                                                seed):
    cands = _grid_8x5() if grid == "8x5" else _grid_7x5()
    if peak is not None:
        _, stream, _ = _closed_loop(cands, steps, peak, noise_seed=seed)
    else:
        stream = _open_stream(len(cands), steps, seed)
    opt, suggested = _port_bayes(cands, stream)
    want, best, means = _native_bayes(native, cands, stream)
    assert suggested == want
    assert opt.best() == best
    for c, m in enumerate(means):
        assert opt.mean_score(c) == pytest.approx(m, rel=1e-9, abs=0.0)


def test_unseen_candidates_win_exact_ties(native):
    # Every candidate at one point: every EI ties exactly, and the first
    # unseen candidate wins, as the C++ rules (not the lowest index).
    cands = [(0.4, 0.6)] * 4
    for stream, want in (([(0, 1.0)], [1]), ([(0, 1.0), (1, 3.0)], [1, 2]),
                         ([(1, 2.0), (0, 1.0), (3, 5.0)], [0, 2, 2])):
        _, suggested = _port_bayes(cands, stream)
        assert suggested == _native_bayes(native, cands, stream)[0] == want


def test_bayes_opt_finds_the_peak_sample_efficiently():
    # tests/single/test_bayes_opt.py's property, on the port: 16 samples
    # of the 40-point grid, from the worst corner, within 2 % of the peak.
    cands = _grid_8x5()
    opt, _, _ = _closed_loop(cands, 16, (5 / 7, 0.25))
    assert _surface(cands[opt.best()], (5 / 7, 0.25)) >= 98.0
    assert opt.num_samples == 16


def test_bayes_opt_before_any_sample():
    opt = BayesOpt(_grid_7x5())
    assert opt.suggest() == 0 and opt.best() == 0
    assert opt.mean_score(3) == 0.0


# ---- the parameter manager ---------------------------------------------


def _pm_native(native, fusion, cycle, scores, log, max_samples=20,
               codec=0, tune=False, hier=(), split=0, full=False):
    """The C++ manager's start, grid and moves (candidate, fusion, cycle,
    done; with ``full`` also the codec and the split)."""
    out = native("pm", f"{fusion} {cycle!r} {max_samples} {log}\n"
                 f"{codec} {int(tune)} {len(hier)} "
                 + "".join(f"{h} " for h in hier) + f"{split}\n"
                 f"{len(scores)}\n" + "".join(f"{y!r}\n" for y in scores))
    cand, f, c, n = out[0].split()
    grid = [tuple(float(x) for x in line.split()) for line in
            out[1:1 + int(n)]]
    moves = [tuple(line.split()) for line in out[1 + int(n):]]
    moves = [(int(a), int(b), float(x), bool(int(d)), int(m), int(h))
             for a, b, x, d, m, h in moves]
    return (int(cand), int(f), float(c)), grid, [
        mv if full else mv[:4] for mv in moves]


@pytest.mark.parametrize("fusion,cycle", [
    (64 << 20, 1.0), (3 << 20, 0.7), (0, 100.0), (1 << 20, 0.5),
    (100 << 20, 2.5), (5 << 20, 4.99)])
def test_start_snaps_onto_the_grid_as_the_native(native, tmp_path, fusion,
                                                 cycle):
    start, grid, _ = _pm_native(native, fusion, cycle, [],
                                tmp_path / "native.csv")
    pm = ParameterManager(fusion, cycle)
    assert (pm.candidate, pm.fusion_threshold_bytes, pm.cycle_time_ms) == \
        start
    assert pm.candidates == grid and len(grid) == 35
    assert pm.fusion_threshold_bytes in pmod.FUSION_VALUES
    # MoveTo's arithmetic: fusion index major, cycle minor.
    for c in range(35):
        pm.move_to(c)
        assert (pm.fusion_threshold_bytes, pm.cycle_time_ms) == (
            pmod.FUSION_VALUES[c // 5], pmod.CYCLE_VALUES[c % 5])


@pytest.mark.parametrize("max_samples,seed", [(20, 5), (6, 9)])
def test_score_moves_and_log_match_the_native(native, tmp_path, max_samples,
                                              seed):
    pm = ParameterManager(64 << 20, 1.0, tmp_path / "port.csv",
                          max_samples=max_samples)
    scores = []
    for _ in range(max_samples + 2):
        y = _surface(pm.candidates[pm.candidate], (0.5, 0.25), seed) * 1e7
        scores.append(y)
        pm.score(y)
    pm.close()
    port = ParameterManager(64 << 20, 1.0, max_samples=max_samples)
    moves = []
    for y in scores:
        port.score(y)
        moves.append((port.candidate, port.fusion_threshold_bytes,
                      port.cycle_time_ms, port.done))
    _, _, want = _pm_native(native, 64 << 20, 1.0, scores,
                            tmp_path / "native.csv", max_samples)
    assert moves == want
    assert moves[max_samples - 1][3] and not moves[max_samples - 2][3]
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "native.csv").read_bytes()


def test_log_header_is_the_references(native, tmp_path):
    _pm_native(native, 64 << 20, 1.0, [], tmp_path / "native.csv")
    ParameterManager(64 << 20, 1.0, tmp_path / "port.csv").close()
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "native.csv").read_bytes() == pmod.HEADER.encode()


def _reference_hier_values(local_size, size, mode):
    """``InitAutotune``'s split grid (``csrc/operations.cc:411-420``) on an
    eligible layout (split = local_size)."""
    values = [] if mode == "hier" else [0]
    return values + [d for d in range(2, local_size + 1)
                     if local_size % d == 0 and size % d == 0]


@pytest.mark.parametrize("local_size", [2, 4])
@pytest.mark.parametrize("mode", ["auto", "hier"])
@pytest.mark.parametrize("codec", [0, 1, 2])
def test_codec_and_split_dimensions_match_the_native(
        native, tmp_path, monkeypatch, local_size, mode, codec):
    from horovod_tpu_torch.common import basics

    size = 2 * local_size
    hier = _reference_hier_values(local_size, size, mode)
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS", "12")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(tmp_path / "port.csv"))
    pm = basics._init_autotune(0, 64 << 20, 1.0, codec, mode, local_size,
                               local_size, size)
    assert pm.hier_values == tuple(hier)
    assert pm.comp_values == ((0, codec) if codec else (0,))
    scores = []
    for _ in range(14):
        y = _surface(pm.candidates[pm.candidate], (0.5, 0.25), codec) * 1e7
        y *= 1.0 + 0.1 * pm.candidates[pm.candidate][4] \
            - 0.05 * pm.candidates[pm.candidate][3]
        scores.append(y)
        pm.score(y)
    pm.close()
    start, grid, want = _pm_native(
        native, 64 << 20, 1.0, scores, tmp_path / "native.csv", 12,
        codec=codec, tune=codec != 0, hier=hier, split=local_size,
        full=True)
    port = ParameterManager(64 << 20, 1.0, max_samples=12, wire_codec=codec,
                            tune_wire_codec=codec != 0, hier_values=hier,
                            hier_split=local_size)
    assert port.candidates == grid
    assert len(grid) == 35 * len(port.comp_values) * len(hier)
    assert (port.candidate, port.fusion_threshold_bytes,
            port.cycle_time_ms) == start
    assert (port.wire_codec, port.hier_split) == (codec, local_size)
    moves = []
    for y in scores:
        port.score(y)
        moves.append((port.candidate, port.fusion_threshold_bytes,
                      port.cycle_time_ms, port.done, port.wire_codec,
                      port.hier_split))
    assert moves == want
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "native.csv").read_bytes()
    # Every candidate's knobs: MoveTo's arithmetic.
    for c in range(len(grid)):
        port.move_to(c)
        rest, hi = divmod(c, len(hier))
        rest, mi = divmod(rest, len(port.comp_values))
        assert (port.hier_split, port.wire_codec) == (
            hier[hi], port.comp_values[mi])
        assert (port.fusion_threshold_bytes, port.cycle_time_ms) == (
            pmod.FUSION_VALUES[rest // 5], pmod.CYCLE_VALUES[rest % 5])


def test_a_flat_layout_pins_the_split(monkeypatch):
    from horovod_tpu_torch.common import basics

    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    pm = basics._init_autotune(0, 64 << 20, 1.0, 0, "auto", 0, 4, 4)
    assert pm.hier_values == (0,) and len(pm.candidates) == 35
    assert basics._init_autotune(1, 64 << 20, 1.0, 0, "auto", 2, 2, 4) \
        is None


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _manager(tmp_path, clock, **kw):
    kw = {"window_bytes": 1000, "window_cycles": 3, **kw}
    return ParameterManager(64 << 20, 1.0, tmp_path / "at.csv", clock=clock,
                            **kw)


def _rows(tmp_path):
    lines = (tmp_path / "at.csv").read_text().splitlines()
    assert lines[0] + "\n" == pmod.HEADER
    return [line.split(",") for line in lines[1:]]


def _window(pm, clock, cycles, nbytes, dt):
    """``cycles`` updates of ``nbytes`` each, ``dt`` s apart; the last
    update's return value."""
    moved = False
    for _ in range(cycles):
        clock.t += dt
        moved = pm.update(nbytes)
    return moved


def test_warmup_windows_are_thrown_away(tmp_path):
    clock = _Clock()
    pm = _manager(tmp_path, clock)
    for _ in range(3):
        assert not _window(pm, clock, 3, 400, 0.01)
        assert pm.candidate == 31      # 64 MiB, 1 ms
    assert _rows(tmp_path) == []
    # The fourth window is scored: 1200 bytes over its 0.03 s.
    _window(pm, clock, 3, 400, 0.01)
    (row,) = _rows(tmp_path)      # the log rounds a score to a whole
    assert row[:6] == ["67108864", "1.000", "0", "0", "0", "1"]
    assert float(row[6]) == pytest.approx(1200 / 0.03, abs=0.5)


def test_a_window_needs_both_floors(tmp_path):
    clock = _Clock()
    pm = _manager(tmp_path, clock, window_bytes=1000, window_cycles=3)
    pm._warmup = 0
    # Bytes met at the first cycle, cycles not: open until the third.
    clock.t += 0.01
    assert not pm.update(5000)
    clock.t += 0.01
    assert not pm.update(0)
    assert _rows(tmp_path) == []
    clock.t += 0.01
    pm.update(0)
    assert len(_rows(tmp_path)) == 1
    # Cycles met, bytes not: still open.
    assert not _window(pm, clock, 5, 10, 0.01)
    assert len(_rows(tmp_path)) == 1


def test_the_five_second_cap(tmp_path):
    clock = _Clock()
    pm = _manager(tmp_path, clock, window_bytes=1 << 30, window_cycles=3)
    pm._warmup = 0
    # Cycles clear their floor, bytes never do: the cap closes it, and
    # it is scored over the whole window.
    _window(pm, clock, 5, 100, 1.25)
    (row,) = _rows(tmp_path)
    assert float(row[6]) == pytest.approx(500 / 5.0, abs=0.5)
    # Below both floors when capped (two enqueues in 5 s): thrown away.
    clock.t += 2.5
    pm.update(100)
    clock.t += 2.5
    pm.update(100)
    assert len(_rows(tmp_path)) == 1


def test_windows_run_on_wall_time_and_a_stall_starts_fresh(tmp_path):
    clock = _Clock()
    pm = _manager(tmp_path, clock)
    pm._warmup = 0
    _window(pm, clock, 3, 400, 0.01)
    # A 1 s compute phase before the next burst counts against the knobs.
    clock.t += 1.0
    _window(pm, clock, 3, 400, 0.01)
    rows = _rows(tmp_path)
    assert float(rows[1][6]) == pytest.approx(1200 / 1.03, abs=0.5)
    # A gap of 5 s or more is a stall the knobs did not cause: the
    # window starts at its first update.
    clock.t += 7.0
    _window(pm, clock, 3, 400, 0.01)
    assert float(_rows(tmp_path)[2][6]) == pytest.approx(1200 / 0.02,
                                                         abs=0.5)


def test_converges_to_the_best_mean_and_logs_it_last(tmp_path):
    clock = _Clock()
    pm = _manager(tmp_path, clock, max_samples=5)
    pm._warmup = 0
    seen = []
    while not pm.done:
        seen.append(pm.candidate)
        # The score rises with the fusion index alone (exact binary
        # times, so equal fusion means equal score).
        _window(pm, clock, 3, 1000 * (1 + pm.fusion_idx), 1 / 64)
    rows = _rows(tmp_path)
    assert len(rows) == 6          # five scored windows, then the choice
    top = max(c // 5 for c in seen)
    best = min(c for c in seen if c // 5 == top)   # ties: lowest index
    assert pm.candidate == best
    assert rows[-1][:2] == [str(pmod.FUSION_VALUES[best // 5]),
                            f"{pmod.CYCLE_VALUES[best % 5]:.3f}"]
    assert not _window(pm, clock, 10, 10 ** 6, 0.01)
    assert len(_rows(tmp_path)) == 6
