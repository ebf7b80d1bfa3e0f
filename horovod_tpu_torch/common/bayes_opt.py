"""Gaussian-process Bayesian optimization over a small discrete grid.

The port's copy of ``csrc/bayes_opt.{h,cc}``, the autotuner's sample
proposer: a GP with an RBF kernel (length scale 0.3, noise 1e-3) over
normalised candidate points, the observed scores re-normalised to zero
mean and unit variance before each fit, an exact Cholesky solve, and
Expected Improvement argmaxed over the grid with unseen candidates
winning exact ties. Deterministic, in float64: every sum runs in the
C++'s order with the same libm functions, so the port suggests the same
index as the C++ at every step of a sample stream.
"""

import math

_XI = 0.01                         # EI's exploration margin (kXi)
_SQRT2 = math.sqrt(2.0)
_SQRT2PI = math.sqrt(2.0 * math.pi)


def _cdf(z):
    return 0.5 * math.erfc(-z / _SQRT2)


def _pdf(z):
    return math.exp(-0.5 * z * z) / _SQRT2PI


def _cholesky(m, n):
    """In place on the row-major ``n`` x ``n`` list ``m``; False if it
    is not positive definite."""
    for i in range(n):
        for j in range(i + 1):
            s = m[i * n + j]
            for k in range(j):
                s -= m[i * n + k] * m[j * n + k]
            if i == j:
                if s <= 0:
                    return False
                m[i * n + i] = math.sqrt(s)
            else:
                m[i * n + j] = s / m[j * n + j]
    return True


def _solve_lower(lo, n, b):
    """``L x = b`` in place into ``b``."""
    for i in range(n):
        s = b[i]
        for k in range(i):
            s -= lo[i * n + k] * b[k]
        b[i] = s / lo[i * n + i]


def _solve_upper_t(lo, n, b):
    """``L^T x = b`` in place into ``b``."""
    for i in range(n - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, n):
            s -= lo[k * n + i] * b[k]
        b[i] = s / lo[i * n + i]


class BayesOpt:
    """``candidates``: points of one length in the normalised knob space
    (about [0, 1] per dimension)."""

    def __init__(self, candidates, length_scale=0.3, noise=1e-3):
        self._cand = [tuple(float(x) for x in c) for c in candidates]
        self._ls2 = 2.0 * length_scale * length_scale
        self._noise = noise
        self._xs = []       # sampled candidate indices
        self._ys = []       # raw scores

    def _kernel(self, a, b):
        sq = 0.0
        for x, y in zip(a, b):
            d = x - y
            sq += d * d
        return math.exp(-sq / self._ls2)

    def add_sample(self, idx, y):
        """Record a score ``y`` (any scale) at ``candidates[idx]``."""
        self._xs.append(int(idx))
        self._ys.append(float(y))

    @property
    def num_samples(self):
        return len(self._xs)

    def suggest(self):
        """The next candidate to score: the argmax of Expected
        Improvement under the posterior; 0 before any sample."""
        n = len(self._xs)
        if n == 0:
            return 0
        mean = 0.0
        for y in self._ys:
            mean += y
        mean /= n
        var = 0.0
        for y in self._ys:
            var += (y - mean) * (y - mean)
        sd = math.sqrt(var / n) if n > 1 else 1.0
        if sd <= 0:
            sd = 1.0
        yn = [(y - mean) / sd for y in self._ys]
        best_y = max(yn)
        cand, xs = self._cand, self._xs
        K = [self._kernel(cand[xs[i]], cand[xs[j]]) +
             (self._noise if i == j else 0.0)
             for i in range(n) for j in range(n)]
        alpha = list(yn)
        if not _cholesky(K, n):
            # Degenerate (identical repeated samples): the best observed.
            return self.best()
        _solve_lower(K, n, alpha)
        _solve_upper_t(K, n, alpha)
        best_ei, best_idx = -1.0, self.best()
        seen = set(xs)
        for c, point in enumerate(cand):
            kstar = [self._kernel(point, cand[x]) for x in xs]
            mu = 0.0
            for k, a in zip(kstar, alpha):
                mu += k * a
            v = list(kstar)
            _solve_lower(K, n, v)
            var_c = self._kernel(point, point)
            for x in v:
                var_c -= x * x
            sigma = math.sqrt(var_c) if var_c > 1e-12 else 0.0
            gain = mu - best_y - _XI
            if sigma == 0.0:
                ei = gain if gain > 0 else 0.0
            else:
                z = gain / sigma
                ei = gain * _cdf(z) + sigma * _pdf(z)
            if ei > best_ei or (ei == best_ei and c not in seen and
                                best_idx in seen):
                best_ei, best_idx = ei, c
        return best_idx

    def best(self):
        """The candidate of the highest mean observed score (repeats
        average); 0 before any sample."""
        best, best_idx = -math.inf, 0
        for c in range(len(self._cand)):
            score = self.mean_score(c, default=None)
            if score is not None and score > best:
                best, best_idx = score, c
        return best_idx

    def mean_score(self, idx, default=0.0):
        """The mean observed score at ``candidates[idx]`` (``default``
        if never sampled)."""
        total, cnt = 0.0, 0
        for x, y in zip(self._xs, self._ys):
            if x == idx:
                total += y
                cnt += 1
        return total / cnt if cnt else default
