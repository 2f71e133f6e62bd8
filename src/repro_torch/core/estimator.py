"""Lightning memory estimator (paper §4.3): a numpy copy of the
reference's ``core/estimator.py``.

Per plan-unit polynomial regression of activation bytes against input
size.  Activation memory is at most quadratic in the input size
(attention's (S, S) score tensor), so degree 2 is the default.
``state_dict`` / ``load_state`` carry the raw samples into a snapshot.
The small CART tree and the polynomials of degree 1 and 3
(``ESTIMATORS``) are the paper's Tables 3-4 comparison; ``mape`` scores
any of them on held-out sizes.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np


class PolyEstimator:
    """Fit bytes(s) = sum_k c_k s^k independently per plan unit."""

    def __init__(self, degree: int = 2, min_samples: Optional[int] = None):
        self.degree = degree
        self.min_samples = min_samples or (degree + 1)
        self._sizes: List[float] = []
        self._acts: List[np.ndarray] = []     # (n_units,) per sample
        self._coeffs: Optional[np.ndarray] = None   # (n_units, degree+1)
        self.fit_time_s = 0.0

    def add_sample(self, input_size: int, activation_bytes: Sequence[float]):
        self._sizes.append(float(input_size))
        self._acts.append(np.asarray(activation_bytes, dtype=np.float64))
        self._coeffs = None

    @property
    def num_samples(self) -> int:
        return len(self._sizes)

    @property
    def ready(self) -> bool:
        return len(set(self._sizes)) >= self.min_samples

    def fit(self):
        if not self._sizes:
            raise RuntimeError(
                "PolyEstimator has no samples: call add_sample(input_size, "
                "activation_bytes) first (or check estimator.ready).")
        t0 = time.perf_counter()
        s = np.asarray(self._sizes)
        Y = np.stack(self._acts)                       # (n_samples, n_units)
        # Vandermonde in normalised size keeps the system well conditioned
        scale = s.max() if s.max() > 0 else 1.0
        V = np.vander(s / scale, self.degree + 1)       # (n_samples, d+1)
        coef, *_ = np.linalg.lstsq(V, Y, rcond=None)    # (d+1, n_units)
        self._scale = scale
        self._coeffs = coef.T                           # (n_units, d+1)
        self.fit_time_s = time.perf_counter() - t0
        return self

    def predict(self, input_size: float) -> np.ndarray:
        if self._coeffs is None:
            self.fit()
        v = np.vander(np.array([input_size / self._scale]), self.degree + 1)[0]
        return np.maximum(self._coeffs @ v, 0.0)

    def predict_total(self, input_size: float) -> float:
        return float(np.sum(self.predict(input_size)))

    # -- persistence (snapshots, ``train/resilience.py``) ------------------
    def state_dict(self) -> dict:
        """The raw samples, which fully determine the coefficients (a
        restore refits, ~1 ms, rather than trusting stored
        coefficients)."""
        return {"degree": int(self.degree),
                "min_samples": int(self.min_samples),
                "sizes": [float(s) for s in self._sizes],
                "acts": [np.asarray(a, dtype=np.float64).tolist()
                         for a in self._acts]}

    def load_state(self, state: dict) -> "PolyEstimator":
        """Adopt the sample log of a ``state_dict``; ``degree`` and
        ``min_samples`` stay as constructed (the planner owns them).
        Refits at once when ready."""
        sizes = list(state.get("sizes", []))
        acts = state.get("acts", [])
        if len(sizes) != len(acts):
            raise ValueError(
                f"estimator state corrupt: {len(sizes)} sizes vs "
                f"{len(acts)} activation vectors")
        self._sizes = [float(s) for s in sizes]
        self._acts = [np.asarray(a, dtype=np.float64) for a in acts]
        self._coeffs = None
        if self.ready:
            self.fit()
        return self

    def mape(self, sizes: Sequence[float], truth: np.ndarray) -> float:
        """truth: (n_samples, n_units) actual bytes."""
        return _mape(self, sizes, truth)


def _mape(est, sizes, truth) -> float:
    """Mean absolute percentage error of the predicted total bytes."""
    preds = np.stack([est.predict(s) for s in sizes])
    tot_p, tot_t = preds.sum(1), truth.sum(1)
    return float(np.mean(np.abs(tot_p - tot_t) / np.maximum(tot_t, 1.0)))


class DecisionTreeEstimator:
    """Tiny CART regressor on the per-unit bytes (Table 3 baseline):
    splits at the midpoint between distinct sorted sizes, predicts a
    leaf's mean, constant past the last leaf."""

    def __init__(self, max_depth: int = 4, min_leaf: int = 1):
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self._sizes: List[float] = []
        self._acts: List[np.ndarray] = []
        self._tree = None

    def add_sample(self, input_size, activation_bytes):
        self._sizes.append(float(input_size))
        self._acts.append(np.asarray(activation_bytes, dtype=np.float64))
        self._tree = None

    @property
    def ready(self) -> bool:
        return len(self._sizes) >= 2

    def _build(self, xs, ys, depth):
        if depth >= self.max_depth or len(xs) <= self.min_leaf:
            return ("leaf", ys.mean(axis=0))
        order = np.argsort(xs)
        xs, ys = xs[order], ys[order]
        best = None
        for i in range(1, len(xs)):
            if xs[i] == xs[i - 1]:
                continue
            sse = (((ys[:i] - ys[:i].mean(0)) ** 2).sum()
                   + ((ys[i:] - ys[i:].mean(0)) ** 2).sum())
            if best is None or sse < best[0]:
                best = (sse, (xs[i - 1] + xs[i]) / 2, i)
        if best is None:
            return ("leaf", ys.mean(axis=0))
        _, thr, i = best
        return ("node", thr, self._build(xs[:i], ys[:i], depth + 1),
                self._build(xs[i:], ys[i:], depth + 1))

    def fit(self):
        if not self._sizes:
            raise RuntimeError(
                "DecisionTreeEstimator has no samples: call add_sample() "
                "before predict/fit.")
        t0 = time.perf_counter()
        self._tree = self._build(np.asarray(self._sizes),
                                 np.stack(self._acts), 0)
        self.fit_time_s = time.perf_counter() - t0
        return self

    def predict(self, input_size: float) -> np.ndarray:
        if self._tree is None:
            self.fit()
        node = self._tree
        while node[0] == "node":
            node = node[2] if input_size <= node[1] else node[3]
        return node[1]

    def predict_total(self, input_size: float) -> float:
        return float(np.sum(self.predict(input_size)))

    def mape(self, sizes, truth) -> float:
        return _mape(self, sizes, truth)


ESTIMATORS = {
    "poly1": lambda: PolyEstimator(1),
    "poly2": lambda: PolyEstimator(2),
    "poly3": lambda: PolyEstimator(3),
    "tree": lambda: DecisionTreeEstimator(),
}
