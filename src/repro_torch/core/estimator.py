"""Lightning memory estimator (paper §4.3): a numpy copy of the
reference's ``PolyEstimator``.

Per plan-unit polynomial regression of activation bytes against input
size.  Activation memory is at most quadratic in the input size
(attention's (S, S) score tensor), so degree 2 is the default.
``state_dict`` / ``load_state`` carry the raw samples into a snapshot.
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
