"""Micro-batch execution-time predictor (paper Eq. 1).

    T_MB ~= alpha * N + beta * sum_i(l_i^2)

alpha captures the linear (MLP/projection) cost per token, beta the quadratic
self-attention cost under sequence packing with block-diagonal masks. Both are
profiled during a warm-up phase and fit by least squares. The predictor is
per-(stage-shape): a pipeline stage with k layers has its own (alpha, beta)
— equivalently we fit per layer and scale, which is what `per_layer=True`
does so the ResiHP Scheduler can re-use the fit after layer repartition.

A copy of `repro.core.detector.predictor` (the predictor and its
ground-truth generator `synthetic_chunk_time`), kept here so that the port
fits Eq. 1 on times measured on the card without importing the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MicroBatchTimePredictor:
    # chunk-kind multipliers relative to forward (paper §5.2: F/B/W chunks)
    backward_ratio: float = 2.0
    weight_ratio: float = 1.0  # W chunk (ZB schedules); B+W ~= full backward
    alpha: float = 0.0
    beta: float = 0.0
    gamma: float = 0.0  # constant per-micro-batch overhead (launch, norm, etc.)
    fitted: bool = False
    _obs: list = field(default_factory=list)

    def observe(self, n_tokens: int, sum_l2: int, seconds: float, n_layers: int = 1):
        """One warm-up measurement of a forward chunk over `n_layers` layers."""
        self._obs.append((n_tokens / n_layers, sum_l2 / n_layers, seconds / n_layers))

    def fit(self):
        if len(self._obs) < 3:
            raise ValueError(f"need >=3 warm-up observations, have {len(self._obs)}")
        arr = np.asarray(self._obs, dtype=np.float64)
        X = np.stack([arr[:, 0], arr[:, 1], np.ones(len(arr))], axis=1)
        y = arr[:, 2]
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        self.alpha, self.beta, self.gamma = map(float, coef)
        # cost terms are physically non-negative; clamp tiny negatives from noise
        self.alpha = max(self.alpha, 0.0)
        self.beta = max(self.beta, 0.0)
        self.gamma = max(self.gamma, 0.0)
        self.fitted = True
        return self

    def predict(self, n_tokens: int, sum_l2: int, *, n_layers: int = 1,
                kind: str = "F", speed: float = 1.0) -> float:
        """Expected healthy chunk time for a (packed) micro-batch."""
        assert self.fitted, "call fit() after warm-up"
        t = (self.alpha * n_tokens + self.beta * sum_l2 + self.gamma) * n_layers
        mult = {"F": 1.0, "B": self.backward_ratio, "W": self.weight_ratio}[kind]
        return t * mult / max(speed, 1e-9)

    def mape(self, samples) -> float:
        """Mean absolute percentage error on (n, sum_l2, n_layers, actual)."""
        errs = []
        for n, l2, nl, actual in samples:
            pred = self.predict(n, l2, n_layers=nl)
            errs.append(abs(pred - actual) / max(abs(actual), 1e-12))
        return float(np.mean(errs))


def synthetic_chunk_time(alpha, beta, gamma, n_tokens, sum_l2, n_layers=1,
                         kind="F", speed=1.0, b_ratio=2.0, w_ratio=1.0,
                         noise=0.0, rng=None):
    """Ground-truth generator used by the cluster simulator: same functional
    form the predictor assumes, plus optional multiplicative jitter."""
    t = (alpha * n_tokens + beta * sum_l2 + gamma) * n_layers
    t *= {"F": 1.0, "B": b_ratio, "W": w_ratio}[kind]
    t /= max(speed, 1e-9)
    if noise and rng is not None:
        t *= float(rng.normal(1.0, noise))
    return t
