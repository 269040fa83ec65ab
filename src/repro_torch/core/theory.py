"""Theorem 1 convergence-bound calculator + empirical alpha estimation
(copied from ``repro/core/theory.py``: numpy only).

rate(T) ~ sigma/sqrt(T) + 1/T + tau*alpha/T        (paper eq. 6)

alpha = max over ids of P[sample contains id]: the ID-frequency upper bound
that damps the staleness penalty. For power-law ID distributions (the
realistic recsys regime) alpha << 1 and the hybrid algorithm's rate matches
synchronous SGD — this module makes those terms concrete so the staleness
benchmark can check the *measured* hybrid/sync gap scales like tau*alpha.
"""
from __future__ import annotations

import numpy as np


def hybrid_rate_bound(T: int, sigma: float, tau: int, alpha: float,
                      L: float = 1.0) -> dict:
    sgd_term = sigma * np.sqrt(L) / np.sqrt(T)
    det_term = L / T
    stale_term = tau * min(1.0, alpha) * L / T
    return {
        "sgd_term": sgd_term,
        "deterministic_term": det_term,
        "staleness_term": stale_term,
        "total": sgd_term + det_term + stale_term,
        "stale_fraction": stale_term / max(sgd_term + det_term + stale_term,
                                           1e-30),
    }


def optimal_lr(T: int, sigma: float, tau: int, alpha: float,
               L: float = 1.0) -> float:
    """gamma = 1 / (L + sqrt(T L) sigma + 4 tau L alpha)  (Theorem 1)."""
    return 1.0 / (L + np.sqrt(T * L) * sigma + 4 * tau * L * min(1.0, alpha))


def estimate_alpha(ids_batches: list[np.ndarray], n_rows: int) -> float:
    """Empirical alpha: max over ids of (samples containing id / samples)."""
    counts = np.zeros(n_rows, dtype=np.int64)
    n_samples = 0
    for b in ids_batches:
        B = b.shape[0]
        n_samples += B
        for s in range(B):
            u = np.unique(b[s][b[s] >= 0])
            counts[u] += 1
    return float(counts.max()) / max(n_samples, 1)
